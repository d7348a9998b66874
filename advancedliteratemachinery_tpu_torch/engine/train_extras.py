"""Engine extensions (port of
`advancedliteratemachinery_tpu/engine/train_extras.py`): gradient
accumulation and the two schedule shapes of the reference.

- BatchNorm models (LORE's DLA, DB) train with the same `TrainState` as
  the others. The JAX package's `MutableTrainState` carries a
  `batch_stats` collection beside the params and threads it through the
  loss; here the running statistics are the BatchNorm modules' buffers,
  which a forward in `train()` mode updates in place
  (`models/layers.py` `batch_norm`), and `engine/fit.py` saves and
  restores them with the model's `state_dict()`.
- `with_accumulation` is optax `MultiSteps` (reference: accelerate
  `accumulate`, train_lvtr.py:297).
- `warmup_linear` and `warmup_cosine` are the reference's schedules
  (OmniParser's warm-up + linear decay, LISTER's and TRCG's cosine), as
  functions of the update count; `OptimizerConfig` takes the second
  (`engine/train.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from advancedliteratemachinery_tpu_torch.engine.train import (
    OptimizerConfig, warmup_cosine)

__all__ = ["with_accumulation", "warmup_linear", "warmup_cosine"]


def with_accumulation(tx: OptimizerConfig, every: int) -> OptimizerConfig:
    """`tx` taking one update per `every` steps, from the mean of their
    gradients (optax `MultiSteps(tx, every_k_schedule=every)`; see
    `TrainState.apply_gradients`). every=1 is `tx` itself."""
    if every <= 1:
        return tx
    return dataclasses.replace(tx, every=every)


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax `linear_schedule(init, end, steps)` at `count`."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def warmup_linear(lr: float, warmup_steps: int,
                  total_steps: int) -> Callable[[int], float]:
    """OmniParser's schedule (main.py's lr lambda): linear from 0 to lr
    over `warmup_steps`, then linear to 0 at `total_steps` (optax
    `join_schedules` of two `linear_schedule`s)."""
    decay = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return _linear(0.0, lr, warmup_steps, count)
        return _linear(lr, 0.0, decay, count - warmup_steps)

    return schedule
