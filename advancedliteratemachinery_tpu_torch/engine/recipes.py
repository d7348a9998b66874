"""Per-model training recipes (port of
`advancedliteratemachinery_tpu/engine/recipes.py`, MGP-STR so far).

A recipe maps a model to `(loss_fn, tx)`: the loss over a batch dict of
device tensors, `loss_fn(batch, generator) -> (loss, metrics)`, and the
reference's optimiser settings, for `engine.train.make_train_step` and
`engine.fit.fit`.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from advancedliteratemachinery_tpu_torch.engine.train import (
    OptimizerConfig, make_optimizer, mgp_str_loss_fn)


def mgp_str_recipe(model) -> Tuple[Callable, OptimizerConfig]:
    """batch: images (normalised), char_ids, bpe_ids, wp_ids
    (train_final_dist.py:150)."""
    return mgp_str_loss_fn(model), make_optimizer(
        lr=1e-4, total_steps=2_000_000, grad_clip=5.0)


RECIPES: Dict[str, Callable] = {
    "mgp_str": mgp_str_recipe,
}
