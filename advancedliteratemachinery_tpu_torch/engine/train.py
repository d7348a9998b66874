"""Single-device train engine (port of
`advancedliteratemachinery_tpu/engine/train.py`).

loss → backward → global-norm clip → Adam/AdamW on a cosine schedule,
reproducing the JAX package's optax chain
`chain(clip_by_global_norm(c), adam(w)(cosine or warmup-cosine schedule))`:

- the clip scales the gradients by `max_norm / norm` only when
  `norm >= max_norm`, as optax does (not `torch.nn.utils.clip_grad_norm_`,
  which scales by `max_norm / (norm + 1e-6)` whenever that is below 1);
- Adam with b1 0.9, b2 0.999, eps 1e-8, or decoupled AdamW when
  `weight_decay > 0` (optax's `adamw`: the decay is scaled by the learning
  rate, as torch's `AdamW`);
- the learning rate of update n is the schedule at n, the count of updates
  made before it, as optax evaluates it;
- with gradient accumulation (`engine/train_extras.py`
  `with_accumulation`, optax `MultiSteps`) a step only folds its
  gradients into a running mean, and every `every`-th step clips that
  mean and takes the update.

Models with BatchNorm (LORE's DLA, DB) need no state beside the model: the
running statistics are the BatchNorm modules' buffers, which a train-mode
forward updates (`models/layers.py` `batch_norm`) and `state_dict()`
carries into checkpoints, where the JAX package keeps a `batch_stats`
collection in its `MutableTrainState`.

One device only: the JAX package's mesh sharding (`parallel/`) has no
counterpart here yet. The state is mutable: a step updates the model's
parameters and the optimiser's moments in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

Metrics = Dict[str, torch.Tensor]
LossFn = Callable[[Dict[str, torch.Tensor], torch.Generator],
                  Tuple[torch.Tensor, Metrics]]

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def warmup_cosine(lr: float, warmup_steps: int,
                  total_steps: int) -> Callable[[int], float]:
    """optax `warmup_cosine_decay_schedule(0, lr, warmup_steps,
    total_steps)` as a function of the update count: linear from 0 to lr
    over the warm-up, then a cosine to 0 over the remaining steps, held at
    0 after them; with no warm-up, `cosine_decay_schedule(lr,
    total_steps)`."""
    decay_steps = total_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return lr * count / warmup_steps
        count = min(count - warmup_steps, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The optax chain `make_optimizer` builds in the JAX package: its
    settings, its schedule, and the torch optimiser over a model's
    parameters."""

    lr: float = 1e-4
    total_steps: int = 2_000_000
    grad_clip: float = 5.0
    weight_decay: float = 0.0
    warmup_steps: int = 0
    every: int = 1          # steps whose gradients make one update

    def schedule(self, count: int) -> float:
        """optax `cosine_decay_schedule(lr, total_steps)`, or with warm-up
        `warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps)`
        (`warmup_cosine`)."""
        return warmup_cosine(self.lr, self.warmup_steps,
                             self.total_steps)(count)

    def create(self, params) -> torch.optim.Optimizer:
        params = list(params)
        if self.weight_decay > 0:
            return torch.optim.AdamW(params, lr=self.schedule(0),
                                     betas=ADAM_BETAS, eps=ADAM_EPS,
                                     weight_decay=self.weight_decay)
        return torch.optim.Adam(params, lr=self.schedule(0), betas=ADAM_BETAS,
                                eps=ADAM_EPS)


def make_optimizer(lr: float = 1e-4, total_steps: int = 2_000_000,
                   grad_clip: float = 5.0, weight_decay: float = 0.0,
                   warmup_steps: int = 0) -> OptimizerConfig:
    """Adam + cosine schedule + global-norm clip (reference: MGP-STR
    train_final_dist.py:100 Adam(beta1=0.9), :105 cosine schedule, :165
    clip_grad_norm_(5))."""
    return OptimizerConfig(lr, total_steps, grad_clip, weight_decay,
                           warmup_steps)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """optax `clip_by_global_norm`, in place: g ← g / norm · max_norm when the
    global norm is at least `max_norm`, else g unchanged. Returns the norm
    (a device scalar: no host synchronisation)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def unreached_zero(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """0 · Σ p over `params`: added to a loss that does not reach them, it
    gives each the zero gradient `jax.grad` gives a leaf outside the loss
    (torch leaves its `.grad` None, which `apply_gradients` refuses as a
    cut graph). Adam moves no parameter on zero gradients."""
    return sum(p.sum() for p in params) * 0.0


@dataclasses.dataclass
class TrainState:
    """`step` counts the steps taken (updates made, unless gradients
    accumulate over `tx.every` steps); `model` holds the parameters and
    the BatchNorm running statistics, `optimizer` the Adam moments, and
    `accum` the running mean of the gradients since the last update."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: OptimizerConfig
    accum: Optional[List[torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerConfig) -> "TrainState":
        return cls(step=0, model=model, optimizer=tx.create(
            p for p in model.parameters() if p.requires_grad), tx=tx)

    def apply_gradients(self) -> Optional[torch.Tensor]:
        """Clip the gradients the last backward left, then take one
        optimiser step at the schedule's rate. Every trainable parameter
        must have a gradient (as every leaf has one under `jax.grad`): a
        missing one means the graph was cut, and raises. Returns the global
        gradient norm before the clip.

        With `tx.every` > 1 the gradients first join the running mean of
        the steps since the last update, `acc += (g − acc) / (n + 1)` (optax
        `MultiSteps`); only the `every`-th step clips that mean and
        updates, at the schedule's rate for the count of updates made.
        The other steps return None."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        missing = [n for n, p in self.model.named_parameters()
                   if p.requires_grad and p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        every = self.tx.every
        updates = self.step // every
        if every > 1:
            if self.accum is None:
                self.accum = [torch.zeros_like(p) for p in params]
            n = self.step % every
            for a, p in zip(self.accum, params):
                a.add_((p.grad - a) / (n + 1))
            self.step += 1
            if n + 1 < every:
                return None
            for a, p in zip(self.accum, params):
                p.grad = a.clone()
                a.zero_()
        norm = clip_by_global_norm([p.grad for p in params],
                                   self.tx.grad_clip)
        lr = self.tx.schedule(updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if every == 1:
            self.step += 1
        return norm


def cross_entropy_ignore_pad(logits: torch.Tensor, targets: torch.Tensor,
                             ignore_id: int = 0) -> torch.Tensor:
    """Mean CE over non-ignored positions (reference: CrossEntropyLoss(
    ignore_index=0), train_final_dist.py:85): f32 log-softmax over every
    column, vocab padding included, as the JAX function."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    valid = (targets != ignore_id).float()
    return (nll * valid).sum() / valid.sum().clamp(min=1.0)


def mgp_str_loss(outputs: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor]) -> Metrics:
    """Sum of the 3 granularity CE losses (train_final_dist.py:150-153)."""
    char_loss = cross_entropy_ignore_pad(outputs["char"], batch["char_ids"])
    bpe_loss = cross_entropy_ignore_pad(outputs["bpe"], batch["bpe_ids"])
    wp_loss = cross_entropy_ignore_pad(outputs["wp"], batch["wp_ids"])
    return {"loss": char_loss + bpe_loss + wp_loss, "char_loss": char_loss,
            "bpe_loss": bpe_loss, "wp_loss": wp_loss}


def make_train_step(loss_fn: LossFn, state: TrainState):
    """A train step bound to `state`: `step(batch, generator) -> metrics`.

    `loss_fn(batch, generator) -> (loss, metrics)` runs `state.model` (put
    in `train()` mode here) on a batch of device tensors; `generator`
    feeds its dropout. The step updates `state` in place and returns the
    metrics as detached device tensors (reading them synchronises)."""

    def step(batch: Dict[str, torch.Tensor],
             generator: torch.Generator = None) -> Metrics:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, generator)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def mgp_str_loss_fn(model: nn.Module) -> LossFn:
    """`loss_fn(batch, generator)` of MGP-STR: batch = {"images"
    [B, 32, 128, 3] normalised, "char_ids"/"bpe_ids"/"wp_ids" [B, T] int}."""

    def loss_fn(batch, generator):
        m = mgp_str_loss(model(batch["images"], generator=generator), batch)
        return m["loss"], m

    return loss_fn


def make_mgp_str_train_step(model: nn.Module, state: TrainState):
    """MGP-STR train step (`model` is `state.model`)."""
    return make_train_step(mgp_str_loss_fn(model), state)
