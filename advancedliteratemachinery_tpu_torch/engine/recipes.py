"""Per-model training recipes (port of
`advancedliteratemachinery_tpu/engine/recipes.py`: MGP-STR, LORE and DB).

A recipe maps a model to `(loss_fn, tx)`: the loss over a batch dict of
device tensors, `loss_fn(batch, generator) -> (loss, metrics)`, and the
reference's optimiser settings, for `engine.train.make_train_step` and
`engine.fit.fit`. The train step puts the model in `train()` mode, so
BatchNorm models (LORE, DB) normalise with the batch's statistics and
update their running ones, as the JAX recipes' `mutable=["batch_stats"]`
apply does.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from advancedliteratemachinery_tpu_torch.engine.train import (
    OptimizerConfig, make_optimizer, mgp_str_loss_fn, unreached_zero)


def mgp_str_recipe(model) -> Tuple[Callable, OptimizerConfig]:
    """batch: images (normalised), char_ids, bpe_ids, wp_ids
    (train_final_dist.py:150)."""
    return mgp_str_loss_fn(model), make_optimizer(
        lr=1e-4, total_steps=2_000_000, grad_clip=5.0)


# the LORE heads its losses read; the others (st, cr, reg) train only in
# the reference's corner and pair losses, which its release scripts leave
# out, as the JAX recipe does
LORE_LOSS_HEADS = ("hm", "wh", "ax")


def lore_recipe(model) -> Tuple[Callable, OptimizerConfig]:
    """batch: images, hm [B, H/4, W/4, 2], ct_inds, ct_mask [B, K],
    wh_target [B, K, 8], logic_target [B, K, 4] and gt_boxes [B, K, 8]
    (src/lib/trains/ctdet.py:18 CtdetLoss: hm 1, wh 1, the axis loss of
    each Processor output). The heads the losses do not read, and the
    trunk's projections no output reads, get zero gradients, as under
    `jax.grad`."""
    from advancedliteratemachinery_tpu_torch.models.lore import (
        axis_loss, focal_loss, reg_l1_loss)
    from advancedliteratemachinery_tpu_torch.ops.heatmap import (
        gather_feat, sigmoid_clamped)

    seg = model.backbone
    unread = seg.base.unread_parameters() + [
        p for head, _ in seg.config.heads if head not in LORE_LOSS_HEADS
        for m in (f"{head}_conv1", f"{head}_out")
        for p in getattr(seg, m).parameters()]

    def loss_fn(batch: Dict[str, torch.Tensor], generator=None):
        boxes = batch.get("gt_boxes")
        heads, logic = model.train_logic(batch["images"], batch["ct_inds"],
                                         batch["ct_mask"], boxes)
        hm_loss = focal_loss(sigmoid_clamped(heads["hm"]), batch["hm"])
        wh_pred = gather_feat(heads["wh"], batch["ct_inds"])
        wh_loss = reg_l1_loss(wh_pred, batch["ct_mask"], batch["wh_target"])
        ax = axis_loss(logic["logic"], batch["ct_mask"],
                       batch["logic_target"])
        if "stacked_logic" in logic:
            ax = ax + axis_loss(logic["stacked_logic"], batch["ct_mask"],
                                batch["logic_target"])
        untouched = list(unread)
        if boxes is None and model.config.wiz_2dpe:
            untouched += [model.processor.x_pe.weight,
                          model.processor.y_pe.weight]
        loss = hm_loss + wh_loss + ax + unreached_zero(untouched)
        return loss, {"loss": loss, "hm_loss": hm_loss, "wh_loss": wh_loss,
                      "axis_loss": ax}

    return loss_fn, make_optimizer(lr=1e-4, total_steps=400_000,
                                   grad_clip=5.0)


def db_recipe(model, alpha: float = 1.0, beta: float = 10.0
              ) -> Tuple[Callable, OptimizerConfig]:
    """The DB losses: BCE of the probability map + alpha · BCE of the
    binary map + beta · masked L1 of the threshold map (the standard DB
    recipe). batch: images, gt_prob, gt_thresh and thresh_mask
    [B, H, W, 1]."""

    def bce(p, t):
        p = p.clamp(1e-6, 1 - 1e-6)
        return -(t * torch.log(p) + (1 - t) * torch.log(1 - p)).mean()

    def loss_fn(batch: Dict[str, torch.Tensor], generator=None):
        out = model(batch["images"])
        l_prob = bce(out["prob"], batch["gt_prob"])
        l_bin = bce(out["binary"], batch["gt_prob"])
        tm = batch.get("thresh_mask")
        if tm is None:
            tm = torch.ones_like(batch["gt_thresh"])
        l_thresh = ((out["thresh"] - batch["gt_thresh"]).abs() * tm).sum(
        ) / tm.sum().clamp(min=1.0)
        loss = l_prob + alpha * l_bin + beta * l_thresh
        return loss, {"loss": loss, "prob_loss": l_prob,
                      "binary_loss": l_bin, "thresh_loss": l_thresh}

    return loss_fn, make_optimizer(lr=7e-3, total_steps=100_000,
                                   grad_clip=5.0)


RECIPES: Dict[str, Callable] = {
    "mgp_str": mgp_str_recipe,
    "lore": lore_recipe,
    "db": db_recipe,
}
