"""CenterNet-style heatmap decode with a fixed K, on the device (port of
`advancedliteratemachinery_tpu/ops/heatmap.py`; reference LORE-TSR
decode.py `_nms`, `_topk`, `corner_decode`, `ctdet_4ps_decode`).

Layout: heatmaps are NHWC [B, H, W, C(lasses)], as in the JAX package.

After `heatmap_peaks` most of a map is exactly 0.0 and `sigmoid_clamped`
saturates at 1e-4 and 1 - 1e-4, so top-K meets exact ties whenever K
exceeds the number of peaks. `lax.top_k` puts the lower index first on a
tie and `torch.topk` promises no order, so both top-K stages here take the
first k of a stable descending sort.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def heatmap_peaks(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima: heat where maxpool(heat) == heat, else 0."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, 1, pad)
    return torch.where(hmax.permute(0, 2, 3, 1) == heat, heat, 0.0)


def _top_k(x: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: the lower index first on ties."""
    vals, inds = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], inds[..., :k]


def topk_peaks(heat: torch.Tensor, k: int = 100) -> Dict[str, torch.Tensor]:
    """Global top-K over classes and positions (reference `_topk`).

    Returns scores [B, K], inds (flat y*W+x) [B, K] int32, clses [B, K]
    int32, ys [B, K] and xs [B, K] (float, integer-valued)."""
    B, H, W, C = heat.shape
    flat = heat.permute(0, 3, 1, 2).reshape(B, C, H * W)
    cls_scores, cls_inds = _top_k(flat, k)                   # [B, C, K]
    scores, ind2 = _top_k(cls_scores.reshape(B, C * k), k)
    clses = torch.div(ind2, k, rounding_mode="floor").int()
    inds = torch.gather(cls_inds.reshape(B, C * k), 1, ind2)
    return {"scores": scores, "inds": inds.int(), "clses": clses,
            "ys": torch.div(inds, W, rounding_mode="floor").float(),
            "xs": (inds % W).float()}


def gather_feat(fmap: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """fmap [B, H, W, C], inds [B, K] flat spatial → [B, K, C]."""
    B, H, W, C = fmap.shape
    flat = fmap.reshape(B, H * W, C)
    return torch.gather(flat, 1, inds.long()[..., None].expand(-1, -1, C))


def _four_points(xs: torch.Tensor, ys: torch.Tensor,
                 d: torch.Tensor) -> torch.Tensor:
    """(x - d0, y - d1, x - d2, y - d3, ...) for xs/ys [B, K, 1], d
    [B, K, 8] → [B, K, 8]."""
    return torch.stack([xs, ys] * 4, dim=-1).squeeze(-2) - d


def corner_decode(mk: torch.Tensor, st_reg: torch.Tensor,
                  mk_reg: Optional[torch.Tensor] = None,
                  k: int = 400) -> Dict[str, torch.Tensor]:
    """Corner-heatmap decode (decode.py:54): peaks → top-K → center offsets
    → the 8-dof group boxes implied by each corner's st regression."""
    peaks = topk_peaks(heatmap_peaks(mk), k)
    xs, ys = peaks["xs"][..., None], peaks["ys"][..., None]
    if mk_reg is not None:
        reg = gather_feat(mk_reg, peaks["inds"])
        xs = xs + reg[:, :, 0:1]
        ys = ys + reg[:, :, 1:2]
    else:
        xs = xs + 0.5
        ys = ys + 0.5
    st = gather_feat(st_reg, peaks["inds"])                  # [B, K, 8]
    return {"scores": peaks["scores"][..., None], "inds": peaks["inds"],
            "xs": xs, "ys": ys, "gboxes": _four_points(xs, ys, st)}


def ctdet_4ps_decode(heat: torch.Tensor, wh: torch.Tensor, ax: torch.Tensor,
                     cr: torch.Tensor, reg: Optional[torch.Tensor] = None,
                     k: int = 100) -> Dict[str, torch.Tensor]:
    """Cell-center decode (decode.py:79): top-K centers, 8-dof corner
    offsets → 4-point boxes, and the corner features summed for the logical
    processor.

    heat [B, H, W, Cc]; wh [B, H, W, 8]; ax [B, H, W, Da]; cr
    [B, H, W, Dc]; reg [B, H, W, 2]. Returns detections [B, K, 10] (8
    points, score, class), cr_feat [B, K, Dc], ax_feat [B, K, Da], sorted by
    score."""
    B, H, W, _ = heat.shape
    peaks = topk_peaks(heatmap_peaks(heat), k)
    xs, ys = peaks["xs"][..., None], peaks["ys"][..., None]
    if reg is not None:
        r = gather_feat(reg, peaks["inds"])
        xs = xs + r[:, :, 0:1]
        ys = ys + r[:, :, 1:2]
    else:
        xs = xs + 0.5
        ys = ys + 0.5
    bboxes = _four_points(xs, ys, gather_feat(wh, peaks["inds"]))
    axk = gather_feat(ax, peaks["inds"])

    # each predicted corner rounds to a grid cell; its cr feature is summed
    # over the 4 corners (decode.py:199-205). Clipped before the integer
    # cast, which is where the JAX package's cast-then-clip saturates.
    cc_x = bboxes[..., 0::2]
    cc_y = torch.round(bboxes[..., 1::2])
    cc_match = torch.round(cc_x + W * cc_y).clamp(0, H * W - 1).long()
    crk = gather_feat(cr, cc_match.reshape(B, -1))           # [B, 4K, Dc]
    cr_feat = crk.reshape(B, k, 4, -1).sum(dim=2)

    detections = torch.cat([bboxes, peaks["scores"][..., None],
                            peaks["clses"][..., None].float()], dim=2)
    return {"detections": detections, "cr_feat": cr_feat, "ax_feat": axk,
            "scores": peaks["scores"], "inds": peaks["inds"],
            "centers": torch.cat([xs, ys], dim=2)}


def sigmoid_clamped(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Reference `_sigmoid` (utils.py:9): sigmoid clamped to [eps, 1-eps]."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)
