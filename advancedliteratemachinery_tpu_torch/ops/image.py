"""On-device image front end (port of
`advancedliteratemachinery_tpu/ops/image.py`: `normalize_crops`,
`crop_rects`). Layouts are the JAX package's: NHWC uint8 in, NHWC
normalized out.
"""

from __future__ import annotations

from typing import Tuple

import torch


def normalize_crops(images_u8: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 [B, H, W, C] → (x/255 - 0.5) / 0.5 in `dtype` (range [-1, 1])."""
    return (images_u8.float() * (2.0 / 255.0) - 1.0).to(dtype)


def crop_rects(images_u8: torch.Tensor, quads: torch.Tensor,
               out_hw: Tuple[int, int] = (32, 128),
               dtype: torch.dtype = torch.bfloat16,
               patch_hw: Tuple[int, int] = (64, 256)) -> torch.Tensor:
    """Axis-aligned crop extraction: fixed-size patch gather + separable
    bilinear resample.

    images_u8 [P, H, W, C] uint8; quads [P, K, 4, 2] (only the min/max x/y of
    the corners are used). Returns [P, K, h, w, C] normalized to [-1, 1].
    Each crop reads one [patch_h, patch_w] window (clamped to the page) and
    resamples it with the two interpolation matrices Ry [h, ph] and
    Rx [w, pw]; boxes larger than `patch_hw` are cut to it, as in the JAX
    function."""
    P, H, W, C = images_u8.shape
    h, w = out_hw
    dev = images_u8.device
    ph, pw = min(patch_hw[0], H), min(patch_hw[1], W)
    q = quads.float()
    qx, qy = q[..., 0], q[..., 1]
    x0, x1 = qx.amin(-1), qx.amax(-1)
    y0, y1 = qy.amin(-1), qy.amax(-1)
    ys = (torch.floor(y0).to(torch.int64) - 1).clamp(0, max(H - ph, 0))
    xs = (torch.floor(x0).to(torch.int64) - 1).clamp(0, max(W - pw, 0))

    rows = ys[..., None] + torch.arange(ph, device=dev)          # [P, K, ph]
    cols = xs[..., None] + torch.arange(pw, device=dev)          # [P, K, pw]
    pidx = torch.arange(P, device=dev)[:, None, None, None]
    patches = images_u8[pidx, rows[..., :, None], cols[..., None, :]]
    patches = patches.float()                                # [P,K,ph,pw,C]

    iy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    jx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    sy = y0[..., None] + iy * (y1 - y0)[..., None] - 0.5 - ys[..., None]
    sx = x0[..., None] + jx * (x1 - x0)[..., None] - 0.5 - xs[..., None]
    ty = torch.arange(ph, dtype=torch.float32, device=dev)
    tx = torch.arange(pw, dtype=torch.float32, device=dev)
    Ry = torch.clamp(1.0 - (sy[..., None] - ty).abs(), min=0.0)  # [P,K,h,ph]
    Rx = torch.clamp(1.0 - (sx[..., None] - tx).abs(), min=0.0)  # [P,K,w,pw]
    t1 = torch.einsum("pkiy,pkyxc->pkixc", Ry, patches)
    out = torch.einsum("pkixc,pkjx->pkijc", t1, Rx)
    return (out * (2.0 / 255.0) - 1.0).to(dtype)
