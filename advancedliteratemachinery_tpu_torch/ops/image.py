"""On-device image front end (port of
`advancedliteratemachinery_tpu/ops/image.py`: `normalize_crops`,
`crop_rects`, `warp_quad_crops`, `resize_word_crops`). Layouts are the JAX
package's: NHWC uint8 in, NHWC normalized out.
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


def warp_quad_crops(images_u8: torch.Tensor, quads: torch.Tensor,
                    out_hw: Tuple[int, int] = (32, 128),
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Quad → rectangle crops by a bilinear ruled-surface warp.

    images_u8 [P, H, W, C] uint8; quads [P, K, 4, 2] (x, y) corners in
    [tl, tr, br, bl] order, in pixel-corner space (a full-page quad is
    [(0, 0), (W, 0), (W, H), (0, H)]). Output pixel (v, u) samples
    Σ corner · weight(u, v), shifted by -0.5 into pixel-centre space, with
    clamped bilinear taps. Returns [P, K, h, w, C] normalized to [-1, 1].
    Exact for rectangles and parallelograms; a true perspective quad
    deviates slightly from a perspective warp, as in the JAX function."""
    P, H, W, C = images_u8.shape
    K = quads.shape[1]
    h, w = out_hw
    dev = images_u8.device
    u = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w)[None]
    v = ((torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h)[:, None]
    wts = torch.stack([(1 - u) * (1 - v), u * (1 - v), u * v,
                       (1 - u) * v])                          # [4, h, w]
    src = torch.einsum("pkcd,chw->pkhwd", quads.float(), wts) - 0.5
    x, y = src[..., 0], src[..., 1]
    x0 = torch.floor(x).clamp(0, W - 1)
    y0 = torch.floor(y).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    fx = (x - x0).clamp(0.0, 1.0)[..., None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None]
    flat = images_u8.reshape(P, H * W, C).float()

    def gather(yi, xi):
        idx = (yi.long() * W + xi.long()).reshape(P, K * h * w, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(
            P, K, h, w, C)

    top = gather(y0, x0) * (1 - fx) + gather(y0, x1) * fx
    bot = gather(y1, x0) * (1 - fx) + gather(y1, x1) * fx
    out = top * (1 - fy) + bot * fy
    return (out * (2.0 / 255.0) - 1.0).to(dtype)


def _resize_weights(in_size: int, out_size: int, antialias: bool,
                    device) -> torch.Tensor:
    """[out, in] triangle-kernel weights of `jax.image.resize(...,
    "bilinear")`: samples at (i + 0.5) / scale - 0.5; with `antialias` a
    downscale widens the kernel by 1/scale; each row normalized."""
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0) if antialias else 1.0
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) / scale - 0.5)
    dist = (sample[:, None] - torch.arange(in_size, dtype=torch.float32,
                                           device=device)).abs()
    wts = torch.clamp(1.0 - dist / kernel_scale, min=0.0)
    total = wts.sum(1, keepdim=True)
    return torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                       wts / torch.where(total != 0, total, 1.0), 0.0)


def resize_word_crops(images_u8: torch.Tensor,
                      out_hw: Tuple[int, int] = (32, 128),
                      dtype: torch.dtype = torch.bfloat16,
                      antialias: bool = True) -> torch.Tensor:
    """uint8 [B, H, W, C] → bilinear resize to `out_hw`, normalized to
    [-1, 1]: `jax.image.resize`'s separable weights, built here."""
    B, H, W, C = images_u8.shape
    ry = _resize_weights(H, out_hw[0], antialias, images_u8.device)
    rx = _resize_weights(W, out_hw[1], antialias, images_u8.device)
    x = torch.einsum("iy,byxc->bixc", ry, images_u8.float())
    x = torch.einsum("jx,bixc->bijc", rx, x)
    return (x * (2.0 / 255.0) - 1.0).to(dtype)
