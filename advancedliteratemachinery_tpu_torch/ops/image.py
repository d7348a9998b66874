"""On-device image front end (port of
`advancedliteratemachinery_tpu/ops/image.py`: `normalize_crops`,
`crop_rects`, `warp_quad_crops`, `resize_word_crops`). Layouts are the JAX
package's: NHWC uint8 in, NHWC normalized out.

The document pipelines' cv2 calls have no twin in the JAX package's ops;
the card's machine has no cv2, so they are here too, on the device with
uint8 out:

- `resize_linear_u8` is `cv2.resize(..., INTER_LINEAR)`: half-pixel
  centres, edge clamp, no antialias, in cv2's own fixed point (11-bit
  weights; the vertical pass as its vector code rounds it). It equals
  cv2 5.0 bit for bit on every downscale tried and is within one uint8
  level on upscales, where cv2's scalar edge code rounds otherwise;
- `warp_perspective_u8` is `cv2.warpPerspective` (INTER_LINEAR,
  BORDER_CONSTANT 0) with the inverse homography that
  `perspective_maps` solves from each quad, as `cv2.getPerspectiveTransform`
  does: integer destination pixels mapped back in float64, bilinear taps
  in float32, a tap outside the page reads 0, rounded half up. Within
  one uint8 level of cv2 5.0;
- `resize_bicubic_u8` is PIL's default `Image.resize(size)` on an RGB
  page (BICUBIC, a = -0.5, widened by the downscale factor), in PIL's
  own fixed point (22-bit weights, a uint8 clip between the horizontal
  and the vertical pass): bit-equal to PIL 12;
- `crop_quads_u8` chains them: every quad to its own size (the JAX
  pipeline's `crop_image`), then to the recognizer's crop shape, for all
  quads of a page in one batch (each warped into its own stretch of a
  flat buffer of Σ wᵢ·hᵢ pixels and resized from there).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
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


# cv2's fixed point for linear resizes: INTER_RESIZE_COEF_BITS
RESIZE_COEF_SCALE = 2048


def as_device_tensor(x, device) -> torch.Tensor:
    """A NumPy array or a tensor on any device → a tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


def _linear_taps(in_size: torch.Tensor, out_size: int):
    """cv2's linear resize taps along one axis for sources of `in_size`
    pixels ([N] int64, one per image) to `out_size`: (i0, i1, a0, a1),
    each [N, out_size]; a0/a1 are the 11-bit fixed-point weights."""
    dev = in_size.device
    scale = 1.0 / (out_size / in_size.double())                 # [N]
    d = torch.arange(out_size, dtype=torch.float64, device=dev)
    s = ((d[None] + 0.5) * scale[:, None] - 0.5).float()
    s0 = torch.floor(s)
    f = s - s0
    s0 = s0.long()
    last = in_size[:, None] - 1
    low, high = s0 < 0, s0 >= last
    f = torch.where(low | high, 0.0, f)
    s0 = torch.where(low, 0, torch.where(high, last, s0))
    a1 = torch.round(f * RESIZE_COEF_SCALE).int()
    a0 = torch.round((1.0 - f) * RESIZE_COEF_SCALE).int()
    return s0, torch.minimum(s0 + 1, last), a0, a1


def _resize_taps_u8(read, sizes: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2's INTER_LINEAR fixed point over N images of their own sizes
    ([N, 2] (w, h)): `read(rows [N, oh], cols [N, ow])` gives the int32
    source pixels [N, oh, ow, C] at those rows and columns of each image.
    Only the taps' rows and columns are read, so the work is
    N × oh × ow whatever the sources' sizes."""
    oh, ow = out_hw
    y0, y1, b0, b1 = _linear_taps(sizes[:, 1].long(), oh)
    x0, x1, a0, a1 = _linear_taps(sizes[:, 0].long(), ow)
    a0, a1 = a0[:, None, :, None], a1[:, None, :, None]
    # horizontal pass at scale 2048, then cv2's truncating vertical pass
    r0 = (read(y0, x0) * a0 + read(y0, x1) * a1) >> 4
    r1 = (read(y1, x0) * a0 + read(y1, x1) * a1) >> 4
    v = (((r0 * b0[..., None, None]) >> 16)
         + ((r1 * b1[..., None, None]) >> 16) + 2) >> 2
    return v.clamp(0, 255).to(torch.uint8)


def resize_crops_u8(images_u8: torch.Tensor, sizes: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 [N, Hc, Wc, C], image n valid in its top-left
    sizes[n] = (w, h) → uint8 [N, h_out, w_out, C], each resized from its
    own size as `cv2.resize(..., INTER_LINEAR)`."""
    n = torch.arange(len(images_u8), device=images_u8.device)[:, None, None]

    def read(rows, cols):
        return images_u8[n, rows[:, :, None], cols[:, None, :]].int()

    return _resize_taps_u8(read, sizes, out_hw)


def resize_each_u8(images_u8: Sequence, out_hw: Tuple[int, int],
                   device, batch: int = 0) -> torch.Tensor:
    """uint8 images [h_i, w_i, C] of any sizes (NumPy arrays or tensors on
    any device) → uint8 [max(N, batch), h, w, C] on `device`: image i
    resized from its own size as `cv2.resize(image, (w, h))`, the rows past
    N zero. Each image goes up once, into one zero canvas, and one
    `resize_crops_u8` resizes them all."""
    n = max(len(images_u8), batch)
    hc = max(int(im.shape[0]) for im in images_u8)
    wc = max(int(im.shape[1]) for im in images_u8)
    C = int(images_u8[0].shape[-1])
    canvas = torch.zeros((n, hc, wc, C), dtype=torch.uint8, device=device)
    for i, im in enumerate(images_u8):
        canvas[i, :im.shape[0], :im.shape[1]] = as_device_tensor(im, device)
    sizes = ([[int(im.shape[1]), int(im.shape[0])] for im in images_u8]
             + [[wc, hc]] * (n - len(images_u8)))
    return resize_crops_u8(canvas, torch.tensor(sizes, device=device),
                           out_hw)


def resize_linear_u8(images_u8: torch.Tensor,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 [B, H, W, C] → uint8 [B, h, w, C], `cv2.resize(image, (w, h))`
    with its default INTER_LINEAR."""
    B, H, W, _ = images_u8.shape
    sizes = torch.tensor([[W, H]], device=images_u8.device).expand(B, 2)
    return resize_crops_u8(images_u8, sizes, out_hw)


# PIL's fixed point for 8-bit resampling (libImaging/Resample.c)
PIL_PRECISION_BITS = 32 - 8 - 2


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c `bicubic_filter` (a = -0.5), term for term."""
    x = np.abs(x)
    a = -0.5
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pil_bicubic_taps(in_size: int, out_size: int):
    """Resample.c `precompute_coeffs` for the BICUBIC filter (support 2)
    over the whole axis, then `normalize_coeffs_8bpc`: (xmin [out] int64,
    weights [out, ksize] int64 at 2^22, zero past each window). Float64
    on the host, in the C code's order of operations."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    w = _pil_bicubic(((x[None] + xmin[:, None]) - center[:, None] + 0.5)
                     * ss)
    w = np.where(x[None] < xmax[:, None], w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]            # C's left-to-right sum
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = w * (1 << PIL_PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + k, 0.5 + k)).astype(np.int64)
    return xmin, k


def _pil_pass(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """One of Resample.c's 8bpc passes along `axis` of int32 [H, W, C]:
    Σ pixel · weight + 2^21, shifted down 22 bits and clipped to uint8
    (`clip8`), in int32 as PIL sums."""
    in_size = x.shape[axis]
    xmin, k = _pil_bicubic_taps(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1]), in_size - 1)
    idx = torch.from_numpy(idx).to(x.device)
    k = torch.from_numpy(k.astype(np.int32)).to(x.device)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = torch.full((), 1 << (PIL_PRECISION_BITS - 1), dtype=torch.int32,
                     device=x.device)
    for j in range(k.shape[1]):
        acc = acc + (x.index_select(axis, idx[:, j])
                     * k[:, j].reshape(shape))
    return (acc >> PIL_PRECISION_BITS).clamp(0, 255)


def resize_bicubic_u8(image_u8, out_hw: Tuple[int, int],
                      device=None) -> torch.Tensor:
    """uint8 [H, W, C] (a NumPy array or a tensor) → uint8 [h, w, C] on
    `device` (default: the tensor's), `PIL.Image.fromarray(image)
    .resize((w, h))` with its default BICUBIC filter: the horizontal pass,
    then the vertical, each skipped when its axis keeps its size, as
    PIL skips it. The taps are PIL's (`_pil_bicubic_taps`); the passes run
    on the device in int32."""
    if device is None:
        device = (image_u8.device if isinstance(image_u8, torch.Tensor)
                  else "cpu")
    x = as_device_tensor(image_u8, device).to(torch.int32)
    h, w = out_hw
    if x.shape[1] != w:
        x = _pil_pass(x, 1, w)
    if x.shape[0] != h:
        x = _pil_pass(x, 0, h)
    return x.to(torch.uint8)


def _quad_size(pts: np.ndarray) -> Tuple[int, int]:
    """The JAX `crop_image`'s crop size: the longer of each pair of
    opposite sides, truncated, at least 1 (float32 differences, float64
    lengths, as its `math.hypot` on float32 coordinates)."""
    def dist(a, b):
        return math.hypot(a[0] - b[0], a[1] - b[1])

    w = int(max(dist(pts[0], pts[1]), dist(pts[3], pts[2])))
    h = int(max(dist(pts[0], pts[3]), dist(pts[1], pts[2])))
    return max(w, 1), max(h, 1)


def perspective_maps(quads) -> Tuple[np.ndarray, np.ndarray]:
    """quads [N, 4, 2] (tl, tr, br, bl) → (sizes [N, 2] int64 (w, h), the
    homographies [N, 3, 3] float64 that map each crop's pixel (x, y, 1)
    back onto the page), on the host: the inverse of
    `cv2.getPerspectiveTransform(quad, [(0, 0), (w, 0), (w, h), (0, h)])`,
    solved directly from the 8 equations in float64."""
    quads = np.asarray(quads, np.float32).reshape(-1, 4, 2)
    N = len(quads)
    sizes = np.array([_quad_size(q) for q in quads], np.int64).reshape(N, 2)
    w = sizes[:, 0].astype(np.float64)
    h = sizes[:, 1].astype(np.float64)
    zero = np.zeros(N)
    dst = np.stack([np.stack([zero, zero], -1), np.stack([w, zero], -1),
                    np.stack([w, h], -1), np.stack([zero, h], -1)], 1)
    src = quads.astype(np.float64)
    A = np.zeros((N, 8, 8))
    b = np.zeros((N, 8))
    for i in range(4):
        x, y = dst[:, i, 0], dst[:, i, 1]
        u, v = src[:, i, 0], src[:, i, 1]
        A[:, i, 0], A[:, i, 1], A[:, i, 2] = x, y, 1.0
        A[:, i, 6], A[:, i, 7] = -x * u, -y * u
        A[:, i + 4, 3], A[:, i + 4, 4], A[:, i + 4, 5] = x, y, 1.0
        A[:, i + 4, 6], A[:, i + 4, 7] = -x * v, -y * v
        b[:, i], b[:, i + 4] = u, v
    m = np.linalg.solve(A, b[..., None])[..., 0] if N else np.zeros((0, 8))
    return sizes, np.concatenate([m, np.ones((N, 1))], 1).reshape(N, 3, 3)


def _warp_points_u8(image_u8: torch.Tensor, maps: torch.Tensor,
                    crop: torch.Tensor, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """`cv2.warpPerspective`'s value at destination pixels (xs, ys)
    (float64 [P]) of crop `crop[p]` (int64 [P]), whose inverse homography
    is maps[crop[p]] (float64 [N, 3, 3] on the page's device) → uint8
    [P, C]: INTER_LINEAR with a constant 0 border."""
    H, W, C = image_u8.shape

    def row(k):
        return (maps[crop, k, 0] * xs + maps[crop, k, 1] * ys
                + maps[crop, k, 2])

    den = row(2)
    den = torch.where(den == 0, torch.inf, den)       # cv2: W ? 1/W : 0
    X, Y = row(0) / den, row(1) / den
    x0f, y0f = torch.floor(X), torch.floor(Y)
    fx = (X - x0f).float()[..., None]
    fy = (Y - y0f).float()[..., None]
    x0 = x0f.clamp(-2, W + 1).long()
    y0 = y0f.clamp(-2, H + 1).long()
    flat = image_u8.reshape(H * W, C).float()

    def tap(yy, xx):
        inside = ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W))[..., None]
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1))
        return torch.where(inside, flat[idx], 0.0)

    v = ((tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx) * (1 - fy)
         + (tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx) * fy)
    return torch.floor(v + 0.5).clamp(0, 255).to(torch.uint8)


def warp_perspective_u8(image_u8: torch.Tensor, inv_maps: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 page [H, W, C], inverse homographies [N, 3, 3] (float64) →
    uint8 [N, h, w, C]: `cv2.warpPerspective(page, M, (w, h))` for each
    map, INTER_LINEAR with a constant 0 border."""
    oh, ow = out_hw
    dev = image_u8.device
    N = len(inv_maps)
    crop = torch.arange(N, device=dev).repeat_interleave(oh * ow)
    pix = torch.arange(oh * ow, device=dev).repeat(N)
    out = _warp_points_u8(image_u8, inv_maps.to(dev, torch.float64), crop,
                          (pix % ow).double(), (pix // ow).double())
    return out.reshape(N, oh, ow, -1)


def crop_quads_u8(image_u8: torch.Tensor, quads,
                  out_hw: Tuple[int, int] = (32, 128)) -> torch.Tensor:
    """uint8 page [H, W, C] on its device, quads [N, 4, 2] (host, ordered
    tl, tr, br, bl) → uint8 [N, h, w, C] on the page's device: each quad
    rectified to its own size (`cv2.getPerspectiveTransform` +
    `cv2.warpPerspective`), then resized to `out_hw` (`cv2.resize`). The
    sizes and homographies come from the host's quads, so no crop waits
    on the device. The rectified crops lie in one flat buffer of
    Σ wᵢ·hᵢ pixels (crop i at offsets[i], row-major in its own width), so
    memory and time follow the crops' own areas."""
    sizes, maps = perspective_maps(quads)
    dev = image_u8.device
    C = image_u8.shape[-1]
    if len(sizes) == 0:
        return torch.zeros((0, *out_hw, C), dtype=torch.uint8, device=dev)
    areas = sizes[:, 0] * sizes[:, 1]
    offsets = torch.from_numpy(np.cumsum(areas) - areas).to(dev)
    widths = torch.from_numpy(sizes[:, 0]).to(dev)
    crop = torch.arange(len(sizes), device=dev).repeat_interleave(
        torch.from_numpy(areas).to(dev), output_size=int(areas.sum()))
    local = torch.arange(int(areas.sum()), device=dev) - offsets[crop]
    w = widths[crop]
    flat = _warp_points_u8(image_u8, torch.from_numpy(maps).to(dev), crop,
                           (local % w).double(), (local // w).double())
    del crop, local, w
    base = offsets[:, None, None]
    stride = widths[:, None, None]

    def read(rows, cols):
        return flat[base + rows[:, :, None] * stride
                    + cols[:, None, :]].int()

    return _resize_taps_u8(read, torch.from_numpy(sizes).to(dev), out_hw)
