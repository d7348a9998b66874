"""DB (Differentiable Binarization) text detector, inference path (port of
`advancedliteratemachinery_tpu/models/db.py` `DBDetector`).

ResNet-18 backbone → FPN → per-level laterals concatenated at 1/4 →
probability head (conv3x3+BN+relu → 1x1 conv + pixel shuffle + BN + relu →
1x1 conv + pixel shuffle → sigmoid). In `train()` mode a threshold head of
the same form (`thresh_*`) runs too, and the differentiable binarization
b = sigmoid(k·(prob − thresh)) in float32; BatchNorm then normalises with
the batch's statistics and updates the running ones, as flax's
`train=True` with `mutable=["batch_stats"]`. The JAX package's
space-to-depth
stem is a TPU rewrite of an ordinary 7x7 stride-2 convolution over the same
(7, 7, C, F) kernel, and is one `conv2d` here. Pages come in NHWC, as in the
JAX package, and the network runs in NCHW inside.

`extract_boxes` is the JAX package's host DB post-processing without cv2:
the cv2 calls it makes (contours, min-area rectangles, polygon fill) are
`ops/contours.py`'s, and so are those of `db_targets`, the training maps
(polygon fill, polylines, the L2 distance transform). `make_db_detect_fn` is the document pipelines'
detect function, the JAX CLI's `_db_detect_fn`: the page resized on the
device, the probability map read back once, boxes from `extract_boxes`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.core.registry import MODELS
from advancedliteratemachinery_tpu_torch.models.layers import (
    BN_EPS, batch_norm, conv2d, init_params)
from advancedliteratemachinery_tpu_torch.ops.contours import (
    arc_length, box_points, contour_area, distance_transform,
    fill_poly_window, find_contours, min_area_rect, polyline_window)
from advancedliteratemachinery_tpu_torch.ops.image import (
    as_device_tensor, resize_linear_u8)


class ConvBNRelu(nn.Module):
    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), relu: bool = True,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.relu = relu
        # torch-style symmetric (k-1)//2 padding, as the JAX module
        self.conv = nn.Conv2d(in_ch, features, kernel, strides,
                              padding=tuple((k - 1) // 2 for k in kernel),
                              bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        x = batch_norm(conv2d(x, self.conv, c), self.bn).to(c)
        return F.relu(x) if self.relu else x


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.c1 = ConvBNRelu(in_ch, planes, (3, 3), (stride, stride),
                             policy=policy)
        self.c2 = ConvBNRelu(planes, planes, (3, 3), relu=False,
                             policy=policy)
        self.down = (ConvBNRelu(in_ch, planes, (1, 1), (stride, stride),
                                relu=False, policy=policy)
                     if stride != 1 or in_ch != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = x if self.down is None else self.down(x)
        return F.relu(self.c2(self.c1(x)) + r)


@dataclasses.dataclass(frozen=True)
class DBConfig:
    width: int = 64           # resnet-18 base width
    fpn_dim: int = 256
    head_dim: int = 64
    k: float = 50.0           # binarization steepness


@MODELS.register("db_detector")
class DBDetector(nn.Module):
    """Built on `device` (the GPU unless `device="cpu"`), in eval mode, with
    random weights from `seed`; load real weights with `engine.convert`.
    A flax tree made for inference has no threshold head; those parameters
    then keep their values (`FLAX_TRAIN_ONLY`)."""

    # parameters the JAX module makes only under train=True
    FLAX_TRAIN_ONLY = ("thresh_",)

    def __init__(self, config: DBConfig = DBConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.policy = p = policy
        w = cfg.width
        self.stem = ConvBNRelu(3, w, (7, 7), (2, 2), policy=p)
        in_ch = w
        level_ch = []
        for s, (planes, stride) in enumerate(
                [(w, 1), (2 * w, 2), (4 * w, 2), (8 * w, 2)]):
            for b in range(2):
                self.add_module(f"layer{s}_{b}", ResBlock(
                    in_ch, planes, stride if b == 0 else 1, policy=p))
                in_ch = planes
            level_ch.append(planes)
        for i, ch in enumerate(level_ch):
            self.add_module(f"lat{i}", nn.Conv2d(ch, cfg.fpn_dim, 1))
            self.add_module(f"smooth{i}", nn.Conv2d(cfg.fpn_dim, cfg.head_dim,
                                                    3, padding=1))
        for name in ("prob", "thresh"):
            self.add_module(f"{name}_c", ConvBNRelu(
                4 * cfg.head_dim, cfg.head_dim, policy=p))
            self.add_module(f"{name}_up1", nn.Conv2d(
                cfg.head_dim, 4 * cfg.head_dim, 1))
            self.add_module(f"{name}_bn1", nn.BatchNorm2d(cfg.head_dim,
                                                          eps=BN_EPS))
            self.add_module(f"{name}_up2", nn.Conv2d(cfg.head_dim, 4, 1))
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(device).eval()

    def _head(self, name: str, fuse: torch.Tensor) -> torch.Tensor:
        """conv3x3+BN+relu → 1x1 conv + pixel shuffle (a 2x2 stride-2
        transposed conv) + BN + relu → 1x1 conv + pixel shuffle → sigmoid,
        NCHW [B, 1, H, W] float32."""
        c = self.policy.compute_dtype
        h = getattr(self, f"{name}_c")(fuse)              # [B, hd, H/4, W/4]
        h = F.pixel_shuffle(conv2d(h, getattr(self, f"{name}_up1"), c), 2)
        h = F.relu(batch_norm(h, getattr(self, f"{name}_bn1")).to(c))
        h = F.pixel_shuffle(conv2d(h, getattr(self, f"{name}_up2"), c), 2)
        return torch.sigmoid(h.float())

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] (H, W multiples of 32) → {"prob": [B, H, W, 1]
        float32}, and in `train()` mode "thresh" and "binary" too."""
        c = self.policy.compute_dtype
        x = self.stem(images.to(c).permute(0, 3, 1, 2))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for s in range(4):
            for b in range(2):
                x = getattr(self, f"layer{s}_{b}")(x)
            feats.append(x)                   # strides 4, 8, 16, 32

        lat = [conv2d(f, getattr(self, f"lat{i}"), c)
               for i, f in enumerate(feats)]
        for i in range(2, -1, -1):             # top-down sum
            lat[i] = lat[i] + F.interpolate(lat[i + 1],
                                            size=lat[i].shape[-2:],
                                            mode="nearest")
        size = lat[0].shape[-2:]
        outs = []
        for i, l in enumerate(lat):
            o = conv2d(l, getattr(self, f"smooth{i}"), c)
            if o.shape[-2:] != size:
                o = F.interpolate(o, size=size, mode="nearest")
            outs.append(o)
        fuse = torch.cat(outs, dim=1)                    # [B, 4*hd, H/4, W/4]
        prob = self._head("prob", fuse)
        out = {"prob": prob.permute(0, 2, 3, 1)}
        if self.training:
            thresh = self._head("thresh", fuse)
            out["thresh"] = thresh.permute(0, 2, 3, 1)
            out["binary"] = torch.sigmoid(
                self.config.k * (prob - thresh)).permute(0, 2, 3, 1)
        return out


# the elements NumPy's reductions take at a time (np.getbufsize())
_NP_BUFSIZE = 8192


def _page_sum_f32(window: np.ndarray, y0: int, x0: int, H: int,
                  W: int) -> np.float32:
    """`product.sum()` of a float32 [H, W] product that is zero outside
    `window` (placed at row y0, column x0), bit for bit as NumPy sums the
    page: it reduces the flat page 8192 elements at a time (each buffer
    summed pairwise) and adds the buffers in turn. Buffers outside the
    window's rows add an exact 0, so only those under its rows are
    summed, by NumPy itself."""
    h, w = window.shape
    lo = y0 * W // _NP_BUFSIZE * _NP_BUFSIZE
    hi = min(-(-(y0 + h) * W // _NP_BUFSIZE) * _NP_BUFSIZE, H * W)
    slab = np.zeros(hi - lo, np.float32)
    slab[y0 * W - lo:(y0 + h) * W - lo].reshape(h, W)[:, x0:x0 + w] = window
    total = np.float32(0)
    for at in range(0, len(slab), _NP_BUFSIZE):
        total = np.float32(total + slab[at:at + _NP_BUFSIZE].sum())
    return total


def extract_boxes(prob_map: np.ndarray, bin_thresh: float = 0.3,
                  box_thresh: float = 0.6, unclip_ratio: float = 1.5,
                  min_size: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """prob map [H, W] float32 → (quads [N, 8] float32, scores [N]), by
    score descending: the JAX `models/db.py` `extract_boxes`. Binarize,
    take every contour (holes' too) with 4 or more points, its min-area
    rectangle if both sides reach `min_size`, the mean probability inside
    the rectangle's filled integer polygon as its score, then unclip the
    rectangle by area · `unclip_ratio` / perimeter along its centre-vertex
    directions. The JAX function fills a page-sized mask per contour and
    sums the page; this one fills the polygon's bounding window and sums
    the rows under it as NumPy sums the page (`_page_sum_f32`), so scores,
    and the order of tied scores, are the JAX function's bit for bit."""
    prob_map = np.asarray(prob_map, np.float32)
    binary = (prob_map > bin_thresh).astype(np.uint8)
    boxes: List[np.ndarray] = []
    scores: List[float] = []
    H, W = prob_map.shape
    for cnt in find_contours(binary):
        if len(cnt) < 4:
            continue
        rect = min_area_rect(cnt)
        if min(rect[1]) < min_size:
            continue
        box = box_points(rect)
        ipts = box.astype(np.int32)
        (x0, y0), (x1, y1) = ipts.min(0).tolist(), ipts.max(0).tolist()
        x0, x1 = min(max(x0, 0), W - 1), min(max(x1, 0), W - 1) + 1
        y0, y1 = min(max(y0, 0), H - 1), min(max(y1, 0), H - 1) + 1
        mask = fill_poly_window(ipts, (H, W), (y0, y1, x0, x1))
        total = _page_sum_f32(prob_map[y0:y1, x0:x1] * mask, y0, x0, H, W)
        score = float(np.float64(total) / max(int(mask.sum()), 1))
        if score >= box_thresh:
            boxes.append(box)
            scores.append(score)
    if not boxes:
        return np.zeros((0, 8), np.float32), np.zeros((0,), np.float32)
    # unclip every kept box at once: offset outward by A * r / L along the
    # centre-vertex directions, in the JAX function's float32 steps
    box = np.stack(boxes)
    dist = contour_area(box) * unclip_ratio / np.maximum(arc_length(box),
                                                         1e-6)
    center = box.mean(axis=1, keepdims=True)
    vec = box - center
    norm = np.linalg.norm(vec, axis=2, keepdims=True) + 1e-6
    box = box + vec / norm * dist.astype(np.float32)[:, None, None]
    box[..., 0] = np.clip(box[..., 0], 0, W - 1)
    box[..., 1] = np.clip(box[..., 1], 0, H - 1)
    order = np.argsort(scores)[::-1]
    return (box.reshape(-1, 8).astype(np.float32)[order],
            np.asarray(scores, np.float32)[order])


# the detect function's page size (h, w), the JAX CLI's
DETECT_HW = (640, 640)


def make_db_detect_fn(model: DBDetector, box_thresh: float = 0.3):
    """→ detect_fn(image_u8) for `pipelines.modules.TextDetection`, the JAX
    CLI's `_db_detect_fn`: the page resized to DETECT_HW on the model's
    device (cv2's INTER_LINEAR), scaled to [0, 1] in float32 → the
    probability map, read back once → `extract_boxes` with `box_thresh`
    → (quads [N, 8] float32 in page pixels, scores [N] float32), by score
    descending."""
    device = next(model.parameters()).device
    H, W = DETECT_HW

    @torch.inference_mode()
    def detect(image_u8):
        page = as_device_tensor(image_u8, device)
        h, w = page.shape[:2]
        x = resize_linear_u8(page[None], (H, W)).float() / 255.0
        prob = model(x)["prob"][0, :, :, 0].cpu().numpy()
        quads, scores = extract_boxes(prob, box_thresh=box_thresh)
        if len(quads):
            quads = quads * np.tile([w / W, h / H], 4)
        return quads.astype(np.float32), scores

    return detect


# ---------------- host-side training targets ----------------


def _offset_poly(poly: np.ndarray, dist: float) -> np.ndarray:
    """Offset a polygon outward (dist > 0) or inward along the centre-to-
    vertex directions, the approximation `extract_boxes` unclips with."""
    center = poly.mean(axis=0)
    vec = poly - center
    norm = np.linalg.norm(vec, axis=1, keepdims=True) + 1e-6
    return poly + vec / norm * dist


def _window(pts: np.ndarray, H: int, W: int):
    """The (y0, y1, x0, x1) window of the page that holds integer points
    [n, 2], clipped to the page (possibly empty)."""
    x0, y0 = np.maximum(pts.min(0), 0).tolist()
    x1, y1 = np.minimum(pts.max(0) + 1, (W, H)).tolist()
    return y0, max(y1, y0), x0, max(x1, x0)


def db_targets(polys, hw: Tuple[int, int], shrink_ratio: float = 0.4,
               thresh_min: float = 0.3, thresh_max: float = 0.7
               ) -> Dict[str, np.ndarray]:
    """The DB paper's training maps from text polygons (the JAX
    `db_targets`), for polygons [K, 2] in page pixels on a page of `hw`
    (H, W):

    - gt_prob: each polygon shrunk by d = A(1 − r²)/L, filled with 1;
    - gt_thresh: thresh_min, ramping up to thresh_max on the polygon's
      outline over a band to the polygon dilated by d;
    - thresh_mask: 1 inside the dilated polygons.

    A polygon of fewer than 3 points, area below 1 or perimeter below 1
    is skipped. cv2's fillPoly, polylines and distanceTransform(DIST_L2,
    3) are `ops/contours.py`'s; each runs over the window of the page the
    polygon's band reaches, which gives the same values there as over
    the whole page (the ramp is zero elsewhere)."""
    H, W = hw
    gt_prob = np.zeros((H, W, 1), np.float32)
    thresh_canvas = np.zeros((H, W), np.float32)
    thresh_mask = np.zeros((H, W, 1), np.float32)
    for poly in polys:
        poly = np.asarray(poly, np.float32).reshape(-1, 2)
        if len(poly) < 3:
            continue
        area = float(contour_area(poly))
        length = float(arc_length(poly))
        if area < 1 or length < 1:
            continue
        d = area * (1 - shrink_ratio ** 2) / length
        shrunk = _offset_poly(poly, -d).astype(np.int32)
        win = _window(shrunk, H, W)
        if win[1] > win[0] and win[3] > win[2]:
            gt_prob[win[0]:win[1], win[2]:win[3], 0][
                fill_poly_window(shrunk, (H, W), win) > 0] = 1.0
        dilated = _offset_poly(poly, d).astype(np.int32)
        outline = poly.astype(np.int32)
        y0, y1, x0, x1 = _window(np.concatenate([dilated, outline]), H, W)
        if y1 <= y0 or x1 <= x0:
            continue
        band = fill_poly_window(dilated, (H, W), (y0, y1, x0, x1))
        thresh_mask[y0:y1, x0:x1, 0][band > 0] = 1.0
        # distance to the original polygon's outline, over the window
        edge = polyline_window(outline, (H, W), (y0, y1, x0, x1))
        dist = distance_transform(1 - edge)
        ramp = np.clip(1.0 - dist / max(d, 1e-6), 0.0, 1.0) * band
        np.maximum(thresh_canvas[y0:y1, x0:x1], ramp,
                   out=thresh_canvas[y0:y1, x0:x1])
    gt_thresh = (thresh_min
                 + (thresh_max - thresh_min) * thresh_canvas)[..., None]
    return {"gt_prob": gt_prob, "gt_thresh": gt_thresh.astype(np.float32),
            "thresh_mask": thresh_mask}
