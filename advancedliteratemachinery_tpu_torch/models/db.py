"""DB (Differentiable Binarization) text detector, inference path (port of
`advancedliteratemachinery_tpu/models/db.py` `DBDetector`).

ResNet-18 backbone → FPN → per-level laterals concatenated at 1/4 →
probability head (conv3x3+BN+relu → 1x1 conv + pixel shuffle + BN + relu →
1x1 conv + pixel shuffle → sigmoid). Only the probability head is built:
the threshold head exists for training. The JAX package's space-to-depth
stem is a TPU rewrite of an ordinary 7x7 stride-2 convolution over the same
(7, 7, C, F) kernel, and is one `conv2d` here. Pages come in NHWC, as in the
JAX package, and the network runs in NCHW inside.

`make_db_detect_fn` is the document pipelines' detect function (the JAX
CLI's `_db_detect_fn`) with one departure: the JAX CLI extracts boxes on
the host with cv2 contours (`extract_boxes`), which the card's machine
cannot run, so this one takes `ops/cc_extract.py` `extract_boxes_device`,
the JAX package's own device path, with no cap on the boxes (as
`extract_boxes` has none). The two give different box sets where
components spiral (see `ops/cc_extract.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.models.layers import (
    BN_EPS, batch_norm, conv2d, init_params)
from advancedliteratemachinery_tpu_torch.ops.cc_extract import (
    extract_boxes_device)
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


class DBDetector(nn.Module):
    """Built on `device` (the GPU unless `device="cpu"`), with random weights
    from `seed`; load real weights with `engine.convert`."""

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
        self.prob_c = ConvBNRelu(4 * cfg.head_dim, cfg.head_dim, policy=p)
        self.prob_up1 = nn.Conv2d(cfg.head_dim, 4 * cfg.head_dim, 1)
        self.prob_bn1 = nn.BatchNorm2d(cfg.head_dim, eps=BN_EPS)
        self.prob_up2 = nn.Conv2d(cfg.head_dim, 4, 1)
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] (H, W multiples of 32) → {"prob": [B, H, W, 1]
        float32}."""
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
        h = self.prob_c(torch.cat(outs, dim=1))          # [B, 4*hd, H/4, W/4]
        h = F.pixel_shuffle(conv2d(h, self.prob_up1, c), 2)        # 1/4 → 1/2
        h = F.relu(batch_norm(h, self.prob_bn1).to(c))
        h = F.pixel_shuffle(conv2d(h, self.prob_up2, c), 2)       # full, 1ch
        return {"prob": torch.sigmoid(h.float()).permute(0, 2, 3, 1)}


# the detect function's page size (h, w), the JAX CLI's
DETECT_HW = (640, 640)


def make_db_detect_fn(model: DBDetector, box_thresh: float = 0.3):
    """→ detect_fn(image_u8) for `pipelines.modules.TextDetection`: the page
    resized to DETECT_HW on the model's device (cv2's INTER_LINEAR),
    scaled to [0, 1] in float32 → the probability map →
    `extract_boxes_device` (every component) → (quads [N, 8]
    float32 in page pixels, scores [N] float32), by score descending."""
    device = next(model.parameters()).device
    H, W = DETECT_HW

    @torch.inference_mode()
    def detect(image_u8):
        page = as_device_tensor(image_u8, device)
        h, w = page.shape[:2]
        x = resize_linear_u8(page[None], (H, W)).float() / 255.0
        prob = model(x)["prob"][..., 0]
        quads, scores, valid = extract_boxes_device(
            prob, box_thresh=box_thresh, max_boxes=None)
        keep = valid[0]
        quads = quads[0][keep].reshape(-1, 8).cpu().numpy()
        scores = scores[0][keep].cpu().numpy()
        quads = quads * np.tile([w / W, h / H], 4)
        return quads.astype(np.float32), scores.astype(np.float32)

    return detect
