"""FocalNet encoder for variable-width text crops, with masking (port of
`advancedliteratemachinery_tpu/models/focalnet.py`; reference LISTER
OCR/LISTER/model/feature_extractor.py: MaskedConv2d :26, FocalModulation
:62, FocalNetBlock :142, Stem :307, FocalNet :388; focalnet_tiny_lrf :519
[E=64, depths 2,2,6,2], focalnet_base_lrf :539 [E=96, depths 2,2,9,2]).

Maps are NHWC, as in the JAX package; each conv reads them as NCHW views
in `channels_last` memory. A [B, H, W] 0/1 mask (1 = valid) travels with
the map: every conv zeroes the padded positions first and max-pools the
mask down to its output. Submodules carry the flax names (a MaskedConv's
conv is `Conv_0`), so `engine/convert.py` maps a flax tree onto them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy, gelu)
from advancedliteratemachinery_tpu_torch.models.layers import (
    LN_EPS, conv2d, init_params, layer_norm, linear)


def downsample_mask(mask: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """Max-pool a [B, H, W] 0/1 mask to `out_hw` (integer strides)."""
    B, H, W = mask.shape
    oh, ow = out_hw
    if (H, W) == (oh, ow):
        return mask
    s = (H // oh, W // ow)
    return F.max_pool2d(mask[:, None], s, s)[:, 0]


def _conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype
               ) -> torch.Tensor:
    return conv2d(x.permute(0, 3, 1, 2), conv, dtype).permute(0, 2, 3, 1)


class MaskedConv(nn.Module):
    """Zero the padded positions, convolve with torch-style symmetric
    padding ((k - 1) // 2 a side), pool the mask to the output."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), groups: int = 1,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        kh, kw = kernel_size
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel_size, strides,
                                ((kh - 1) // 2, (kw - 1) // 2), groups=groups)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        x = x * mask[..., None].to(x.dtype)
        x = _conv_nhwc(x, self.Conv_0, self.policy.compute_dtype)
        return x, downsample_mask(mask, (x.shape[1], x.shape[2]))


class Stem(nn.Module):
    """4x spatial reduction stem (feature_extractor.py:307)."""

    def __init__(self, in_chans: int, embed_dim: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.conv0 = MaskedConv(in_chans, 32, (3, 3), policy=policy)
        self.norm0 = nn.LayerNorm(32, eps=LN_EPS)
        self.conv1_0 = MaskedConv(32, 32, (5, 5), (2, 2), 32, policy)
        self.norm1 = nn.LayerNorm(32, eps=LN_EPS)
        self.conv1_1 = MaskedConv(32, 64, (1, 1), policy=policy)
        self.conv2_0 = MaskedConv(64, 64, (5, 5), (2, 2), 64, policy)
        self.norm2 = nn.LayerNorm(64, eps=LN_EPS)
        self.conv2_1 = MaskedConv(64, embed_dim, (1, 1), policy=policy)
        self.conv3 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        c = self.policy.compute_dtype
        x, mask = self.conv0(x, mask)
        x = layer_norm(x, self.norm0, c)
        x, mask = self.conv1_0(x, mask)
        x = layer_norm(x, self.norm1, c)
        x, mask = self.conv1_1(x, mask)
        x, mask = self.conv2_0(gelu(x), mask)
        x = layer_norm(x, self.norm2, c)
        x, mask = self.conv2_1(x, mask)
        return linear(gelu(x), self.conv3, c), mask


class FocalModulation(nn.Module):
    """Focal modulation with masking (feature_extractor.py:62): depthwise
    (min(k, max_kh), k) convs, k = 3, 5, 7, gated and summed, plus a
    masked global context."""

    def __init__(self, dim: int, focal_window: int = 3, focal_level: int = 3,
                 max_kh: int = 1, focal_factor: int = 2,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.dim, self.focal_level = dim, focal_level
        self.f = nn.Linear(dim, 2 * dim + focal_level + 1)
        for level in range(focal_level):
            k = focal_factor * level + focal_window
            self.add_module(f"focal_{level}", nn.Conv2d(
                dim, dim, (min(k, max_kh), k), padding="same", groups=dim,
                bias=False))
        self.h = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        L = self.focal_level
        m = mask[..., None].to(x.dtype)
        f = linear(x, self.f, c) * m
        C = self.dim
        q, ctx, gates = f.split([C, C, L + 1], dim=-1)
        ctx_all = torch.zeros_like(q)
        for level in range(L):
            ctx = gelu(_conv_nhwc(ctx, getattr(self, f"focal_{level}"), c)) * m
            ctx_all = ctx_all + ctx * gates[..., level:level + 1]
        denom = m.sum((1, 2), keepdim=True) + 1e-10
        ctx_global = gelu(ctx.sum((1, 2), keepdim=True) / denom)
        ctx_all = ctx_all + ctx_global * gates[..., L:L + 1]
        out = q * linear(ctx_all, self.h, c)
        return linear(out, self.proj, c) * m


class FocalNetBlock(nn.Module):
    """Pre-LN focal block with layerscale (feature_extractor.py:142); eval
    only, so no stochastic depth until the port trains LISTER."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 focal_level: int = 3, focal_window: int = 3,
                 max_kh: int = 1,
                 layerscale_value: float = 1e-4,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.gamma_1 = nn.Parameter(torch.full((dim,), layerscale_value))
        self.gamma_2 = nn.Parameter(torch.full((dim,), layerscale_value))
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.modulation = FocalModulation(dim, focal_window, focal_level,
                                          max_kh, policy=policy)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        h = self.modulation(layer_norm(x, self.norm1, c), mask)
        x = x + h * self.gamma_1
        h = linear(layer_norm(x, self.norm2, c), self.mlp_fc1, c)
        h = linear(gelu(h), self.mlp_fc2, c)
        x = x + h * self.gamma_2
        return x * mask[..., None].to(x.dtype)


@dataclasses.dataclass(frozen=True)
class FocalNetConfig:
    in_chans: int = 3
    embed_dim: int = 96                      # base; tiny = 64
    depths: Tuple[int, ...] = (2, 2, 9, 2)   # base; tiny = (2, 2, 6, 2)
    focal_levels: Tuple[int, ...] = (3, 3, 3, 3)
    focal_windows: Tuple[int, ...] = (3, 3, 3, 3)
    mlp_ratio: float = 4.0
    layerscale_value: float = 1e-6
    h_fm: int = 1                            # final feature-map height

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2 ** i)
                     for i in range(len(self.depths)))

    @property
    def out_dim(self) -> int:
        return self.stage_dims[-1]

    @property
    def strides(self) -> Tuple[int, ...]:
        """Inter-stage height strides (the width stride is always 1): H/4
        after the stem, so h_fm=1 takes (2, 2, 2)."""
        n_skip = int(math.log2(self.h_fm))
        return tuple([2] * (3 - n_skip) + [1] * n_skip)

    @property
    def max_khs(self) -> Tuple[int, ...]:
        if self.h_fm == 8:
            return (7, 7, 7, 7)
        if self.h_fm == 4:
            return (7, 3, 3, 3)
        return (7, 3, 3, 1)


FOCALNET_VARIANTS = {
    "tiny": FocalNetConfig(embed_dim=64, depths=(2, 2, 6, 2)),
    "base": FocalNetConfig(embed_dim=96, depths=(2, 2, 9, 2)),
}


class FocalNet(nn.Module):
    """Built on `device` (the GPU unless `device="cpu"`) with random
    weights from `seed` (flax's defaults; gammas at `layerscale_value`), in
    eval mode (no stochastic depth), as the JAX module runs by default;
    load real weights with `engine.checkpoint.import_focalnet` or
    `engine.convert`."""

    def __init__(self, config: FocalNetConfig = FOCALNET_VARIANTS["base"],
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.policy = policy
        dims = cfg.stage_dims
        self.stem = Stem(cfg.in_chans, dims[0], policy)
        self.stem_norm = nn.LayerNorm(dims[0], eps=LN_EPS)
        for s, depth in enumerate(cfg.depths):
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", FocalNetBlock(
                    dims[s], cfg.mlp_ratio, cfg.focal_levels[s],
                    cfg.focal_windows[s], cfg.max_khs[s],
                    cfg.layerscale_value, policy=policy))
            if s < len(cfg.depths) - 1:
                stride = cfg.strides[s]
                kh = min(cfg.max_khs[s] if cfg.max_khs[s] > 3 else 2, 3)
                if stride == 1:
                    kh = max(3, kh)
                self.add_module(f"downsample{s}", MaskedConv(
                    dims[s], dims[s + 1], (kh, 3), (stride, 1),
                    policy=policy))
                self.add_module(f"ds_norm{s}",
                                nn.LayerNorm(dims[s + 1], eps=LN_EPS))
        self.norm = nn.LayerNorm(dims[-1], eps=LN_EPS)
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(device).eval()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """x [B, H, W, C] (H=32 typical), mask [B, H, W] 0/1 (1 = valid) →
        (features [B, h_fm, W/4, out_dim], mask [B, h_fm, W/4])."""
        cfg = self.config
        c = self.policy.compute_dtype
        if mask is None:
            mask = torch.ones(x.shape[:3], device=x.device)
        x, mask = self.stem(x.to(c), mask.float())
        x = layer_norm(x, self.stem_norm, c)
        for s, depth in enumerate(cfg.depths):
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x, mask)
            if s < len(cfg.depths) - 1:
                x, mask = getattr(self, f"downsample{s}")(x, mask)
                x = layer_norm(x, getattr(self, f"ds_norm{s}"), c)
        x = layer_norm(x, self.norm, c)
        return x * mask[..., None].to(x.dtype), mask

