"""Swin Transformer backbone (windowed attention), NHWC, mask-aware (port of
`advancedliteratemachinery_tpu/models/swin.py`; reference
OCR/OmniParser/model/backbone/swin_transformer.py, built as swin_base at
backbone/__init__.py:19 — embed 128, depths (2,2,18,2), heads (4,8,16,32),
window 7; returns the 4 stage feature maps for the FPN).

Maps stay NHWC, as in the JAX package, so PatchMerging's concatenation
order ([0::2,0::2], [1::2,0::2], [0::2,1::2], [1::2,1::2]) and with it the
`reduction` weight's row order are the JAX package's. Window attention
rounds as the JAX einsum: Q·Kᵀ in the compute dtype, times hd^-0.5, the
relative-position bias (and the shift mask) cast to it and added, softmax
in float32, cast back before P·V. LayerNorms run in float32 with flax's
epsilon. The stage masks are nearest resizes with half-pixel centres, as
`jax.image.resize(..., "nearest")` (torch's "nearest-exact"). Submodules
carry the flax names, so `engine/convert.py` maps a flax tree onto them.
Inference only: the modules hold no stochastic depth.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy, gelu)
from advancedliteratemachinery_tpu_torch.models.layers import (
    LN_EPS, layer_norm, linear)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] → [B*nH*nW, w*w, C] (H, W divisible by w)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_reverse(windows: torch.Tensor, w: int, H: int, W: int
                   ) -> torch.Tensor:
    B = windows.shape[0] // ((H // w) * (W // w))
    x = windows.reshape(B, H // w, W // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(w: int) -> np.ndarray:
    """Standard Swin relative-position index table for a w x w window."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)  # [w*w, w*w]


def shift_attn_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """Additive mask separating the 9 shifted regions (classic Swin), on
    the padded size H x W: [nW, w*w, w*w]."""
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(
        -1, w * w)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(x, ..., "nearest")` of the two axes after the batch
    of an NHW or NHWC tensor: half-pixel centres, torch's
    "nearest-exact" (its default "nearest" picks other rows unless the
    ratio is a power of two)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    if x.ndim == 3:
        return F.interpolate(x[:, None], size=size,
                             mode="nearest-exact")[:, 0]
    return F.interpolate(x.permute(0, 3, 1, 2), size=size,
                         mode="nearest-exact").permute(0, 2, 3, 1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(window_size)).reshape(-1),
            persistent=False)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [nW*B, N, C]; attn_mask [nW, N, N] additive or None."""
        c = self.policy.compute_dtype
        Bn, N, C = x.shape
        H = self.num_heads
        hd = C // H
        q, k, v = linear(x, self.qkv, c).reshape(Bn, N, 3, H, hd).unbind(2)
        bias = self.relative_position_bias_table[self.rel_index].reshape(
            N, N, H).permute(2, 0, 1)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (hd ** -0.5)
        attn = attn + bias[None].to(attn.dtype)
        if attn_mask is not None:
            nW = attn_mask.shape[0]
            attn = attn.reshape(Bn // nW, nW, H, N, N) + \
                attn_mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(Bn, H, N, N)
        attn = torch.softmax(attn.float(), -1).to(q.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(Bn, N, C)
        return linear(out, self.proj, c)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.window_size = window_size
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size, policy)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        # the shift mask on the card, per padded size: a constant of the
        # shape, built once
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _shift_mask(self, Hp: int, Wp: int, device) -> torch.Tensor:
        key = (Hp, Wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_attn_mask(
                Hp, Wp, self.window_size, self.shift)).float().to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        B, H, W, C = x.shape
        w = self.window_size
        pad_b = (w - H % w) % w
        pad_r = (w - W % w) % w
        Hp, Wp = H + pad_b, W + pad_r

        shortcut = x
        h = F.pad(layer_norm(x, self.norm1, c), (0, 0, 0, pad_r, 0, pad_b))
        # no shift when one window covers the padded map
        shift = self.shift if min(Hp, Wp) > w else 0
        amask = None
        if shift > 0:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
            amask = self._shift_mask(Hp, Wp, x.device)
        h = window_reverse(self.attn(window_partition(h, w), amask), w, Hp,
                           Wp)
        if shift > 0:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = shortcut + h[:, :H, :W]

        h = layer_norm(x, self.norm2, c)
        h = linear(gelu(linear(h, self.mlp_fc1, c)), self.mlp_fc2, c)
        return x + h


class PatchMerging(nn.Module):
    def __init__(self, dim: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return linear(layer_norm(x, self.norm, c), self.reduction, c)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 128                      # base
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 7
    mlp_ratio: float = 4.0

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2 ** i)
                     for i in range(len(self.depths)))


SWIN_VARIANTS = {
    "tiny": SwinConfig(embed_dim=96, depths=(2, 2, 6, 2),
                       num_heads=(3, 6, 12, 24)),
    "base": SwinConfig(),
}


class SwinTransformer(nn.Module):
    """Returns the 4 stage feature maps (NHWC, each LayerNormed and masked)
    and the per-stage masks. Weights are set by the model that holds it
    (`OmniParser`), by `engine.checkpoint.import_swin` or by
    `engine.convert`."""

    def __init__(self, config: SwinConfig = SwinConfig(),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = self.config = config
        self.policy = policy
        self.patch_embed = nn.Conv2d(cfg.in_chans, cfg.embed_dim,
                                     cfg.patch_size, cfg.patch_size)
        self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        for s, depth in enumerate(cfg.depths):
            dim = cfg.stage_dims[s]
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", SwinBlock(
                    dim, cfg.num_heads[s], cfg.window_size,
                    shift=0 if b % 2 == 0 else cfg.window_size // 2,
                    mlp_ratio=cfg.mlp_ratio, policy=policy))
            # per-stage output norm (OmniParser swin_transformer.py:547-550)
            self.add_module(f"out_norm{s}", nn.LayerNorm(dim, eps=LN_EPS))
            if s < len(cfg.depths) - 1:
                self.add_module(f"merge{s}", PatchMerging(dim, policy))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """x [B, H, W, 3], mask [B, H, W] (1 = valid) → (feats, masks)."""
        cfg = self.config
        c = self.policy.compute_dtype
        B, H, W, _ = x.shape
        if mask is None:
            mask = torch.ones((B, H, W), device=x.device)
        pe = self.patch_embed
        x = F.conv2d(x.to(c).permute(0, 3, 1, 2), pe.weight.to(c),
                     pe.bias.to(c), stride=pe.stride).permute(0, 2, 3, 1)
        x = layer_norm(x, self.patch_norm, c)
        feats, masks = [], []
        for s, depth in enumerate(cfg.depths):
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            xo = layer_norm(x, getattr(self, f"out_norm{s}"), c)
            m = resize_nearest(mask.float(), x.shape[1:3])
            feats.append(xo * m[..., None].to(xo.dtype))
            masks.append(m)
            if s < len(cfg.depths) - 1:
                x = getattr(self, f"merge{s}")(x)
        return feats, masks
