"""Shared transformer building blocks (port of
`advancedliteratemachinery_tpu/models/layers.py`).

Submodule and parameter names follow the JAX package's flax names, so
`engine/convert.py` maps a flax parameter tree onto them one to one. Every
op casts its input and weights to the policy's compute dtype; LayerNorms run
in float32 with flax's epsilon (1e-6, not torch's 1e-5). Dropout and
DropPath are identities at inference and are not modelled.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy, gelu)
from advancedliteratemachinery_tpu_torch.ops.attention import (
    fused_qkv_attention)

LN_EPS = 1e-6   # flax nn.LayerNorm default


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal (±2σ) with variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random init with flax's defaults, drawn from `generator`: lecun-normal
    kernels, zero biases, unit norm scales, N(0, 0.02) truncated cls and
    position embeddings."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":        # GroupedPointwise [G, D/G, O/G]
            lecun_normal_(p, p.shape[0] * p.shape[1], generator)
        elif leaf in ("cls_token", "pos_embed"):
            with torch.no_grad():
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04,
                                      generator=generator)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax Dense(dtype=...): input, kernel and bias in `dtype`."""
    b = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype
               ) -> torch.Tensor:
    """flax LayerNorm(dtype=float32) followed by a cast to `dtype`.

    When the input and the norm's parameters share a dtype (bf16 in the
    inference engine) torch's own kernel computes the same thing in one
    pass: float32 statistics and arithmetic, one rounding on the way out.
    Otherwise the input and parameters are upcast first."""
    if x.dtype == ln.weight.dtype:
        return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias,
                            ln.eps).to(dtype)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        return linear(gelu(linear(x, self.fc1, c)), self.fc2, c)


class MultiHeadSelfAttention(nn.Module):
    """One fused qkv projection; with no mask the attention itself is the
    fused kernel (`ops/attention.py`), reading the projection output in its
    [B, N, 3D] q|k|v layout."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        hd = D // H
        c = self.policy.compute_dtype
        qkv = linear(x, self.qkv, c)
        if mask is None:
            out = fused_qkv_attention(qkv, H,
                                      safe=not self.policy.unsafe_softmax)
        else:
            q, k, v = qkv.reshape(B, N, 3, H, hd).unbind(2)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
            s = s.float().masked_fill(~mask, torch.finfo(torch.float32).min)
            a = torch.softmax(s, dim=-1).to(q.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, N, D)
        return linear(out, self.proj, c)


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block (ViT style)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadSelfAttention(dim, num_heads, qkv_bias, policy)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, policy)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        c = self.policy.compute_dtype
        x = x + self.attn(layer_norm(x, self.norm1, c), mask)
        return x + self.mlp(layer_norm(x, self.norm2, c))


class PatchEmbed(nn.Module):
    """Image → patch tokens via one strided conv."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] (NHWC, as the JAX package) → [B, H/p·W/p, D]."""
        c = self.policy.compute_dtype
        x = F.conv2d(x.to(c).permute(0, 3, 1, 2), self.proj.weight.to(c),
                     self.proj.bias.to(c), stride=self.proj.stride)
        return x.flatten(2).transpose(1, 2)
