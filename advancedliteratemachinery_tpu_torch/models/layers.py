"""Shared transformer building blocks (port of
`advancedliteratemachinery_tpu/models/layers.py`).

Submodule and parameter names follow the JAX package's flax names, so
`engine/convert.py` maps a flax parameter tree onto them one to one. Every
op casts its input and weights to the policy's compute dtype; LayerNorms run
in float32 with flax's epsilon (1e-6, not torch's 1e-5). Dropout and
DropPath act only in `train()` mode at a rate above 0, drawing their masks
from the `torch.Generator` the caller passes down the forward; otherwise
they are identities.
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
    attention, fused_qkv_attention, supports_fused_qkv)

LN_EPS = 1e-6   # flax nn.LayerNorm default
BN_EPS = 1e-5   # flax nn.BatchNorm default


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


def cast_matmul_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every Linear and conv of `model` to `dtype` in place, once: the
    value `linear` and `conv2d` cast their weights to on every call anyway
    (flax Dense and Conv with `dtype`). Norms, embeddings and other tables
    keep float32, as the JAX engines keep them."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.to(dtype)
    return model


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype
           ) -> torch.Tensor:
    """flax Conv(dtype=...): input, kernel and bias in `dtype` (NCHW)."""
    b = conv.bias.to(dtype) if conv.bias is not None else None
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), b, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm in float32 on running statistics (NCHW)."""
    return F.batch_norm(x.float(), bn.running_mean.float(),
                        bn.running_var.float(), bn.weight.float(),
                        bn.bias.float(), False, 0.0, bn.eps)


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


def _keep(x: torch.Tensor, rate: float, shape,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's `select(bernoulli(keep), x / keep, 0)` with the mask drawn from
    `generator` over `shape` (broadcast against x)."""
    if generator is None:
        raise ValueError("Dropout/DropPath in train mode at a rate above 0 "
                         "need a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Elementwise dropout (flax `nn.Dropout`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        return _keep(x, self.rate, x.shape, generator)


class DropPath(nn.Module):
    """Stochastic depth: drops whole samples (the JAX `DropPath`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        return _keep(x, self.rate, (x.shape[0],) + (1,) * (x.ndim - 1),
                     generator)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int,
                 dropout: float = 0.0, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.policy.compute_dtype
        x = self.drop(gelu(linear(x, self.fc1, c)), generator)
        return self.drop(linear(x, self.fc2, c), generator)


class MultiHeadSelfAttention(nn.Module):
    """One fused qkv projection. With no mask, and where
    `supports_fused_qkv` passes (CUDA, bf16, head dim 64, 8 ≤ N ≤ 768), the
    attention itself is the fused kernel (`ops/attention.py`), reading the
    projection output in its [B, N, 3D] q|k|v layout and differentiable
    through its backward kernel; otherwise (a mask, the CPU, f32, another
    head dim, N < 8 or N > 768) it is the plain `attention` on q, k, v, as
    the JAX module's einsum branch. `proj_dropout` follows the output
    projection; as in the JAX package the attention probabilities
    themselves are never dropped."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_dropout: float = 0.0, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        c = self.policy.compute_dtype
        qkv = linear(x, self.qkv, c)
        if mask is None and supports_fused_qkv(N, D, H, qkv.dtype,
                                               qkv.device):
            out = fused_qkv_attention(qkv, H,
                                      safe=not self.policy.unsafe_softmax)
        else:
            q, k, v = qkv.reshape(B, N, 3, H, D // H).unbind(2)
            out = attention(q, k, v, mask).reshape(B, N, D)
        return self.proj_drop(linear(out, self.proj, c), generator)


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block (ViT style), with the JAX block's
    dropout (after the attention projection and in the MLP) and stochastic
    depth on both residual branches."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dropout: float = 0.0,
                 drop_path: float = 0.0, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadSelfAttention(dim, num_heads, qkv_bias, dropout,
                                           policy)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dropout, policy)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = self.policy.compute_dtype
        h = self.attn(layer_norm(x, self.norm1, c), mask, generator)
        x = x + self.drop_path1(h, generator)
        h = self.mlp(layer_norm(x, self.norm2, c), generator)
        return x + self.drop_path2(h, generator)


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
