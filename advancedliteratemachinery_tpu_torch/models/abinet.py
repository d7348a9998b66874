"""ABINet vision model: ResNet45, a transformer and position attention
(port of `advancedliteratemachinery_tpu/models/abinet.py`; reference
LevOCR's vendored OCR/LevOCR/abinet: resnet.py:103 resnet45 [BasicBlock,
layers 3,4,6,6,3, strides 2,1,2,1,1: 32x128 in, 8x32x512 out],
backbone.py:13 ResTranformer [3 post-norm layers, d 512, 8 heads, ffn
2048, sincos positions], model_vision.py:23 PositionAttention [a U-Net key
path and learned-position queries, T = max_length], :77 BaseVision).

Images come in NHWC, as in the JAX package, and the maps go out NHWC;
inside, the convs run on NCHW tensors in `channels_last` memory, so the
NHWC views cost no copy. Convs pad symmetrically by (k-1)//2; BatchNorm
runs in eval mode in float32 on running statistics and is then cast to the
compute dtype; LayerNorms run in float32 with flax's epsilon. The nearest
resizes of the key path use half-pixel centres, as `jax.image.resize`
does (torch's "nearest-exact", not its default "nearest"). Submodules carry
the flax names, so `engine/convert.py` maps a flax tree onto them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.models.layers import (
    BN_EPS, LN_EPS, batch_norm, conv2d, init_params, layer_norm, linear)


def sincos_positions(length: int, dim: int) -> np.ndarray:
    """Classic transformer sin/cos table [length, dim]."""
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class ConvBN(nn.Module):
    """conv (no bias) → eval BatchNorm in float32 → cast → ReLU. Padding
    is symmetric (k-1)//2 unless given as (pad_h, pad_w)."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), relu: bool = True,
                 padding: Optional[Tuple[int, int]] = None,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.relu = relu
        if padding is None:
            padding = tuple((k - 1) // 2 for k in kernel)
        self.conv = nn.Conv2d(in_ch, features, kernel, strides, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        x = batch_norm(conv2d(x, self.conv, c), self.bn).to(c)
        return F.relu(x) if self.relu else x


class ResBasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.conv1 = ConvBN(in_ch, planes, (1, 1), policy=policy)
        self.conv2 = ConvBN(planes, planes, (3, 3), (stride, stride),
                            relu=False, policy=policy)
        if stride != 1 or in_ch != planes:
            self.downsample = ConvBN(in_ch, planes, (1, 1), (stride, stride),
                                     relu=False, policy=policy)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + residual)


class ResNet45(nn.Module):
    """resnet.py:50: a stem conv and 5 stages [3, 4, 6, 6, 3], planes
    w, 2w, 4w, 8w, 16w (w = out_dim / 16), strides 2, 1, 2, 1, 1."""

    PLAN = ((1, 3, 2), (2, 4, 1), (4, 6, 2), (8, 6, 1), (16, 3, 1))

    def __init__(self, out_dim: int = 512, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        w = out_dim // 16
        self.stem = ConvBN(3, w, (3, 3), policy=policy)
        self.blocks = []
        ci = w
        for s, (mult, blocks, stride) in enumerate(self.PLAN):
            for b in range(blocks):
                blk = ResBasicBlock(ci, mult * w, stride if b == 0 else 1,
                                    policy)
                setattr(self, f"layer{s}_block{b}", blk)
                self.blocks.append(blk)
                ci = mult * w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x NCHW → NCHW [B, out_dim, H/4, W/4]."""
        x = self.stem(x.to(self.policy.compute_dtype))
        for blk in self.blocks:
            x = blk(x)
        return x


class ABINetEncoderLayer(nn.Module):
    """Post-norm, as torch's nn.TransformerEncoderLayer. The attention
    rounds as `jax.nn.dot_product_attention`: float32 logits from the
    compute-dtype q and k, scaled in float32, softmax in float32,
    probabilities cast to the compute dtype, then P·V."""

    def __init__(self, dim: int = 512, heads: int = 8, ffn: int = 2048,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff1 = nn.Linear(dim, ffn)
        self.ff2 = nn.Linear(ffn, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        B, T, C = x.shape
        hd = C // self.heads
        q, k, v = linear(x, self.qkv, c).view(B, T, 3, self.heads,
                                              hd).unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        a = torch.softmax(s * hd ** -0.5, dim=-1).to(c)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, C)
        x = layer_norm(x + linear(o, self.proj, c), self.norm1, c)
        h = linear(F.relu(linear(x, self.ff1, c)), self.ff2, c)
        return layer_norm(x + h, self.norm2, c)


class PositionAttention(nn.Module):
    """model_vision.py:23: a U-Net refines the keys (encoder strides
    (1,2), (2,2), (2,2), (2,2); a mirrored decoder of nearest resizes and
    convs with skip sums; a last conv back to `in_channels`), and
    `max_length` learned-position queries read T character vectors out of
    the map. The scores round as the JAX einsum: Q·Kᵀ in the compute
    dtype, divided by √E there, softmax in float32, cast back."""

    def __init__(self, max_length: int, in_channels: int = 512,
                 num_channels: int = 64, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.max_length = max_length
        ci = in_channels
        for i, s in enumerate(((1, 2), (2, 2), (2, 2), (2, 2))):
            setattr(self, f"k_enc{i}", ConvBN(ci, num_channels, (3, 3), s,
                                              policy=policy))
            ci = num_channels
        for i in range(3):
            setattr(self, f"k_dec{i}", ConvBN(num_channels, num_channels,
                                              policy=policy))
        self.k_dec3 = ConvBN(num_channels, in_channels, policy=policy)
        self.project = nn.Linear(in_channels, in_channels)
        self.register_buffer(
            "pos", torch.from_numpy(sincos_positions(max_length,
                                                     in_channels)),
            persistent=False)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x NCHW [B, E, H, W] → (vecs [B, T, E], attn [B, T, H, W])."""
        c = self.policy.compute_dtype
        B, E, H, W = x.shape
        k = x
        feats = []
        for i in range(4):
            k = getattr(self, f"k_enc{i}")(k)
            feats.append(k)
        for i in range(3):
            tgt = feats[2 - i]
            k = F.interpolate(k, size=tgt.shape[2:], mode="nearest-exact")
            k = getattr(self, f"k_dec{i}")(k) + tgt
        k = F.interpolate(k, size=(H, W), mode="nearest-exact")
        k = self.k_dec3(k)                                   # [B, E, H, W]

        q = linear(self.pos.to(c), self.project, c)         # [T, E]
        scores = torch.einsum("te,behw->bthw", q, k).reshape(
            B, self.max_length, H * W) / E ** 0.5
        attn = torch.softmax(scores.float(), dim=-1).to(c)
        v = x.permute(0, 2, 3, 1).reshape(B, H * W, E)
        vecs = torch.bmm(attn, v)
        return vecs, attn.reshape(B, self.max_length, H, W)


@dataclasses.dataclass(frozen=True)
class ABINetVisionConfig:
    max_length: int = 26          # batch_max_length (25) + 1 end token
    num_classes: int = 37         # charset36 + null
    d_model: int = 512
    backbone_layers: int = 3
    ffn: int = 2048               # d_inner (backbone.py:10)


class ABINetVision(nn.Module):
    """BaseVision (model_vision.py:77): ResNet45 → transformer layers →
    position attention → a linear classifier. Built on `device` (the GPU
    unless `device="cpu"`) with random weights from `seed`; load real
    weights with `engine.checkpoint.import_abinet_vision` or
    `engine.convert`."""

    def __init__(self, config: ABINetVisionConfig = ABINetVisionConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.policy = policy
        self.resnet = ResNet45(cfg.d_model, policy)
        self.tfm = []
        for i in range(cfg.backbone_layers):
            layer = ABINetEncoderLayer(cfg.d_model, ffn=cfg.ffn,
                                       policy=policy)
            setattr(self, f"tfm{i}", layer)
            self.tfm.append(layer)
        self.attention = PositionAttention(cfg.max_length, cfg.d_model,
                                           policy=policy)
        self.cls = nn.Linear(cfg.d_model, cfg.num_classes)
        self._pe: Dict[tuple, torch.Tensor] = {}   # sincos tables by shape
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(device).eval()

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images NHWC [B, H, W, 3] → feature [B, T, E], logits [B, T,
        classes] float32, features NHWC [B, H/4, W/4, E], attn_scores
        [B, T, H/4, W/4]."""
        c = self.policy.compute_dtype
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.resnet(x)
        B, C, H, W = x.shape
        key = (H * W, C, x.device, c)
        if key not in self._pe:
            self._pe[key] = torch.from_numpy(
                sincos_positions(H * W, C)).to(x.device, c)
        seq = x.permute(0, 2, 3, 1).reshape(B, H * W, C) + self._pe[key]
        for layer in self.tfm:
            seq = layer(seq)
        fmap = seq.reshape(B, H, W, C)
        vecs, attn = self.attention(fmap.permute(0, 3, 1, 2))
        logits = linear(vecs, self.cls, c).float()
        return {"feature": vecs, "logits": logits, "features": fmap,
                "attn_scores": attn}
