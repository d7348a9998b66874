"""Vision Transformer backbone (port of
`advancedliteratemachinery_tpu/models/vit.py`).

timm `VisionTransformer` as MGP-STR uses it: patch 4 on 32x128 crops, a cls
token, learned position embeddings, pre-LN blocks, and no final norm
(`apply_final_norm=False`, as MGP-STR's forward_features).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.models.layers import (
    LN_EPS, Dropout, EncoderBlock, PatchEmbed, layer_norm)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: Tuple[int, int] = (32, 128)
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    dropout: float = 0.0        # after the position embedding, the attention
    #                             projection and in each MLP
    attn_dropout: float = 0.0   # carried for parity: as in the JAX package,
    #                             no dropout touches the attention probabilities
    drop_path: float = 0.0      # stochastic depth on every residual branch
    use_cls_token: bool = True
    apply_final_norm: bool = False

    @property
    def num_patches(self) -> int:
        return ((self.img_size[0] // self.patch_size)
                * (self.img_size[1] // self.patch_size))

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)


VIT_VARIANTS = {
    "tiny": ViTConfig(embed_dim=192, depth=12, num_heads=3),
    "small": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "base": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "large": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
}


class VisionTransformer(nn.Module):
    def __init__(self, config: ViTConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = self.config = config
        self.policy = policy
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans,
                                      cfg.embed_dim, policy)
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.seq_len, cfg.embed_dim))
        # flax names (blocks_0, ...) so parameter trees map one to one
        for i in range(cfg.depth):
            self.add_module(f"blocks_{i}", EncoderBlock(
                cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                cfg.dropout, cfg.drop_path, policy))
        self.pos_drop = Dropout(cfg.dropout)
        if cfg.apply_final_norm:
            self.norm = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, H, W, C] → token features [B, seq_len, D] (compute dtype).
        `generator` feeds dropout and stochastic depth in `train()` mode."""
        cfg = self.config
        c = self.policy.compute_dtype
        x = self.patch_embed(x.to(c))
        if cfg.use_cls_token:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x], dim=1)
        x = self.pos_drop(x + self.pos_embed.to(x.dtype), generator)
        for i in range(cfg.depth):
            x = getattr(self, f"blocks_{i}")(x, generator=generator)
        if cfg.apply_final_norm:
            x = layer_norm(x, self.norm, c)
        return x
