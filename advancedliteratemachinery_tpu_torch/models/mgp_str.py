"""MGP-STR scene-text recognizer (port of
`advancedliteratemachinery_tpu/models/mgp_str.py`).

ViT backbone on 32x128 crops (257 tokens with cls), then per granularity
(char, BPE, WordPiece) an A³ TokenLearner — LayerNorm → grouped 1x1 conv
(groups=8) → 1x1 conv to T tokens → softmax over the 257 spatial tokens →
weighted sum of a grouped-conv projection → LayerNorm — and a linear head.
Head widths are padded to a multiple of 128; padded columns are masked at
decode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.models.layers import (
    LN_EPS, init_params, layer_norm, linear)
from advancedliteratemachinery_tpu_torch.models.vit import (
    VIT_VARIANTS, ViTConfig, VisionTransformer)

GPT2_VOCAB_SIZE = 50257
BERT_VOCAB_SIZE = 30522


class GroupedPointwise(nn.Module):
    """Grouped 1x1 conv over the channels of [B, S, D] as a block-diagonal
    einsum; the kernel keeps the JAX layout [G, D/G, O/G]."""

    def __init__(self, dim: int, out_dim: int, groups: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        if dim % groups or out_dim % groups:
            raise ValueError(f"dims {dim}->{out_dim} not divisible by groups "
                             f"{groups}")
        self.policy = policy
        self.groups = groups
        self.kernel = nn.Parameter(
            torch.zeros(groups, dim // groups, out_dim // groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        G = self.groups
        c = self.policy.compute_dtype
        xg = x.reshape(B, S, G, D // G).to(c)
        out = torch.einsum("bsgi,gio->bsgo", xg, self.kernel.to(c))
        return out.reshape(B, S, -1)


class TokenLearner(nn.Module):
    """A³ attention aggregation. Returns (attn [B, T, S], tokens [B, T, D])."""

    def __init__(self, dim: int, out_tokens: int, groups: int = 8,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.token_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.select_group = GroupedPointwise(dim, dim, groups, policy)
        self.select_proj = nn.Linear(dim, out_tokens, bias=False)
        self.feat = GroupedPointwise(dim, dim, groups, policy)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor):
        c = self.policy.compute_dtype
        x = layer_norm(x, self.token_norm, c)
        sel = linear(self.select_group(x), self.select_proj, c)   # [B, S, T]
        attn = torch.softmax(sel.float(), dim=1)    # over the spatial axis
        feat = self.feat(x)
        tokens = torch.einsum("bst,bsd->btd", attn.to(c), feat)
        tokens = layer_norm(tokens, self.norm, c)
        return attn.transpose(1, 2), tokens


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MGPSTRConfig:
    variant: str = "base"
    batch_max_length: int = 25     # chars; +2 specials → 27 output tokens
    num_char_classes: int = 38     # [GO] + [s] + 36 lowercase alnum
    bpe_vocab_size: int = GPT2_VOCAB_SIZE
    wp_vocab_size: int = BERT_VOCAB_SIZE
    vocab_pad_multiple: int = 128
    drop_path: float = 0.0            # the named variant's stochastic depth
    vit: Optional[ViTConfig] = None   # explicit backbone (None → variant)
    heads: tuple = ("char", "bpe", "wp")

    @property
    def max_tokens(self) -> int:
        return self.batch_max_length + 2

    def padded_vocab(self, true_size: int) -> int:
        return _round_up(true_size, self.vocab_pad_multiple)

    def vit_config(self) -> ViTConfig:
        if self.vit is not None:
            return self.vit
        return dataclasses.replace(VIT_VARIANTS[self.variant],
                                   drop_path=self.drop_path)

    def head_sizes(self) -> Dict[str, int]:
        """Output width of each built head (char unpadded, as the JAX
        model)."""
        all_heads = {"char": self.num_char_classes,
                     "bpe": self.padded_vocab(self.bpe_vocab_size),
                     "wp": self.padded_vocab(self.wp_vocab_size)}
        return {n: all_heads[n] for n in self.heads}


class MGPSTR(nn.Module):
    """Built on `device` (the GPU unless `device="cpu"`), with random weights
    from `seed`; load real weights with `engine.convert`."""

    def __init__(self, config: MGPSTRConfig = MGPSTRConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.policy = policy
        vit = config.vit_config()
        self.encoder = VisionTransformer(vit, policy)
        for name, vocab in config.head_sizes().items():
            self.add_module(f"{name}_token_learner", TokenLearner(
                vit.embed_dim, config.max_tokens, policy=policy))
            self.add_module(f"{name}_head", nn.Linear(vit.embed_dim, vocab))
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def forward(self, images: torch.Tensor, return_attn: bool = False,
                decode_tokens: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """images [B, 32, 128, 3] normalized to [-1, 1] → logits per head
        (output dtype, padded widths; the train path), or with
        `decode_tokens=True` the post-TokenLearner tokens [B, T, D] per
        head, for the fused vocab decode. `generator` feeds the encoder's
        dropout and stochastic depth in `train()` mode."""
        c = self.policy.compute_dtype
        feats = self.encoder(images, generator)
        out: Dict[str, torch.Tensor] = {}
        for name in self.config.heads:
            attn, tokens = getattr(self, f"{name}_token_learner")(feats)
            if decode_tokens:
                out[name] = tokens
            else:
                logits = linear(tokens, getattr(self, f"{name}_head"), c)
                out[name] = logits.to(self.policy.output_dtype)
            if return_attn:
                out[f"{name}_attn"] = attn
        return out
