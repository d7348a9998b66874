"""LISTER, the length-insensitive scene-text recognizer, inference path
(port of `advancedliteratemachinery_tpu/models/lister.py`; reference
OCR/LISTER/model).

- NeighborDecoder (nb_decoder.py:98): a global query finds the first
  character on the feature map; a bilinear "neighbor navigator"
  (nb_decoder.py:24) builds an (N+1) x (N+1) transition matrix whose last
  row, the EOS slot, is absorbing; `align_chars` (nb_decoder.py:132) walks
  it from the start map. The walk is `max_ch` steps long whatever the data,
  as the JAX `lax.scan`: a step records whether its lane had finished
  (EOS probability above 0.6) before it, and finished lanes go on walking,
  masked. Each step sharpens with softmax_m1(x · min(1 + 2i, 16))
  (nb_decoder.py:163-169), the eval walk.
- With `iters > 0`, the FEM refinement: a windowed self-attention over the
  decoded character features (la_utils.py:109) and FocalNet blocks merge
  them back into the visual map (nb_decoder.py:49), which is decoded again.

Masked logits are -1e30 in float32 before each softmax. Submodules carry
the flax names. Training (the soft walk, `detach_grad`, `lister_losses`)
is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy, gelu)
from advancedliteratemachinery_tpu_torch.core.registry import MODELS
from advancedliteratemachinery_tpu_torch.models.focalnet import (
    FOCALNET_VARIANTS, FocalNet, FocalNetBlock, FocalNetConfig)
from advancedliteratemachinery_tpu_torch.models.layers import (
    LN_EPS, init_params, layer_norm, linear)

NEG_INF = -1e30
P_THRESHOLD = 0.6     # a walk ends once its EOS probability passes this


def softmax_m1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """(exp(x) - 1) / (sum(exp(x) - 1) + 1e-10) for x >= 0
    (nb_decoder.py:17)."""
    fx = torch.expm1(x)
    return fx / (fx.sum(dim, keepdim=True) + 1e-10)


class BilinearNavigator(nn.Module):
    """y[b, i, j] = q[b, i]ᵀ W k[b, j] + bias (reference BilinearLayer,
    nb_decoder.py:24, out=1). `weight` [C, C] and the 0-d `bias` are the
    reference's `weight[0]` and `bias[0]`."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim, dim))
        self.bias = nn.Parameter(torch.zeros(()))

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        qw = torch.einsum("bic,cd->bid", q, self.weight.to(q.dtype))
        return torch.einsum("bid,bjd->bij", qw, k) + self.bias.to(q.dtype)


class LocalSelfAttention(nn.Module):
    """Self-attention over a window of `window_size` positions centred on
    each one (la_utils.py:10), scale log(w) / head_dim. x is zero-padded
    before `kv_fc`, so a window position past either end carries the
    projection's bias, and is not masked out of the softmax."""

    def __init__(self, dim: int, nhead: int, window_size: int,
                 add_pos_bias: bool = False,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.nhead, self.window_size = nhead, window_size
        self.q_fc = nn.Linear(dim, dim)
        if add_pos_bias:
            self.kv_pos_bias = nn.Parameter(torch.zeros(window_size, dim))
        self.kv_fc = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        B, T, C = x.shape
        w, H = self.window_size, self.nhead
        hd = C // H
        x = x * mask[..., None].to(x.dtype)
        q = linear(x, self.q_fc, c)
        xp = F.pad(x, (0, 0, w // 2, w // 2))
        win = torch.stack([xp[:, j:j + T] for j in range(w)], dim=2)
        if hasattr(self, "kv_pos_bias"):
            win = win + self.kv_pos_bias.to(win.dtype)
        k, v = linear(win, self.kv_fc, c).chunk(2, dim=-1)
        qh = q.reshape(B, T, H, hd)
        kh = k.reshape(B, T, w, H, hd)
        vh = v.reshape(B, T, w, H, hd)
        alpha = torch.einsum("bthd,btwhd->bthw", qh, kh) * (math.log(w) / hd)
        alpha = torch.softmax(alpha.float(), dim=-1).to(qh.dtype)
        out = torch.einsum("bthw,btwhd->bthd", alpha, vh).reshape(B, T, C)
        out = linear(out, self.proj, c)
        return out * mask[..., None].to(out.dtype)


class LocalAttentionModule(nn.Module):
    """Windowed-attention blocks with layerscale (la_utils.py:109); the
    first block's attention adds a learned bias to each window
    position."""

    def __init__(self, dim: int, nhead: int = 8, window_size: int = 11,
                 num_layers: int = 1, layerscale_value: float = 1e-6,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.num_layers = num_layers
        for i in range(num_layers):
            for g in ("gamma1", "gamma2"):
                self.register_parameter(f"{g}_{i}", nn.Parameter(
                    torch.full((dim,), layerscale_value)))
            self.add_module(f"norm1_{i}", nn.LayerNorm(dim, eps=LN_EPS))
            self.add_module(f"sa_{i}", LocalSelfAttention(
                dim, nhead, window_size, add_pos_bias=i == 0, policy=policy))
            self.add_module(f"norm2_{i}", nn.LayerNorm(dim, eps=LN_EPS))
            self.add_module(f"mlp_fc1_{i}", nn.Linear(dim, 4 * dim))
            self.add_module(f"mlp_fc2_{i}", nn.Linear(4 * dim, dim))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        for i in range(self.num_layers):
            part = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            h = part("sa")(layer_norm(x, part("norm1"), c), mask)
            x = x + part("gamma1").to(h.dtype) * h
            h = linear(layer_norm(x, part("norm2"), c), part("mlp_fc1"), c)
            h = linear(gelu(h), part("mlp_fc2"), c)
            x = x + part("gamma2").to(h.dtype) * h
            x = x * mask[..., None].to(x.dtype)
        return x


class FeatureMapEnhancer(nn.Module):
    """Merge decoded character features back into the visual map
    (nb_decoder.py:49): scatter them through the character attention maps,
    add, run FocalNet merge blocks, renormalize."""

    def __init__(self, dim: int, num_layers: int = 1, focal_level: int = 3,
                 max_kh: int = 1, layerscale_value: float = 1e-6,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.num_layers = num_layers
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        for i in range(num_layers):
            self.add_module(f"merge_{i}", FocalNetBlock(
                dim, 4.0, focal_level, 3, max_kh, layerscale_value,
                policy=policy))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, feat_map: torch.Tensor, feat_char: torch.Tensor,
                char_attn_map: torch.Tensor, vis_mask: torch.Tensor,
                h: int = 1) -> torch.Tensor:
        """feat_map [B, N, C]; feat_char [B, T, C]; char_attn_map
        [B, T, N]; vis_mask [B, N] → [B, h, N/h, C]."""
        c = self.policy.compute_dtype
        B, N, C = feat_map.shape
        # the maps are float32, so the sum is too (as jnp.einsum promotes)
        char_feat_map = torch.einsum("btn,btc->bnc", char_attn_map,
                                     feat_char.to(char_attn_map.dtype))
        char_feat_map = layer_norm(char_feat_map, self.norm1, torch.float32)
        feat_map = feat_map + char_feat_map.to(feat_map.dtype)
        mask_2d = vis_mask.reshape(B, h, -1)
        x = feat_map.reshape(B, h, N // h, C)
        for i in range(self.num_layers):
            x = getattr(self, f"merge_{i}")(x, mask_2d)
        x = layer_norm(x, self.norm2, c)
        return x * mask_2d[..., None].to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LISTERConfig:
    variant: str = "base"             # FOCALNET_VARIANTS key
    num_classes: int = 37             # [EOS] + 26 lowercase + 10 digits
    max_ch: int = 36                  # walk length L, the EOS slot included
    iters: int = 0                    # FEM refinement iterations
    nhead: int = 8
    window_size: int = 11
    num_sa_layers: int = 1
    num_mg_layers: int = 1
    focalnet: Optional[FocalNetConfig] = None   # explicit (None → variant)

    def focalnet_config(self) -> FocalNetConfig:
        return self.focalnet or FOCALNET_VARIANTS[self.variant]


class NeighborDecoder(nn.Module):
    def __init__(self, config: LISTERConfig, feat_dim: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = self.config = config
        self.policy = policy
        C = feat_dim
        self.eos_emb = nn.Parameter(torch.zeros(C))
        self.q_fc = nn.Linear(C, C)
        self.k_fc = nn.Linear(C, C)   # biased, as nb_decoder.py:108
        self.neighbor_navigator = BilinearNavigator(C)
        self.vis_cls = nn.Linear(C, cfg.num_classes)
        if cfg.iters > 0:
            self.cntx_module = LocalAttentionModule(
                C, cfg.nhead, cfg.window_size, cfg.num_sa_layers,
                policy=policy)
            self.merge_layer = FeatureMapEnhancer(C, cfg.num_mg_layers,
                                                  policy=policy)

    def align_chars(self, start_map: torch.Tensor, nb_map: torch.Tensor):
        """The eval neighbor walk (nb_decoder.py:132) as a fixed loop of
        `max_ch` steps. start_map [B, N+1]; nb_map [B, N+1, N+1] →
        char_maps [B, L, N+1], char_masks [B, L]."""
        char_map = start_map
        finished = torch.zeros(start_map.shape[0], dtype=torch.int32,
                               device=start_map.device)
        maps, masks = [], []
        for i in range(self.config.max_ch):
            maps.append(char_map)
            masks.append((finished == 0).float())
            finished = finished + (char_map[:, -1] > P_THRESHOLD).int()
            sharp = softmax_m1(char_map * min(1 + 2 * i, 16), dim=-1)
            char_map = torch.bmm(sharp[:, None], nb_map)[:, 0]
        return torch.stack(maps, 1), torch.stack(masks, 1)

    def decode_once(self, x: torch.Tensor, mask: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """x [B, h, w, C]; mask [B, h, w] → logits [B, L, classes] float32,
        char_feats, char_maps, char_masks, nb_map (nb_decoder.py:174)."""
        c = self.policy.compute_dtype
        B, h, w, C = x.shape
        N = h * w
        xf = x.reshape(B, N, C)
        mf = mask.reshape(B, N).float()
        g = (xf * mf[..., None].to(xf.dtype)).sum(1) / (
            mf.sum(1, keepdim=True).to(xf.dtype) + 1e-10)
        eos = self.eos_emb.to(xf.dtype).expand(B, 1, C)
        x_ext = torch.cat([xf, eos], dim=1)                  # [B, N+1, C]
        valid = torch.cat([mf, mf.new_ones(B, 1)], dim=1) > 0

        k_feat = linear(x_ext, self.k_fc, c)
        start_map = torch.einsum("bnc,bc->bn", k_feat,
                                 linear(g, self.q_fc, c))
        nb = self.neighbor_navigator(linear(xf, self.q_fc, c), k_feat)
        start_map = start_map / C ** 0.5
        nb = nb / C ** 0.5
        start_map = torch.softmax(
            torch.where(valid, start_map.float(), NEG_INF), dim=1)
        nb = torch.softmax(torch.where(valid[:, None], nb.float(), NEG_INF),
                           dim=2)
        eos_row = nb.new_zeros(B, 1, N + 1)              # absorbing EOS
        eos_row[..., N] = 1.0
        nb_map = torch.cat([nb, eos_row], dim=1)

        char_maps, char_masks = self.align_chars(start_map, nb_map)
        char_feats = torch.einsum("bln,bnc->blc", char_maps.to(x_ext.dtype),
                                  x_ext)
        char_feats = char_feats * char_masks[..., None].to(char_feats.dtype)
        logits = linear(char_feats, self.vis_cls, c).float()
        return dict(logits=logits, char_feats=char_feats, char_maps=char_maps,
                    char_masks=char_masks, nb_map=nb_map)

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> List[Dict[str, torch.Tensor]]:
        B, h, w, C = x.shape
        res = [self.decode_once(x, mask)]
        xf = x.reshape(B, h * w, C)
        mf = mask.reshape(B, h * w).float()
        for _ in range(self.config.iters):
            prev = res[-1]
            char_cntx = self.cntx_module(prev["char_feats"],
                                         prev["char_masks"])
            feat_map = self.merge_layer(xf, char_cntx,
                                        prev["char_maps"][:, :, :-1], mf, h=h)
            res.append(self.decode_once(feat_map, mask))
        return res


@MODELS.register("lister")
class LISTER(nn.Module):
    """FocalNet encoder + NeighborDecoder. Built on `device` (the GPU
    unless `device="cpu"`) with random weights from `seed` (flax's
    defaults), in eval mode (no stochastic depth), as the JAX module runs
    unless it trains; load real weights with
    `engine.checkpoint.import_lister` or `engine.convert`."""

    def __init__(self, config: LISTERConfig = LISTERConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.policy = policy
        self.encoder = FocalNet(config.focalnet_config(), policy, device,
                                seed)
        self.decoder = NeighborDecoder(config, self.encoder.config.out_dim,
                                       policy)
        gen = torch.Generator().manual_seed(seed + 1)
        init_params(self.decoder, gen)
        with torch.no_grad():
            for name, p in self.decoder.named_parameters():
                if name == "eos_emb" or name.endswith("kv_pos_bias"):
                    nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04,
                                          generator=gen)
                elif name == "neighbor_navigator.weight":
                    nn.init.xavier_normal_(p, generator=gen)
        self.to(device).eval()

    def forward(self, images: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> List[Dict[str, torch.Tensor]]:
        """images [B, 32, W, 3], mask [B, 32, W] → one dict per decode
        (logits [B, L, classes], char_maps, char_masks, ...); the last is
        the refined one."""
        feat, fmask = self.encoder(images, mask)
        return self.decoder(feat, fmask)


def lister_greedy_decode(logits: torch.Tensor, char_masks: torch.Tensor):
    """Greedy ids per position (the first index of the maximum, as
    `jnp.argmax`); EOS (0) pruning is host-side via the codec. Returns
    (ids [B, L] int32, the masks as given)."""
    return torch.argmax(logits, dim=-1).to(torch.int32), char_masks
