"""LISTER's baseline decoders: CTC, RNN attention, parallel attention
(port of `advancedliteratemachinery_tpu/models/lister_baselines.py`;
reference OCR/LISTER/model/).

- CTCDecoder (ctc_decoder.py:5): per-position linear over the flattened
  feature map → CTC logits.
- ParallelAttention PAT (pat_decoder.py:6): key projection → 26 learned
  order queries → masked softmax over positions → per-slot classifier.
- RNNAttention (RNNDecoder.py:10): GRU cell with Bahdanau-style attention
  over the masked feature sequence, a fixed number of steps; teacher
  forcing when `targets` is given, else greedy feedback (the first index
  of the maximum, as `jnp.argmax`).

Submodules carry the flax names, so `engine/convert.py` maps a flax tree
onto them with its Dense rule. The GRU is flax's `GRUCell`: six Dense,
`ir`, `iz`, `in` (with bias), `hr`, `hz` (without) and `hn` (with), as six
Linear here; the reset gate scales `hn(h)` with its bias, as in flax.
CTCDecoder and ParallelAttention compute their Dense in the policy's
compute dtype; RNNAttention runs in float32 whatever the policy, as the
JAX module (its Dense take no dtype). Masked positions are -1e30 in
float32 before each softmax. Heads are built on `device` (the GPU unless
`device="cpu"`) with flax's default init drawn from `seed`.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.models.layers import (
    init_params, linear)

NEG_INF = -1e30


def _built(module: nn.Module, device, seed: int) -> None:
    """flax's default init from `seed`, then onto `device`, in eval
    mode."""
    init_params(module, torch.Generator().manual_seed(seed))
    module.to(resolve_device(device)).eval()


class CTCDecoder(nn.Module):
    def __init__(self, num_classes: int, in_dim: int,
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        self.policy = policy
        self.fc = nn.Linear(in_dim, num_classes)
        _built(self, device, seed)

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """x [B,h,w,C]; mask [B,h,w] → logits [B, h*w, nC] (blank id 0)."""
        B, h, w, C = x.shape
        logits = linear(x.reshape(B, h * w, C), self.fc,
                        self.policy.compute_dtype).float()
        return {"logits": logits, "mask": mask.reshape(B, h * w)}


class ParallelAttention(nn.Module):
    def __init__(self, num_classes: int, in_dim: int, max_ch: int = 26,
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        self.policy = policy
        self.k_map = nn.Linear(in_dim, in_dim)
        self.order_att = nn.Linear(in_dim, max_ch)
        self.fc = nn.Linear(in_dim, num_classes)
        _built(self, device, seed)

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """x [B,h,w,C]; mask [B,h,w] → logits [B, max_ch, nC], the
        attention maps char_maps [B, max_ch, h*w] (float32) and h."""
        cd = self.policy.compute_dtype
        B, h, w, C = x.shape
        xf = x.reshape(B, h * w, C)
        mf = mask.reshape(B, h * w)
        key = linear(xf, self.k_map, cd)
        att = linear(key, self.order_att, cd).transpose(1, 2)  # [B, T, N]
        att = torch.where(mf[:, None, :] > 0, att.float(), NEG_INF)
        att = torch.softmax(att, dim=2)
        char_feat = torch.einsum("btn,bnc->btc", att.to(xf.dtype), xf)
        logits = linear(char_feat, self.fc, cd).float()
        return {"logits": logits, "char_maps": att, "h": h}


class GRUCell(nn.Module):
    """flax's `GRUCell` (float32): r = σ(ir(x) + hr(h)), z = σ(iz(x) +
    hz(h)), n = tanh(in(x) + r · hn(h)), h' = (1 - z) · n + z · h."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_dim, features))
        self.hr = nn.Linear(features, features, bias=False)
        self.hz = nn.Linear(features, features, bias=False)
        self.hn = nn.Linear(features, features)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class RNNAttention(nn.Module):
    """GRU + additive attention (RNNDecoder.py:10/:87), fixed num_steps."""

    def __init__(self, num_classes: int, in_dim: int,
                 hidden_size: int = 256, num_steps: int = 26,
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        self.policy = policy
        self.num_classes = num_classes
        self.hidden_size = hidden_size
        self.num_steps = num_steps
        H = hidden_size
        self.i2h = nn.Linear(in_dim, H, bias=False)
        self.h2h = nn.Linear(H, H)
        self.score = nn.Linear(H, 1, bias=False)
        self.gru = GRUCell(in_dim + num_classes, H)
        self.generator = nn.Linear(H, num_classes)
        gen = torch.Generator().manual_seed(seed)
        init_params(self, gen)
        with torch.no_grad():       # flax's recurrent kernel init
            for name in ("hr", "hz", "hn"):
                nn.init.orthogonal_(getattr(self.gru, name).weight,
                                    generator=gen)
        self.to(resolve_device(device)).eval()

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                targets: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x [B,h,w,C]; mask [B,h,w]; targets [B,T] for teacher forcing
        → logits [B, num_steps, nC] (float32)."""
        B, h, w, C = x.shape
        feats = x.reshape(B, h * w, C).float()
        mf = mask.reshape(B, h * w).float()
        feats_proj = self.i2h(feats)                     # [B, N, H]
        hidden = feats.new_zeros((B, self.hidden_size))
        tok = torch.zeros((B,), dtype=torch.long, device=x.device)
        logits = []
        for t in range(self.num_steps):
            e = self.score(torch.tanh(
                feats_proj + self.h2h(hidden)[:, None]))[..., 0]
            e = torch.where(mf > 0, e, NEG_INF)
            alpha = torch.softmax(e, dim=1)
            ctx = torch.einsum("bn,bnc->bc", alpha, feats)
            onehot = F.one_hot(tok, self.num_classes).float()
            hidden = self.gru(hidden, torch.cat([ctx, onehot], dim=-1))
            lt = self.generator(hidden)
            logits.append(lt)
            tok = (targets[:, t].long() if targets is not None
                   else torch.argmax(lt, dim=-1))
        return {"logits": torch.stack(logits, dim=1)}


def ctc_greedy_loss(logits: torch.Tensor, logit_mask: torch.Tensor,
                    labels: torch.Tensor, label_lens: torch.Tensor
                    ) -> torch.Tensor:
    """The mean over the batch of each sequence's CTC loss (blank 0), the
    frames where `logit_mask` is 0 left out wherever they sit, as
    `optax.ctc_loss` leaves out padded frames (train_dist.py ctc path).
    `F.ctc_loss` reads a prefix of each row, so the valid frames are
    packed to the front first, in their order."""
    valid = logit_mask > 0
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    packed = torch.gather(log_probs, 1, order[..., None].expand_as(
        log_probs))
    per_seq = F.ctc_loss(packed.transpose(0, 1), labels.long(),
                         valid.sum(1), label_lens.long(), blank=0,
                         reduction="none")
    return per_seq.mean()
