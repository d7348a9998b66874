"""Levenshtein edit ops on fixed [B, L] buffers, on the device (port of the
device half of `advancedliteratemachinery_tpu/ops/levenshtein.py`; they
replace fairseq's `libnat` `_apply_del_words`, `_apply_ins_masks` and
`_apply_ins_words`, levt/levenshtein_utils.py).

Every op is a masked reorder of the whole buffer, with no data-dependent
shape and no host sync, so a refinement loop runs a fixed number of
rounds on the device. Token ids stay int32; positions are int64 indices.
The host-side training helpers (`ins_del_targets` and its native library,
`random_delete`) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def apply_del_words(tokens: torch.Tensor, scores: torch.Tensor,
                    del_pred: torch.Tensor, pad: int, bos: int, eos: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delete the flagged tokens, compact the kept ones left in their
    order, pad the tail; bos and eos are never deleted."""
    B, L = tokens.shape
    pos = torch.arange(L, device=tokens.device)
    protect = (tokens == bos) | (tokens == eos)
    keep = (~del_pred | protect) & (tokens != pad)
    key = torch.where(keep, 0, L) + pos
    order = torch.argsort(key, dim=1, stable=True)
    n_keep = keep.sum(1, keepdim=True)
    valid = pos < n_keep
    return (torch.where(valid, tokens.gather(1, order), pad),
            torch.where(valid, scores.gather(1, order), 0.0))


def apply_ins_masks(tokens: torch.Tensor, scores: torch.Tensor,
                    ins_pred: torch.Tensor, pad: int, unk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert ins_pred[:, j] <unk> placeholders after token j (j = 0..L-2)
    of a [B, L] buffer. Insertions that would run past the buffer are
    clamped off from the left end of the overflow (the reference pre-clamps
    with max_lens; here the buffer is the bound)."""
    B, L = tokens.shape
    dev = tokens.device
    pos = torch.arange(L, device=dev)
    lengths = (tokens != pad).sum(1)                       # bos/eos included
    slot_valid = pos[:L - 1] < (lengths[:, None] - 1)
    ins = torch.where(slot_valid, ins_pred.long(), 0)
    cum = ins.cumsum(1)
    overflow = (cum - (L - lengths)[:, None]).clamp(min=0)
    prev = torch.cat([overflow.new_zeros(B, 1), overflow[:, :-1]], 1)
    ins = (ins - (overflow - prev)).clamp(min=0)
    cum = ins.cumsum(1)
    # where original token j lands; tokens past the length go to L, the
    # extra column of an L + 1 buffer that is cut off afterwards
    shift = torch.cat([cum.new_zeros(B, 1), cum], 1)          # [B, L]
    tok_valid = pos < lengths[:, None]
    new_pos = torch.where(tok_valid, pos + shift, L).clamp(0, L)
    new_len = lengths + cum[:, -1]
    base = torch.where(pos < new_len[:, None], unk, pad).to(tokens.dtype)
    new_tokens = torch.cat([base, base.new_full((B, 1), pad)], 1)
    new_scores = scores.new_zeros(B, L + 1)
    new_tokens.scatter_(1, new_pos, torch.where(tok_valid, tokens, pad))
    new_scores.scatter_(1, new_pos, torch.where(tok_valid, scores, 0.0))
    return new_tokens[:, :L], new_scores[:, :L]


def apply_ins_words(tokens: torch.Tensor, scores: torch.Tensor,
                    word_pred: torch.Tensor, word_score: torch.Tensor,
                    unk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill the <unk> placeholders with the predicted words and their
    scores."""
    is_unk = tokens == unk
    return (torch.where(is_unk, word_pred.to(tokens.dtype), tokens),
            torch.where(is_unk, word_score, scores))
