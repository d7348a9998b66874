"""Sequence codecs with a leading special token (the port's own copy of
`advancedliteratemachinery_tpu/codecs/seq_codec.py`).

- `EosSeqCodec`, LISTER's attention and neighbor decoding: charlist =
  ['[EOS]'] + chars with EOS id 0; labels are the chars and then EOS,
  zero-padded; decode prunes at the first EOS (reference
  OCR/LISTER/dataset/dataset.py:60-65, utils.py:253
  AttnSequenceDecoder).
- `CtcCodec`, LISTER's CTC baseline: charlist = ['[BLK]'] + chars; greedy
  decode drops blanks and repeats (utils.py:228 CTCLabelConverter).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from advancedliteratemachinery_tpu_torch.core.registry import CODECS

LOWERCASE_DIGITS = "abcdefghijklmnopqrstuvwxyz0123456789"


@CODECS.register("eos_seq")
class EosSeqCodec:
    """['[EOS]'] + charset vocabulary; encode → chars + EOS, zero-padded."""

    EOS_ID = 0

    def __init__(self, charset: str = LOWERCASE_DIGITS, max_ch: int = 36):
        self.charset = charset
        self.itos = ["[EOS]"] + list(charset)
        self.stoi = {c: i for i, c in enumerate(self.itos)}
        self.max_ch = max_ch

    @property
    def num_classes(self) -> int:
        return len(self.itos)

    def encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids [B, max_ch] zero-padded, lengths [B] with the EOS slot)."""
        B = len(texts)
        ids = np.zeros((B, self.max_ch), dtype=np.int32)
        lens = np.zeros((B,), dtype=np.int32)
        for i, t in enumerate(texts):
            if len(t) + 1 > self.max_ch:
                raise ValueError(f"text '{t}' longer than max_ch-1")
            for j, c in enumerate(t):
                ids[i, j] = self.stoi[c]
            lens[i] = len(t) + 1
        return ids, lens

    def decode(self, ids: np.ndarray) -> List[str]:
        out = []
        for row in np.asarray(ids):
            chars = []
            for i in row:
                if int(i) == self.EOS_ID:
                    break
                chars.append(self.itos[int(i)])
            out.append("".join(chars))
        return out


@CODECS.register("ctc")
class CtcCodec:
    """['[BLK]'] + charset; greedy decode drops blanks + repeats."""

    BLANK_ID = 0

    def __init__(self, charset: str = LOWERCASE_DIGITS, max_ch: int = 36):
        self.charset = charset
        self.itos = ["[BLK]"] + list(charset)
        self.stoi = {c: i for i, c in enumerate(self.itos)}
        self.max_ch = max_ch

    @property
    def num_classes(self) -> int:
        return len(self.itos)

    def encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids [B, max_ch] zero-padded, lengths [B])."""
        B = len(texts)
        ids = np.zeros((B, self.max_ch), dtype=np.int32)
        lens = np.zeros((B,), dtype=np.int32)
        for i, t in enumerate(texts):
            for j, c in enumerate(t):
                ids[i, j] = self.stoi[c]
            lens[i] = len(t)
        return ids, lens

    def decode(self, ids: np.ndarray) -> List[str]:
        out = []
        for row in np.asarray(ids):
            chars = []
            prev = -1
            for i in row:
                i = int(i)
                if i != self.BLANK_ID and i != prev:
                    chars.append(self.itos[i])
                prev = i
            out.append("".join(chars))
        return out
