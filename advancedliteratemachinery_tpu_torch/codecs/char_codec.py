"""Character-level label codec (the port's own copy of
`advancedliteratemachinery_tpu/codecs/char_codec.py` `CharCodec`).

MGP-STR `TokenLabelConverter` char path: vocab = ['[GO]', '[s]'] + charset;
sequences are [GO] + chars + [s], GO-padded to batch_max_length + 2; decode
prunes at the first '[s]'.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_CHARSET = "0123456789abcdefghijklmnopqrstuvwxyz"
GO = "[GO]"
EOS = "[s]"
GO_ID = 0
EOS_ID = 1


class CharCodec:
    def __init__(self, charset: str = DEFAULT_CHARSET,
                 batch_max_length: int = 25):
        self.charset = charset
        self.itos: List[str] = [GO, EOS] + list(charset)
        self.stoi = {c: i for i, c in enumerate(self.itos)}
        self.max_tokens = batch_max_length + 2

    @property
    def num_classes(self) -> int:
        return len(self.itos)

    def encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """→ (lengths [B], ids [B, max_tokens]) GO-padded."""
        B = len(texts)
        ids = np.full((B, self.max_tokens), GO_ID, dtype=np.int32)
        lengths = np.zeros((B,), dtype=np.int32)
        for i, t in enumerate(texts):
            seq = [GO_ID] + [self.stoi[c] for c in t] + [EOS_ID]
            if len(seq) > self.max_tokens:
                raise ValueError(f"text '{t}' longer than batch_max_length")
            ids[i, : len(seq)] = seq
            lengths[i] = len(t)
        return lengths, ids

    def decode(self, ids: np.ndarray) -> List[str]:
        """ids [B, T] (model positions 1:, after the GO slot). Prunes each
        row at the first EOS; GO renders as '[GO]', as the reference."""
        out = []
        for row in np.asarray(ids):
            chars = []
            for i in row:
                if i == EOS_ID:
                    break
                chars.append(GO if i == GO_ID else self.itos[int(i)])
            out.append("".join(chars))
        return out
