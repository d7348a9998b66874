"""Coordinate-bin + character vocabulary for structured sequence decoding
(the port's own copy of `advancedliteratemachinery_tpu/codecs/coords.py`).

OmniParser's vocabulary layout (reference OCR/OmniParser/utils/parser.py:
16-103):
  [0, num_bins)                      coordinate bins (default 1000)
  [num_bins, num_bins+95)            printable chars (parser.py:16)
  num_bins+95                        unknown char
  num_bins+96   = recog_pad_index
  +1            = pt_eos_index
  +1            = poly_eos_index
  +1            = rec_eos_index
  +1            = pt_sos_index
  +1            = poly_sos_index
  +1            = rec_sos_index
  +1            = padding_index
  then vie_categories class tokens; num_classes = padding_index+1+vie.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from advancedliteratemachinery_tpu_torch.core.registry import CODECS

PRINTABLE_CHARS = (
    " !\"#$%&'()*+,-./0123456789:;<=>?@ABCDEFGHIJKLMNOPQRSTUVWXYZ[\\]^_`"
    "abcdefghijklmnopqrstuvwxyz{|}~"
)


@CODECS.register("coord_seq")
@dataclasses.dataclass(frozen=True)
class CoordSeqVocab:
    num_bins: int = 1000
    chars: str = PRINTABLE_CHARS
    vie_categories: int = 0

    @property
    def num_char_classes(self) -> int:
        return len(self.chars) + 1  # + unknown

    @property
    def unknown_index(self) -> int:
        return self.num_bins + len(self.chars)

    @property
    def recog_pad_index(self) -> int:
        return self.num_bins + self.num_char_classes

    @property
    def pt_eos_index(self) -> int:
        return self.recog_pad_index + 1

    @property
    def poly_eos_index(self) -> int:
        return self.pt_eos_index + 1

    @property
    def rec_eos_index(self) -> int:
        return self.poly_eos_index + 1

    @property
    def pt_sos_index(self) -> int:
        return self.rec_eos_index + 1

    @property
    def poly_sos_index(self) -> int:
        return self.pt_sos_index + 1

    @property
    def rec_sos_index(self) -> int:
        return self.poly_sos_index + 1

    @property
    def padding_index(self) -> int:
        return self.rec_sos_index + 1

    @property
    def num_classes(self) -> int:
        return self.padding_index + 1 + self.vie_categories

    def quantize(self, xy: np.ndarray, size: float) -> np.ndarray:
        """Continuous coords → bin tokens."""
        return np.clip((np.asarray(xy) / size * self.num_bins).astype(np.int64),
                       0, self.num_bins - 1)

    def encode_text(self, text: str) -> List[int]:
        out = []
        for c in text:
            i = self.chars.find(c)
            out.append(self.num_bins + (i if i >= 0 else len(self.chars)))
        return out

    def decode_text(self, ids: Sequence[int]) -> str:
        """Reference decode (transformer.py:191-203): stop at recog_pad or
        rec_eos; skip unknown."""
        chars = []
        for i in ids:
            i = int(i)
            if i in (self.recog_pad_index, self.rec_eos_index):
                break
            if i == self.unknown_index:
                continue
            if self.num_bins <= i < self.unknown_index:
                chars.append(self.chars[i - self.num_bins])
        return "".join(chars)

    def pt_prompt(self, use_char_window: bool = True) -> np.ndarray:
        """Eval point-seq prompt (engine/val.py:25-28): full-image window
        [0, 0, nb-1, nb-1] (+ char-range window) + pt_sos."""
        if use_char_window:
            seq = [0, 0, self.num_bins - 1, self.num_bins - 1,
                   self.num_bins, self.num_bins + len(self.chars),
                   self.pt_sos_index]
        else:
            seq = [0, 0, self.num_bins - 1, self.num_bins - 1,
                   self.pt_sos_index]
        return np.asarray(seq, np.int32)

    @property
    def vie_class_base(self) -> int:
        """First VIE category token id (reference transformer.py:56:
        index2class maps padding_index + 1 + i)."""
        return self.padding_index + 1


# Dataset label sets for the KIE task (reference transformer.py:50-62:
# classes_cord / classes_sroie — the constant tables index2class is built
# from; class token id = padding_index + 1 + position).
CORD_CLASSES = (
    "menu.cnt", "menu.discountprice", "menu.etc", "menu.itemsubtotal",
    "menu.nm", "menu.num", "menu.price", "menu.sub.cnt", "menu.sub.nm",
    "menu.sub.price", "menu.sub.unitprice", "menu.unitprice", "menu.vatyn",
    "sub_total.discount_price", "sub_total.etc", "sub_total.othersvc_price",
    "sub_total.service_price", "sub_total.subtotal_price",
    "sub_total.tax_price", "total.cashprice", "total.changeprice",
    "total.creditcardprice", "total.emoneyprice", "total.menuqty_cnt",
    "total.menutype_cnt", "total.total_etc", "total.total_price",
    "void_menu.nm", "void_menu.price",
)

SROIE_CLASSES = ("company", "address", "date", "total")
