"""CCITT bilevel fax decoding for `pipelines/tiff.py`, as libtiff 4.7's
`tif_fax3.c` reads a strip or tile:

- Modified Huffman (TIFF compression 2): each row 1-D coded from its
  first bit, rows byte-aligned, no EOLs;
- T.4 / Group 3 (compression 3): every row after an EOL (found as libtiff
  finds it: eleven zero bits, then zeros up to a one, so fill bits before
  it are skipped), 1-D, or with `T4Options` bit 0 a tag bit after the EOL
  choosing a 1-D or a 2-D row;
- T.6 / Group 4 (compression 4): every row 2-D against the row above (a
  white row above the first), no EOLs.

Runs alternate white and black from a white run; a run is make-up codes
(64-2560) and a terminating code (0-63). 2-D rows use the pass,
horizontal and vertical (V0, VR1-3, VL1-3) modes. The decoded rows come
out packed MSB first, a black run's pixels as 1 bits (libtiff's output,
which PIL then reads by the file's photometric interpretation).
Uncompressed mode and rows whose runs do not add up to the width raise
`ValueError`. Bits are read from a string of '0'/'1' characters, a code
by its prefix in a dict: bit-serial Python.
"""

from __future__ import annotations

import numpy as np

# terminating codes, run length 0-63, white then black
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 "
    "01000 001000 000011 110100 110101 101010 101011 0100111 0001100 "
    "0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 "
    "0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 "
    "00101011 00101100 00101101 00000100 00000101 00001010 00001011 "
    "01010010 01010011 01010100 01010101 00100100 00100101 01011000 "
    "01011001 01011010 01011011 01001010 01001011 00110010 00110011 "
    "00110100").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
# make-up codes, run length 64-1728 in steps of 64
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101").split()
# make-up codes both colours share, run length 1792-2560
_EXTENDED_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()
# 2-D mode codes → (mode, vertical offset)
_MODES = {"1": ("V", 0), "011": ("V", 1), "000011": ("V", 2),
          "0000011": ("V", 3), "010": ("V", -1), "000010": ("V", -2),
          "0000010": ("V", -3), "001": ("H", 0), "0001": ("P", 0)}


def _runs(term, makeup):
    table = {c: n for n, c in enumerate(term)}
    table.update({c: 64 * (n + 1) for n, c in enumerate(makeup)})
    table.update({c: 1792 + 64 * n for n, c in enumerate(_EXTENDED_MAKEUP)})
    return table


_TABLES = (_runs(_WHITE_TERM, _WHITE_MAKEUP),
           _runs(_BLACK_TERM, _BLACK_MAKEUP))


class _Bits:
    """A bit string read MSB first, one code at a time."""

    def __init__(self, data: bytes):
        self.s = np.unpackbits(np.frombuffer(data, np.uint8)).tobytes() \
            .translate(bytes.maketrans(b"\x00\x01", b"01")).decode()
        self.pos = 0

    def code(self, table, longest=13):
        s, p = self.s, self.pos
        for n in range(1, longest + 1):
            c = s[p:p + n]
            if len(c) < n:
                break
            if c in table:
                self.pos = p + n
                return table[c]
        if s.startswith("0000001", p):
            raise ValueError("CCITT: uncompressed mode or a misplaced EOL "
                             "is not decoded by the port")
        raise ValueError("CCITT: bad code word (corrupt or truncated data)")

    def run(self, colour):
        total = 0
        while True:
            n = self.code(_TABLES[colour])
            total += n
            if n < 64:
                return total

    def sync_eol(self):
        """libtiff's SYNC_EOL: past eleven zero bits and the one that
        ends their zeros."""
        at = self.s.find("0" * 11, self.pos)
        one = self.s.find("1", at) if at >= 0 else -1
        if one < 0:
            raise ValueError("CCITT: premature end of data (no EOL)")
        self.pos = one + 1

    def bit(self):
        if self.pos >= len(self.s):
            raise ValueError("CCITT: premature end of data")
        self.pos += 1
        return self.s[self.pos - 1] == "1"

    def align(self):
        self.pos = -(-self.pos // 8) * 8


def _row_1d(bits: _Bits, width: int):
    """A 1-D row → its changing positions (white→black at even
    indices)."""
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 += bits.run(colour)
        if a0 > width:
            raise ValueError("CCITT: row runs past its width")
        changes.append(a0)
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, width: int, ref):
    """A 2-D row against the reference row's changing positions."""
    changes, a0, colour = [], -1, 0
    ref = list(ref) + [width, width]
    while a0 < width:
        # b1: the first change of the reference row right of a0 to the
        # colour opposite a0's (white→black changes sit at even indices)
        i = 0
        while i < len(ref) - 2 and (ref[i] <= a0 or (i & 1) != colour):
            i += 1
        b1, b2 = ref[i], ref[i + 1]
        mode, k = bits.code(_MODES, 7)
        if mode == "P":
            a0 = b2
        elif mode == "H":
            start = max(a0, 0)
            a1 = start + bits.run(colour)
            a2 = a1 + bits.run(colour ^ 1)
            if a2 > width:
                raise ValueError("CCITT: row runs past its width")
            changes += [a1, a2]
            a0 = a2
        else:
            a1 = b1 + k
            if a1 > width or a1 < max(a0, 0):
                raise ValueError("CCITT: vertical mode outside the row")
            changes.append(a1)
            a0, colour = a1, colour ^ 1
    return [c for c in changes if c < width]


def _pack(rows, width: int) -> bytes:
    """Rows of changing positions → packed bits, black runs as 1."""
    out = np.zeros((len(rows), width + 1), np.int8)
    for r, changes in enumerate(rows):
        for i, c in enumerate(changes):
            out[r, c] += 1 if i % 2 == 0 else -1
    black = np.cumsum(out[:, :width], axis=1, dtype=np.int32) > 0
    return np.packbits(black, axis=1).tobytes()


def decode(raw: bytes, width: int, rows: int, kind: str, t4: int = 0,
           t6: int = 0) -> bytes:
    """A CCITT-coded strip or tile (`kind` "ccitt", "group3" or "group4",
    bits already in MSB-first order) → `rows` packed rows of `width`
    pixels."""
    if (kind == "group3" and t4 & 2) or (kind == "group4" and t6 & 2):
        raise ValueError("CCITT uncompressed mode is not decoded by the "
                         "port (queued)")
    bits = _Bits(raw)
    out, ref = [], []
    for _ in range(rows):
        if kind == "ccitt":
            row = _row_1d(bits, width)
            bits.align()
        elif kind == "group3":
            bits.sync_eol()
            two_d = t4 & 1 and not bits.bit()
            row = _row_2d(bits, width, ref) if two_d else _row_1d(bits, width)
        else:
            row = _row_2d(bits, width, ref)
        out.append(row)
        ref = row
    return _pack(out, width)
