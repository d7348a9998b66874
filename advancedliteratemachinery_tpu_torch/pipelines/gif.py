"""GIF decoding, the first frame as Pillow 12's `GifImagePlugin` opens
it: `decode_gif(data)` equals `Image.open(...).convert("RGB")`.

- The logical screen, grown to hold a first frame that reaches past it.
  The frame's pixels come from its local colour table, else the global
  one; a table whose entries are all (i, i, i) is dropped, as PIL drops
  it, and the indices are then gray levels. Indices past the table are
  black.
- Pixels outside the frame take index 0, or the frame's transparent index
  when its graphic control extension sets one: PIL fills the canvas with
  it. `convert("RGB")` ignores transparency, so the transparent index
  shows its table's colour; the background index is not used.
- LZW codes are read LSB first, from a minimum code size of 1-8, widening
  when the next free entry reaches the code mask, up to 12 bits; the
  table stops growing at 4096 entries until a clear code (a deferred
  clear). Interlaced frames fill rows 0, 4, 2, 1 modulo 8, 8, 4, 2. Data
  past the frame's last pixel is ignored; a stream that ends before it
  (an end code or the data's end) raises, as PIL refuses it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from advancedliteratemachinery_tpu_torch.pipelines.jpeg import (
    MAX_IMAGE_PIXELS)

_SIGNATURES = (b"GIF87a", b"GIF89a")


def _table(data: bytes, at: int, bits: int):
    """A colour table of 2^bits entries at byte `at` → (uint8 [256, 3]
    with black past it, or None for PIL's dropped gray ramp; the next
    byte). A table cut by the file's end fails where PIL's
    `_is_palette_needed` runs past it."""
    raw = data[at:at + (3 << bits)]
    n = len(raw) // 3
    try:
        needed = any(not (i // 3 == raw[i] == raw[i + 1] == raw[i + 2])
                     for i in range(0, len(raw), 3))
    except IndexError:
        raise ValueError("GIF: colour table cut by the file's end") from None
    if not needed:
        return None, at + (3 << bits)
    table = np.zeros((256, 3), np.uint8)
    table[:min(n, 256)] = np.frombuffer(raw[:3 * min(n, 256)],
                                        np.uint8).reshape(-1, 3)
    return table, at + (3 << bits)


def _sub_blocks(data: bytes, at: int) -> bytes:
    """Data sub-blocks from byte `at` up to the zero-length terminator,
    joined; a block cut by the data's end is left out, as PIL's decoder
    waits for whole blocks."""
    out = []
    while at < len(data) and data[at] and at + 1 + data[at] <= len(data):
        out.append(data[at + 1:at + 1 + data[at]])
        at += 1 + data[at]
    return b"".join(out)


def _skip_blocks(data: bytes, at: int) -> int:
    while at < len(data) and data[at]:
        at += 1 + data[at]
    return at + 1


def _lzw(stream: bytes, bits: int, count: int) -> bytes:
    """GIF's variable-width LZW (codes LSB first) from a minimum code size
    `bits` → the first `count` indices, as Pillow's `GifDecode.c` reads
    them."""
    if not 1 <= bits <= 8:
        raise ValueError(f"GIF: LZW minimum code size {bits}")
    clear, end = 1 << bits, (1 << bits) + 1
    strings = [bytes((i,)) for i in range(clear)] + [b"", b""]
    out = bytearray()
    b = np.frombuffer(stream + bytes(3), np.uint8).astype(np.int32)
    # the 24 bits (little-endian) that start at each byte
    win = (b[:-2] | (b[1:-1] << 8) | (b[2:] << 16)).tolist()
    total = 8 * len(stream)
    pos, size, mask = 0, bits + 1, (1 << (bits + 1)) - 1
    prev = None
    table = strings[:]
    while len(out) < count:
        if pos + size > total:
            raise ValueError("GIF: image data ends before the frame is "
                             "full")
        code = (win[pos >> 3] >> (pos & 7)) & mask
        pos += size
        if code == clear:
            table = strings[:]
            size, mask, prev = bits + 1, (1 << (bits + 1)) - 1, None
            continue
        if code == end:
            raise ValueError("GIF: end code before the frame is full")
        if prev is None:
            if code > clear:
                raise ValueError("GIF: corrupt LZW data")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and code < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("GIF: corrupt LZW data")
        if prev is not None and len(table) - 1 == mask and size < 12 \
                and len(table) <= 4096:
            size += 1
            mask = (1 << size) - 1
        out += entry
        prev = entry
    return bytes(out[:count])


def _open_gif(data: bytes):
    """The screen, the blocks up to the first frame's descriptor and its
    LZW code size, walked as PIL's `GifImageFile._open` walks them (a
    `ValueError` where it raises) → (screen width and height, colour
    table or None, transparent index or None, frame x, y, width, height,
    frame flags, offset of the LZW code size byte)."""
    if not data.startswith(_SIGNATURES) or len(data) < 11:
        raise ValueError("not a GIF")
    sw, sh = int.from_bytes(data[6:8], "little"), int.from_bytes(
        data[8:10], "little")
    flags = data[10]
    table, at = None, 13
    if flags & 128:
        if len(data) < 12:
            raise ValueError("GIF: truncated screen descriptor")
        table, at = _table(data, 13, (flags & 7) + 1)
    transparency = None
    while True:
        if at >= len(data) or data[at] == 0x3B:
            raise ValueError("GIF: no image in the file")
        kind = data[at]
        at += 1
        if kind == 0x21:                                # extension
            if at >= len(data):
                raise ValueError("GIF: truncated extension")
            label = data[at]
            at += 1
            n = data[at] if at < len(data) else 0
            block = data[at + 1:at + 1 + n]
            if label == 0xF9 and n:                     # graphic control
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise ValueError("GIF: truncated graphic control "
                                     "extension")
                if block[0] & 1:
                    transparency = block[3]
            at = _skip_blocks(data, at)
        elif kind == 0x2C:                              # image descriptor
            if at + 9 > len(data):
                raise ValueError("GIF: truncated image descriptor")
            x0, y0, fw, fh = (int.from_bytes(data[at + 2 * i:at + 2 * i + 2],
                                             "little") for i in range(4))
            fflags = data[at + 8]
            at += 9
            if fflags & 128:
                # a dropped local table leaves the frame without one
                table, at = _table(data, at, (fflags & 7) + 1)
            if at >= len(data):
                raise ValueError("GIF: truncated image data")
            break
        # any other byte is skipped, as PIL skips it
    W, H = max(sw, x0 + fw), max(sh, y0 + fh)
    if W * H > MAX_IMAGE_PIXELS:
        raise ValueError(f"GIF of {W}x{H} = {W * H} pixels exceeds "
                         f"MAX_IMAGE_PIXELS ({MAX_IMAGE_PIXELS}): a "
                         f"possible decompression bomb")
    return W, H, table, transparency, x0, y0, fw, fh, fflags, at


def check_gif(data: bytes) -> Tuple[int, int]:
    """Raise `ValueError` where PIL's `Image.open` of a GIF would fail
    (its `verify()` checks nothing more); else → its (width, height): the
    screen, grown to hold the first frame."""
    return _open_gif(data)[:2]


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes → the first frame as uint8 RGB [H, W, 3], as PIL's
    `convert("RGB")`."""
    W, H, table, transparency, x0, y0, fw, fh, fflags, at = _open_gif(data)
    bits = data[at]
    idx = np.frombuffer(_lzw(_sub_blocks(data, at + 1), bits,
                                   fw * fh), np.uint8).reshape(fh, fw)
    if fflags & 64:                                     # interlaced
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    canvas = np.full((H, W), transparency or 0, np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = idx
    if table is None:
        return np.repeat(canvas[..., None], 3, -1)
    return table[canvas]
