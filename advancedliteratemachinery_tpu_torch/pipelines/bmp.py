"""BMP decoding in NumPy, as Pillow 12's `BmpImagePlugin` reads a file:
`decode_bmp(data)` equals `Image.open(...).convert("RGB")`.

- Headers: OS/2 core (12 bytes; a 3-byte palette entry) and Windows 40,
  52, 56, 64, 108 and 124 bytes. Rows run bottom-up, or top-down when
  the height's top byte is 0xFF, as PIL tells them.
- 1, 4 and 8 bits through a palette of `colors` entries (2^bits when the
  header says 0). Entries past the palette are black. A palette whose
  entries are all (i, i, i) (two entries: black and white) is dropped,
  as PIL drops it: the samples are then read as PIL's mode "L" (8 bits
  a sample) or "1" (1 bit), whatever the file's depth, and a row too
  short for that raises, as in PIL.
- 16 bits as 5-5-5 (`v * 255 // 31` a channel) or, under BI_BITFIELDS
  with a 5-6-5 mask, 6-bit green (`v * 255 // 63`); 24 bits; 32 bits as
  BGRX, or under BI_BITFIELDS the byte layouts PIL lists. Alpha is
  dropped, never composited.
- RLE8 and RLE4 follow PIL's `BmpRleDecoder` step for step: a run is cut
  at the row's end, an absolute run is not; end-of-line pads the row
  with index 0; the delta escape reads two bytes, ignores them and
  skips right + up · width pixels by the next two (index 0); RLE4's
  odd absolute runs lose their last pixel; a stream that ends before the
  bitmap is full raises.
- BI_ALPHABITFIELDS, JPEG and PNG inside BMP, other bit fields and
  depths raise `ValueError` naming them, as PIL refuses them.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from advancedliteratemachinery_tpu_torch.pipelines.jpeg import (
    MAX_IMAGE_PIXELS)

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
_COMPRESSION_NAMES = {4: "JPEG", 5: "PNG", 6: "BI_ALPHABITFIELDS"}
# BI_BITFIELDS masks → the byte order of a pixel's samples (PIL's raw
# modes; "A" and "X" are dropped), or "BGR;16" / "BGR;15"
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def _u32(data: bytes, at: int) -> int:
    if at + 4 > len(data):
        raise ValueError("BMP: truncated header")
    return struct.unpack_from("<I", data, at)[0]


def _rle(data: bytes, at: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """PIL's `BmpRleDecoder` from byte `at` → indices [w * h] in file row
    order."""
    out = bytearray()
    x, n, end = 0, w * h, len(data)
    while len(out) < n:
        if at + 2 > end:
            break
        count, byte = data[at], data[at + 1]
        at += 2
        if count:                                   # encoded run
            count = max(0, w - x) if x + count > w else count
            if rle4:
                pair = bytes((byte >> 4, byte & 15))
                out += pair * (count // 2) + pair[:count % 2]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:                             # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:                             # end of bitmap
            break
        elif byte == 2:                             # delta, as PIL reads it
            if at + 2 > end:
                break
            at += 2
            if at + 2 > end:
                raise ValueError("BMP: truncated RLE delta")
            right, up = data[at], data[at + 1]
            at += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:                                       # absolute run
            take = byte // 2 if rle4 else byte
            raw = data[at:at + take]
            at += len(raw)
            if rle4:
                v = np.frombuffer(raw, np.uint8)
                out += np.stack([v >> 4, v & 15], -1).tobytes()
            else:
                out += raw
            if len(raw) < take:
                break
            x += byte
            at += at % 2                            # 16-bit alignment
    if len(out) < n:
        raise ValueError("BMP: not enough image data in the RLE stream")
    return np.frombuffer(bytes(out[:n]), np.uint8)


def _unpack_rows(data: bytes, at: int, w: int, h: int, bits: int,
                 stride: int) -> np.ndarray:
    """`h` rows of `stride` bytes from byte `at` → samples [h, w] of
    `bits` bits (uint8 indices, or the rows' bytes [h, w * bits / 8])."""
    need = (w * bits + 7) // 8
    if stride < need:
        raise ValueError("BMP: rows too short for the samples PIL reads")
    if at + stride * (h - 1) + need > len(data) or at < 0:
        raise ValueError("BMP: image file is truncated")
    buf = np.frombuffer(data, np.uint8, count=min(len(data) - at,
                                                  stride * h), offset=at)
    rows = np.zeros((h, stride), np.uint8)
    rows.reshape(-1)[:len(buf)] = buf
    rows = rows[:, :need]
    if bits == 8 or bits > 8:
        return rows
    bitsarr = np.unpackbits(rows, axis=1)[:, :w * bits].reshape(h, w, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (bitsarr * weights).sum(-1, dtype=np.uint8)


def _open_bmp(data: bytes):
    """The header and palette, checked as PIL's `BmpImageFile._open`
    checks them (a `ValueError` where it raises) → (width, height, bits,
    compression, layout, row direction, data offset, palette or None,
    gray mode or None)."""
    if not data.startswith(b"BM"):
        raise ValueError("not a BMP")
    offset = _u32(data, 10)
    size = _u32(data, 14)
    head = data[18:14 + size]
    if len(head) < size - 4:
        raise ValueError("BMP: truncated header")
    direction = -1
    if size == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", head)
        comp, colors, padding = _RAW, 0, 3
    elif size in (40, 52, 56, 64, 108, 124):
        w, hraw, _, bits, comp = struct.unpack_from("<IIHHI", head)
        if head[7] == 0xFF:                              # top-down rows
            direction, h = 1, 2 ** 32 - hraw
        else:
            h = hraw
        colors = struct.unpack_from("<I", head, 28)[0]
        padding = 4
    else:
        raise ValueError(f"BMP: unsupported header type ({size})")
    if w * h > MAX_IMAGE_PIXELS:
        raise ValueError(f"BMP of {w}x{h} = {w * h} pixels exceeds "
                         f"MAX_IMAGE_PIXELS ({MAX_IMAGE_PIXELS}): a "
                         f"possible decompression bomb")
    pos = 14 + size                                    # after the header
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    elif offset == 0:              # PIL reads on from the palette's end
        offset = pos + (padding * colors if bits <= 8 else 0)
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP: unsupported pixel depth ({bits})")
    layout = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR",
              32: "BGRX"}[bits]
    if comp == _BITFIELDS:
        if size >= 52:
            masks = struct.unpack_from("<3I", head, 36)
            alpha = struct.unpack_from("<I", head, 48)[0] if size >= 56 else 0
        else:
            masks = tuple(_u32(data, pos + 4 * i) for i in range(3))
            alpha, pos = 0, pos + 12
        key = (bits, masks + (alpha,)) if bits == 32 else (bits, masks)
        if key not in _MASK_MODES:
            raise ValueError(f"BMP: unsupported bit fields layout "
                             f"{bits} bits, masks {key[1]}")
        layout = _MASK_MODES[key]
    elif comp in (_RLE8, _RLE4):
        layout = "rle"
    elif comp != _RAW:
        raise ValueError(f"BMP: unsupported compression "
                         f"({_COMPRESSION_NAMES.get(comp, comp)})")
    palette, gray_mode = None, None
    if bits <= 8 and layout != "BGR;15" and comp != _BITFIELDS:
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP: unsupported palette size ({colors})")
        raw = data[pos:pos + padding * colors]
        entries = [raw[i * padding:i * padding + 3]
                   for i in range(len(raw) // padding + 1)]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(i < len(entries) and entries[i] == bytes((v & 255,)) * 3
               for i, v in enumerate(ramp)):
            gray_mode = "1" if colors == 2 else "L"
        else:
            table = np.zeros((256, 3), np.uint8)
            n = min(256, len(raw) // padding)
            pal = np.frombuffer(raw[:n * padding], np.uint8).reshape(
                n, padding)
            table[:n] = pal[:, 2::-1]
            palette = table
    return w, h, bits, comp, layout, direction, offset, palette, gray_mode


def check_bmp(data: bytes) -> Tuple[int, int]:
    """Raise `ValueError` where PIL's `Image.open` of a BMP would fail
    (its `verify()` checks nothing more); else → its (width, height)."""
    return _open_bmp(data)[:2]


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes → uint8 RGB [H, W, 3], as PIL's `convert("RGB")`."""
    (w, h, bits, comp, layout, direction, offset, palette,
     gray_mode) = _open_bmp(data)
    if layout == "rle":
        if bits > 8:
            raise ValueError(f"BMP: RLE compression of {bits}-bit pixels")
        if gray_mode == "1":
            raise ValueError("BMP: RLE image with a black-and-white palette "
                             "(PIL has no unpacker for it)")
        idx = _rle(data, offset, w, h, comp == _RLE4).reshape(h, w)
        if direction == -1:
            idx = idx[::-1]
        return (palette[idx] if palette is not None
                else np.repeat(idx[..., None], 3, -1))
    stride = ((w * bits + 31) >> 3) & ~3
    if gray_mode is not None or palette is not None:
        sample_bits = {"1": 1, "L": 8}.get(gray_mode, bits)
        idx = _unpack_rows(data, offset, w, h, sample_bits, stride)
        if direction == -1:
            idx = idx[::-1]
        if gray_mode == "1":
            idx = idx * np.uint8(255)
        if gray_mode is not None:
            return np.repeat(idx[..., None], 3, -1)
        return palette[idx]
    rows = _unpack_rows(data, offset, w, h, bits, stride)
    if direction == -1:
        rows = rows[::-1]
    if bits == 16:
        v = (rows[:, 0::2].astype(np.int32) | (rows[:, 1::2].astype(
            np.int32) << 8))
        green = 6 if layout == "BGR;16" else 5
        b = (v & 31) * 255 // 31
        g = ((v >> 5) & ((1 << green) - 1)) * 255 // ((1 << green) - 1)
        r = ((v >> (5 + green)) & 31) * 255 // 31
        return np.stack([r, g, b], -1).astype(np.uint8)
    px = rows.reshape(h, w, bits // 8)
    order = [layout.index(c) for c in "RGB"]
    return np.ascontiguousarray(px[..., order])
