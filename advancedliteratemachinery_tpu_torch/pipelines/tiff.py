"""TIFF decoding in NumPy: the first image of a file as Pillow 12 opens
it (`TiffImagePlugin` with libtiff 4.7), `decode_tiff(data)` equal to
`Image.open(...).convert("RGB")`. A multi-page file gives its first page,
as the JAX `load_document` does.

- Both byte orders; strips (the last one short) and tiles (edge tiles
  padded); `PlanarConfiguration` 1 and 2; `FillOrder` 2.
- Compression: none (1), CCITT Modified Huffman (2), T.4 (3) and T.6
  (4) through `pipelines/ccitt.py`, LZW (5; MSB first with the early
  change, and the old LSB-first form libtiff still reads), Deflate (8,
  32946) through stdlib `zlib`, PackBits (32773); `Predictor` 2 at 8 and
  16 bits.
- Photometric: WhiteIsZero (0) and BlackIsZero (1) at 1, 2, 4, 8 and 16
  bits, RGB (2) with or without extra samples, palette (3; the 16-bit
  `ColorMap` reduced by `// 256`, as PIL reduces it) and CMYK (5), at the
  sample layouts of PIL's `OPEN_INFO` table.

PIL takes an uncompressed file through its own decoder and any other
through libtiff, and the two differ; both are followed:

- libtiff (compressed files) undoes the fill order and the predictor,
  gives 16-bit samples in the host's order and reads planar files plane
  by plane. PIL unpacks its rows with the raw mode of `FillOrder` 1.
- PIL's own decoder (uncompressed files) reads a planar file's plane `i`
  with the one-letter raw mode `rawmode[i]` (so "RGB;R" reads "R", "G",
  "B" without the bit reversal, and 16-bit planes are read as 8-bit
  ones), and a file whose strip or tile covers the whole image from its
  last offset alone.

Then PIL's modes convert to RGB: "1" as 0/255, "L;2"/"L;4" scaled by 85
and 17 ("I" variants inverted), 16-bit gray (`I;16`) clipped at 255,
16-bit colour its high byte, premultiplied alpha (`ExtraSamples` 1)
divided out (`v * 255 // a`, 0 where a is 0), other alpha dropped, CMYK
through `Convert.c` `cmyk2rgb` without inversion. Last, the
`Orientation` tag turns or flips the image: PIL's TIFF `load_end` applies
`ImageOps.exif_transpose`, so `open().convert()` returns it turned.

JPEG-in-TIFF (6, 7), YCbCr, CIELab, float and signed samples, 12-bit
samples, BigTIFF and every other compression raise `ValueError` naming the
variant. A file is refused before any strip or tile is inflated when
the image, or one tile, holds more than MAX_IMAGE_PIXELS pixels.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from advancedliteratemachinery_tpu_torch.pipelines import ccitt
from advancedliteratemachinery_tpu_torch.pipelines.jpeg import (
    MAX_IMAGE_PIXELS, _cmyk_rgb)

# tag types → struct codes (rationals as pairs; ASCII and UNDEFINED as
# bytes); the integer ones, which PIL's size and tile checks take
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 13: "I", 16: "Q"}
_INTEGER_TYPES = {3, 4, 6, 8, 9, 13, 16}
# PIL reads BYTE, ASCII and UNDEFINED values as bytes or str, which its
# layout checks refuse in these tags (raw files: in these too)
_BYTES_TYPES = {1, 2, 7}
_LAYOUT_TAGS = (256, 257, 258, 259, 262, 266, 277, 338, 339)
_RAW_LAYOUT_TAGS = (278, 322, 323)
_COMPRESSION = {1: "raw", 2: "ccitt", 3: "group3", 4: "group4", 5: "lzw",
                8: "deflate", 32946: "deflate", 32773: "packbits"}
_UNSUPPORTED_COMPRESSION = {
    6: "old-style JPEG-in-TIFF (compression 6)",
    7: "JPEG-in-TIFF (compression 7)", 32771: "TIFF raw 16 (32771)",
    32809: "ThunderScan TIFF (32809)", 34676: "SGILog TIFF (34676)",
    34677: "SGILog24 TIFF (34677)", 34925: "LZMA TIFF (34925)",
    50000: "Zstandard TIFF (50000)", 50001: "WebP-in-TIFF (50001)"}
_PHOTOMETRIC_NAMES = {6: "YCbCr TIFF", 8: "CIELab TIFF", 4: "mask TIFF"}

# PIL's OPEN_INFO for the layouts decoded here: (photometric, fill order,
# bits per sample, extra samples) → (mode, raw mode); big-endian files
# differ only at 16-bit gray ("I;16B", BlackIsZero only)
_OPEN = {
    (0, 1, (1,), ()): ("1", "1;I"), (0, 2, (1,), ()): ("1", "1;IR"),
    (1, 1, (1,), ()): ("1", "1"), (1, 2, (1,), ()): ("1", "1;R"),
    (0, 1, (2,), ()): ("L", "L;2I"), (0, 2, (2,), ()): ("L", "L;2IR"),
    (1, 1, (2,), ()): ("L", "L;2"), (1, 2, (2,), ()): ("L", "L;2R"),
    (0, 1, (4,), ()): ("L", "L;4I"), (0, 2, (4,), ()): ("L", "L;4IR"),
    (1, 1, (4,), ()): ("L", "L;4"), (1, 2, (4,), ()): ("L", "L;4R"),
    (0, 1, (8,), ()): ("L", "L;I"), (0, 2, (8,), ()): ("L", "L;IR"),
    (1, 1, (8,), ()): ("L", "L"), (1, 2, (8,), ()): ("L", "L;R"),
    (0, 1, (16,), ()): ("I;16", "I;16"), (1, 1, (16,), ()): ("I;16", "I;16"),
    (1, 2, (16,), ()): ("I;16", "I;16R"),
    (1, 1, (8, 8), (2,)): ("LA", "LA"),
    (2, 1, (8, 8, 8), ()): ("RGB", "RGB"),
    (2, 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (2, 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (2, 1, (16, 16, 16), ()): ("RGB", "RGB;16"),
    (2, 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16"),
    (2, 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16"),
    (2, 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16"),
    (2, 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16"),
    (3, 1, (1,), ()): ("P", "P;1"), (3, 2, (1,), ()): ("P", "P;1R"),
    (3, 1, (2,), ()): ("P", "P;2"), (3, 2, (2,), ()): ("P", "P;2R"),
    (3, 1, (4,), ()): ("P", "P;4"), (3, 2, (4,), ()): ("P", "P;4R"),
    (3, 1, (8,), ()): ("P", "P"), (3, 2, (8,), ()): ("P", "P;R"),
    (3, 1, (8, 8), (0,)): ("P", "PX"), (3, 1, (8, 8), (2,)): ("PA", "PA"),
    (5, 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (5, 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16"),
}
# uncompressed layouts PIL has no unpacker for
_RAW_REFUSED = {"L;IR", "P;1R", "P;2R", "P;4R"}
_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "LA": 2, "PA": 2, "RGB": 3,
          "RGBA": 4, "CMYK": 4}
# layouts PIL reads only from little-endian files
_LITTLE_ONLY = {(0, 1, (16,), ()), (1, 2, (16,), ())}
# the rest of PIL's OPEN_INFO: (byte order, photometric, sample format,
# fill order, bits, extra samples) that PIL opens and the port does not
# decode (12-bit, signed 16-bit, 32-bit and float gray; YCbCr; CIELab)
_PIL_ONLY = {
    ("II", 1, (1,), 1, (12,), ()), ("II", 1, (1,), 1, (32,), ()),
    *((bo, 1, (2,), 1, (16,), ()) for bo in ("II", "MM")),
    *((bo, p, (f,), 1, (32,), ()) for bo in ("II", "MM")
      for p, f in ((0, 3), (1, 2), (1, 3))),
    *((bo, 6, (1,), 1, b, ()) for bo in ("II", "MM")
      for b in ((8,), (8, 8, 8))),
    *((bo, 8, (1,), 1, (8, 8, 8), ()) for bo in ("II", "MM"))}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)


def _ifd(data: bytes, strict: bool = True):
    """The first IFD, read as PIL's `ImageFileDirectory_v2.load` reads it
    → (byte order, {tag: (type, values)}). A truncated IFD or a value
    past the file's end raises when `strict`, else ends the read with the
    tags before it, as PIL's does (BigTIFF too)."""
    if data[:4] in (b"II*\x00", b"II\x00*", b"II+\x00"):
        bo = "<"
    elif data[:4] in (b"MM\x00*", b"MM*\x00", b"MM\x00+"):
        bo = ">"
    else:
        raise ValueError("not a TIFF")
    big = data[2] == 43
    head = 16 if big else 8
    if len(data) < head:
        raise ValueError("TIFF: truncated header")
    at = struct.unpack(bo + ("Q" if big else "I"),
                       data[8:16] if big else data[4:8])[0]
    if not at:
        raise ValueError("TIFF: no image in the file")
    if at >= 2 ** 63:
        raise ValueError("TIFF: unable to seek to the first IFD")
    entry, inline = (20, 8) if big else (12, 4)
    tags: Dict[int, tuple] = {}

    def stop(why):
        if strict:
            raise ValueError(f"TIFF: {why}")
        return bo, tags

    count_fmt = bo + ("Q" if big else "H")
    width = struct.calcsize(count_fmt)
    if at + width > len(data):
        return stop("truncated IFD")
    n = struct.unpack(count_fmt, data[at:at + width])[0]
    at += width
    for i in range(n):
        raw = data[at + entry * i:at + entry * (i + 1)]
        if len(raw) < entry:
            return stop("truncated IFD")
        tag, typ = struct.unpack(bo + "HH", raw[:4])
        count = struct.unpack(bo + ("Q" if big else "I"), raw[4:4 + inline])[0]
        field = raw[4 + inline:]
        if typ not in _TYPES:
            continue                            # PIL skips unknown types
        fmt = _TYPES[typ]
        size = struct.calcsize(bo + fmt) * count
        if size > inline:
            off = struct.unpack(bo + ("Q" if big else "I"), field)[0]
            field = data[off:off + size]
            if len(field) < size:
                return stop(f"tag {tag} lies past the file's end")
        if not size:
            continue
        tags[tag] = (typ, struct.unpack(bo + fmt * count, field[:size]))
    return bo, tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else v[1][0]


def _all(tags, tag, default=()):
    v = tags.get(tag)
    return default if v is None else tuple(v[1])


def _int(tags, tag) -> bool:
    """Whether PIL reads the tag as an int (present, of an integer type,
    not ASCII or UNDEFINED)."""
    return tag in tags and tags[tag][0] in _INTEGER_TYPES


def _lzw(raw: bytes, need: int) -> bytes:
    """TIFF LZW (libtiff `tif_lzw.c`) → the first `need` bytes: MSB-first
    codes widening one code early, or the old LSB-first form (a stream
    that starts 0x00 0x01) without the early change."""
    old = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
    b = np.frombuffer(raw + bytes(3), np.uint8).astype(np.int32)
    if old:
        win = (b[:-2] | (b[1:-1] << 8) | (b[2:] << 16)).tolist()
    else:
        win = ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()
    early = 0 if old else 1
    base = [bytes((i,)) for i in range(256)] + [b"", b""]
    table = base[:]
    out = bytearray()
    total = 8 * len(raw)
    pos, size, prev = 0, 9, None
    while len(out) < need:
        if pos + size > total:
            raise ValueError("TIFF LZW: not enough data (no EOI before the "
                             "strip is full)")
        w = win[pos >> 3]
        code = ((w >> (pos & 7)) if old else
                (w >> (24 - (pos & 7) - size))) & ((1 << size) - 1)
        pos += size
        if code == 256:                                      # clear
            table, size, prev = base[:], 9, None
            continue
        if code == 257:                                      # EOI
            break
        if prev is None:
            if code > 256:
                raise ValueError("TIFF LZW: corrupted table")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                if not entry:
                    raise ValueError("TIFF LZW: corrupted table")
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError("TIFF LZW: corrupted table")
            if len(table) >= 4096 + 1024:
                raise ValueError("TIFF LZW: corrupted table")
            table.append(prev + entry[:1])
            if len(table) >= (1 << size) - early and size < 12:
                size += 1
        out += entry
        prev = entry
    if len(out) < need:
        raise ValueError("TIFF LZW: not enough data")
    return bytes(out[:need])


def _packbits(raw: bytes, need: int) -> bytes:
    """PackBits (libtiff `tif_packbits.c`) → `need` bytes; a run past
    them is cut, as libtiff discards it."""
    out = bytearray()
    at, n = 0, len(raw)
    while len(out) < need and at < n:
        c = raw[at]
        at += 1
        if c < 128:
            out += raw[at:at + c + 1]
            at += c + 1
        elif c > 128:
            if at >= n:
                break
            out += raw[at:at + 1] * (257 - c)
            at += 1
    if len(out) < need:
        raise ValueError("TIFF PackBits: not enough data")
    return bytes(out[:need])


def _inflate(raw: bytes, need: int) -> bytes:
    try:
        out = zlib.decompressobj().decompress(raw, need)
    except zlib.error as e:
        raise ValueError(f"TIFF Deflate: {e}") from None
    if len(out) < need:
        raise ValueError("TIFF Deflate: not enough data")
    return out


def _predict(rows: np.ndarray, spp: int, bits: int) -> np.ndarray:
    """Undo `Predictor` 2 on rows of samples [n, w * spp] (horizontal
    differences, each sample of a pixel on its own)."""
    n = rows.shape[0]
    dt = np.uint8 if bits == 8 else np.uint16
    x = rows.reshape(n, -1, spp)
    return np.cumsum(x, axis=1, dtype=dt).reshape(n, -1)


def _samples(buf: bytes, rows: int, width: int, spp: int, bits: int,
             order: str) -> np.ndarray:
    """`rows` byte-padded rows of `width` pixels × `spp` samples →
    [rows, width * spp] (uint8 for ≤ 8 bits, else uint16)."""
    stride = (width * spp * bits + 7) // 8
    a = np.frombuffer(buf, np.uint8, rows * stride).reshape(rows, stride)
    if bits == 8:
        return a
    if bits == 16:
        return a.view(order + "u2").reshape(rows, -1).astype(np.uint16)
    b = np.unpackbits(a, axis=1)[:, :width * spp * bits].reshape(
        rows, -1, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (b * weights).sum(-1, dtype=np.uint8)


def _to_rgb(px: np.ndarray, mode: str, rawmode: str, bits: int,
            colormap) -> np.ndarray:
    """Samples [H, W, spp] → RGB as PIL unpacks `rawmode` into `mode` and
    converts it."""
    if mode == "1":
        v = px[..., 0] != 0
        if "I" in rawmode:
            v = ~v
        return np.repeat((v * np.uint8(255))[..., None], 3, -1)
    if mode in ("L", "LA"):
        v = px[..., 0]
        if bits < 8:
            v = v * np.uint8(255 // ((1 << bits) - 1))
        if "I" in rawmode.split(";")[-1]:
            v = 255 - v
        return np.repeat(v.astype(np.uint8)[..., None], 3, -1)
    if mode == "I;16":
        return np.repeat(np.minimum(px[..., 0], 255).astype(np.uint8)[
            ..., None], 3, -1)
    if mode in ("P", "PA"):
        cmap = np.asarray(colormap, np.int64)
        n = len(cmap) // 3
        table = np.zeros((256, 3), np.uint8)
        table[:min(n, 256)] = (cmap.reshape(3, n).T // 256)[:256]
        return table[px[..., 0]]
    v = (px >> 8).astype(np.uint8) if bits == 16 else px.astype(np.uint8)
    if mode == "CMYK":
        return _cmyk_rgb(v[..., 0], v[..., 1], v[..., 2], v[..., 3])
    rgb = v[..., :3]
    if rawmode.startswith("RGBa"):
        a = v[..., 3:4].astype(np.int64)
        un = np.minimum(rgb.astype(np.int64) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, un))
    return np.ascontiguousarray(rgb).astype(np.uint8)


def _setup(data: bytes, strict: bool):
    """The first IFD and PIL's `TiffImageFile._setup` checks of it (a
    `ValueError` where it raises) → (byte order, tags, compression,
    photometric, key of PIL's `OPEN_INFO`, sample format)."""
    bo, tags = _ifd(data, strict)
    if 0xBC01 in tags:
        raise ValueError("TIFF: Windows Media Photo is not read")
    comp = _one(tags, 259, 1)
    if any(tags[t][0] in _BYTES_TYPES for t in _LAYOUT_TAGS + (
            _RAW_LAYOUT_TAGS if comp == 1 else ()) if t in tags):
        raise ValueError("TIFF: a layout tag of a byte or text type")
    if comp not in _COMPRESSION and comp not in _UNSUPPORTED_COMPRESSION:
        raise ValueError(f"TIFF: unknown compression {comp}")
    photo = 6 if comp == 6 else _one(tags, 262, 0)
    fill = _one(tags, 266, 1)
    if 256 not in tags or 257 not in tags:
        raise ValueError("TIFF: missing dimensions")
    if not (_int(tags, 256) and _int(tags, 257)):
        raise ValueError("TIFF: invalid dimensions")
    W, H = _one(tags, 256), _one(tags, 257)
    fmt = _all(tags, 339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = _all(tags, 258, (1,))
    extra = _all(tags, 338)
    spp = _one(tags, 277, 3 if comp == 6 and photo in (2, 6) else 1)
    if spp > 6:
        raise ValueError("TIFF: more samples a pixel than PIL reads")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("TIFF: unknown data organization")
    key = (photo, fill, tuple(bps), tuple(extra))
    pil_key = ("MM" if bo == ">" else "II", photo, fmt, fill, tuple(bps),
               tuple(extra))
    if not ((fmt == (1,) and key in _OPEN and not (
            bo == ">" and key in _LITTLE_ONLY)) or pil_key in _PIL_ONLY
            or (fmt == (2,) and key == (1, 1, (8,), ()))):
        raise ValueError(f"TIFF: unknown pixel layout (photometric {photo}, "
                         f"sample format {fmt}, fill order {fill}, bits "
                         f"{bps}, extra samples {extra})")
    if comp == 1:
        if 273 not in tags and 324 not in tags:
            raise ValueError("TIFF: unknown data organization")
        if 273 not in tags and not (_int(tags, 322) and _int(tags, 323)):
            raise ValueError("TIFF: invalid tile dimensions")
    if key in _OPEN and _OPEN[key][0] in ("P", "PA") and 320 not in tags:
        raise ValueError("TIFF: palette image without a ColorMap")
    if W * H > MAX_IMAGE_PIXELS:
        raise ValueError(f"TIFF of {W}x{H} = {W * H} pixels exceeds "
                         f"MAX_IMAGE_PIXELS ({MAX_IMAGE_PIXELS}): a "
                         f"possible decompression bomb")
    return bo, tags, comp, photo, key, fmt


def check_tiff(data: bytes) -> Tuple[int, int]:
    """Raise `ValueError` where PIL's `Image.open` of a TIFF would fail
    (its `verify()` checks nothing more); else → PIL's `size` (width,
    height; swapped by an `Orientation` of 5-8)."""
    _, tags, _, _, _, _ = _setup(data, strict=False)
    w, h = _one(tags, 256), _one(tags, 257)
    return (h, w) if _one(tags, 274) in (5, 6, 7, 8) else (w, h)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes → the first image as uint8 RGB [H, W, 3], as PIL's
    `convert("RGB")`."""
    bo, tags, comp, photo, key, fmt = _setup(data, strict=True)
    if comp in _UNSUPPORTED_COMPRESSION:
        raise ValueError(f"{_UNSUPPORTED_COMPRESSION[comp]} is not decoded "
                         f"by the port (queued)")
    if photo in _PHOTOMETRIC_NAMES:
        raise ValueError(f"{_PHOTOMETRIC_NAMES[photo]} is not decoded by "
                         f"the port (queued)")
    if key not in _OPEN or fmt not in ((1,), (2,)):
        raise ValueError(f"TIFF with sample format {fmt} and bits {key[2]} "
                         f"(signed, float or 12-bit samples) is not decoded "
                         f"by the port (queued)")
    if any(tags[t][0] not in _INTEGER_TYPES for t in _LAYOUT_TAGS
           + _RAW_LAYOUT_TAGS + (273, 279, 284, 292, 293, 317, 320, 324, 325)
           if t in tags):
        raise ValueError("TIFF: a layout tag of a non-integer type")
    kind = _COMPRESSION[comp]
    W, H = _one(tags, 256), _one(tags, 257)
    photo, fill, bps, extra = key
    spp = len(bps)
    planar = _one(tags, 284, 1)
    mode, rawmode = _OPEN[key]
    bits = bps[0]
    colormap = _all(tags, 320) or None
    tiled = 324 in tags
    if tiled:
        tw, th = _one(tags, 322), _one(tags, 323)
        offsets, counts = _all(tags, 324), _all(tags, 325) or None
    else:
        tw, th = W, _one(tags, 278, H)
        offsets, counts = _all(tags, 273), _all(tags, 279) or None
    if not tw or not th:
        raise ValueError("TIFF: zero rows a strip or zero tile size")
    if tiled and tw * th > MAX_IMAGE_PIXELS:
        raise ValueError(f"TIFF tile of {tw}x{th} = {tw * th} pixels exceeds "
                         f"MAX_IMAGE_PIXELS ({MAX_IMAGE_PIXELS}): a possible "
                         f"decompression bomb")
    if planar == 2 and spp == 1:
        planar = 1 if kind != "raw" else 2
    if kind == "raw":
        if rawmode in _RAW_REFUSED:
            raise ValueError(f"TIFF: uncompressed layout {rawmode} (PIL has "
                             f"no unpacker for it)")
        if planar == 2:          # the planes' one-letter raw modes
            letters = [rawmode[i] if i < len(rawmode) else "?"
                       for i in range(spp)]
            if not all(c in (mode if mode in ("RGB", "RGBA", "CMYK") else
                             {"1": "1", "L": "L", "P": "P"}.get(mode, ""))
                       for c in letters):
                raise ValueError(f"TIFF: uncompressed planar layout "
                                 f"{rawmode} (PIL has no unpacker for it)")
            # PIL's count of samples: the photometric's, plus the extra
            px = _raw(data, bo, W, H, tw, th, offsets, bits, bps, spp,
                      planar, rawmode, letters,
                      {2: 3, 5: 4}.get(photo, 1) + len(extra))
            rawmode, bits = rawmode[:1], 1 if mode == "1" else 8
        else:
            px = _raw(data, bo, W, H, tw, th, offsets, bits, bps, spp,
                      planar, rawmode)
    else:
        if fill == 2:
            mode, rawmode = _OPEN[(photo, 1, tuple(bps), tuple(extra))]
        if planar == 2:
            # PIL reads the mode's bands' planes: strips only where they
            # are all the planes, tiles whatever follows them
            if (_BANDS[mode] != spp and not tiled) or bits not in (8, 16):
                raise ValueError(f"TIFF: planar strips of {spp} samples "
                                 f"for PIL's mode {mode} (libtiff's read "
                                 f"fails)")
            if mode == "RGBA" and tuple(extra) != (2,):
                rawmode = "RGBa"        # PIL divides planar alpha out
        px = _libtiff(data, bo, W, H, tw, th, tiled, offsets, counts, bits,
                      spp, planar, kind, fill, _one(tags, 317, 1), tags,
                      _BANDS[mode])
    return orient(_to_rgb(px, mode, rawmode, bits, colormap),
                  _one(tags, 274, 1))


def orient(rgb: np.ndarray, orientation) -> np.ndarray:
    """The image as PIL's TIFF `load_end` leaves it: `ImageOps.
    exif_transpose` by the `Orientation` tag (2-8; anything else keeps
    it)."""
    if orientation in (5, 6, 7, 8):
        rgb = np.swapaxes(rgb, 0, 1)            # x and y swapped
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation in (2, 3):
        rgb = rgb[:, ::-1]
    if orientation in (3, 4):
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def _libtiff(data, bo, W, H, tw, th, tiled, offsets, counts, bits, spp,
             planar, kind, fill, predictor, tags, bands):
    """libtiff's read of a compressed image → samples [H, W, spp]."""
    if counts is None:
        raise ValueError("TIFF: missing StripByteCounts/TileByteCounts")
    if predictor not in (1, 2):
        raise ValueError(f"TIFF predictor {predictor} (floating point) is "
                         f"not decoded by the port (queued)")
    if predictor == 2 and bits not in (8, 16):
        raise ValueError(f"TIFF: horizontal predictor with {bits}-bit "
                         f"samples (libtiff refuses it)")
    planes = min(spp, bands) if planar == 2 else 1
    per = 1 if planar == 2 else spp        # samples a pixel in one chunk
    across = -(-W // tw)
    down = -(-H // th)
    per_plane = across * down
    if len(offsets) < per_plane * planes:
        raise ValueError("TIFF: fewer strips or tiles than the image needs")
    out = np.zeros((H, W, spp), np.uint16 if bits == 16 else np.uint8)
    for plane in range(planes):
        for j in range(per_plane):
            i = plane * per_plane + j
            ty, tx = divmod(j, across)
            y0, x0 = ty * th, tx * tw
            rows = th if tiled else min(th, H - y0)
            cw = tw
            need = rows * ((cw * per * bits + 7) // 8)
            off = offsets[i]
            raw = data[off:off + counts[i]]
            if len(raw) < counts[i]:
                raise ValueError("TIFF: strip or tile past the file's end")
            if fill == 2:
                raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
            if kind == "lzw":
                buf = _lzw(raw, need)
            elif kind == "deflate":
                buf = _inflate(raw, need)
            elif kind == "packbits":
                buf = _packbits(raw, need)
            else:
                if bits != 1 or spp != 1:
                    raise ValueError("TIFF: CCITT coding of more than one "
                                     "bit a pixel")
                buf = ccitt.decode(raw, cw, rows, kind, _one(tags, 292, 0),
                                   _one(tags, 293, 0))
            s = _samples(buf, rows, cw, per, bits, bo)
            if predictor == 2:
                s = _predict(s, per, bits)
            s = s.reshape(rows, cw, per)
            h, w = min(rows, H - y0), min(cw, W - x0)
            if planar == 2:
                out[y0:y0 + h, x0:x0 + w, plane] = s[:h, :w, 0]
            else:
                out[y0:y0 + h, x0:x0 + w] = s[:h, :w]
    return out


def _raw(data, bo, W, H, tw, th, offsets, bits, bps, spp, planar, rawmode,
         letters=None, n_samples=None):
    """PIL's own decoder of an uncompressed image → samples [H, W, spp]
    (planar files: plane i as the one-letter raw mode `letters[i]` reads
    it, 8 bits a sample, or 1 for "1")."""
    if tw == W and th == H and planar != 2:
        offsets = offsets[-1:]
    wide = bits == 16 and planar != 2
    # rows no strip reaches stay 0 in PIL's mode: the top sample value
    # under an inverting raw mode
    inverted = planar != 2 and "I" in rawmode.split(";")[-1]
    out = np.full((H, W, spp), (1 << bits) - 1 if inverted else 0,
                  np.uint16 if wide else np.uint8)
    x = y = layer = 0
    for off in offsets:
        x1, y1 = min(x + tw, W), min(y + th, H)
        cw, rows = x1 - x, y1 - y
        if planar == 2:
            if layer >= spp:
                break
            sbits, per = (1 if letters[layer] == "1" else 8), 1
        else:
            sbits, per = bits, spp
        row_bytes = (cw * per * sbits + 7) // 8
        stride = (int(tw * sum(bps) / 8 / (n_samples if planar == 2 else 1))
                  if x + tw > W else row_bytes)
        stride = stride or row_bytes
        if off + stride * (rows - 1) + row_bytes > len(data):
            raise ValueError("TIFF: image file is truncated")
        a = np.frombuffer(data, np.uint8, count=min(len(data) - off,
                                                    stride * rows),
                          offset=off)
        buf = np.zeros(stride * rows, np.uint8)
        buf[:len(a)] = a
        buf = buf.reshape(rows, stride)[:, :row_bytes]
        if rawmode.endswith("R") and planar != 2:
            buf = _REVERSE[buf]
        s = _samples(buf.tobytes(), rows, cw, per, sbits, bo)
        s = s.reshape(rows, cw, per)
        if planar == 2:
            out[y:y1, x:x1, layer] = s[..., 0]
        else:
            out[y:y1, x:x1] = s
        x += tw
        if x >= W:
            x, y = 0, y + th
            if y >= H:
                y, layer = 0, layer + 1
    return out
