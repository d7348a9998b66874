"""Baseline JPEG decoding in NumPy, as PIL's libjpeg-turbo (6.2 API)
decodes it: `decode_jpeg(data)` equals `Image.open(...).convert("RGB")`.

- Frames: SOF0 and SOF1 with 8-bit samples, one component (gray, given
  as RGB) or three (YCbCr), any sampling factors, interleaved or not,
  with restart intervals (DRI/RSTn) and any Huffman tables (optimised
  ones too). Progressive (SOF2), lossless and hierarchical frames,
  arithmetic coding, 12-bit samples, CMYK/YCCK and Adobe RGB files raise
  `ValueError` naming the variant: they are queued, and nothing falls
  back.
- Huffman decoding looks up 16 bits at a time, as libjpeg's `jdhuff.c`
  does with its lookahead: one table entry gives a short code's run, its
  length with its magnitude bits and the coefficient's value, so the
  Python loop takes one step per coefficient.
- Dequantisation and libjpeg's integer ISLOW IDCT (`jidctint.c`: 13-bit
  constants, 2 extra bits between the passes, its range-limit table) run
  on all blocks at once in int64.
- Chroma is upsampled as libjpeg-turbo's "fancy" upsampling does
  (`jdsample.c`: the triangle filter for h2v1, h1v2 and h2v2, edge
  samples replicated), other integral factors by replication, then
  converted with `jdcolor.c`'s fixed-point YCbCr→RGB tables and cropped
  to the frame.
"""

from __future__ import annotations

import functools
import re
import struct
from typing import Dict, List

import numpy as np

# the most pixels an image may have: PIL's DecompressionBombError limit
# (twice its Image.MAX_IMAGE_PIXELS)
MAX_IMAGE_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)

# the natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_UNSUPPORTED_SOF = {
    0xC2: "progressive JPEG (SOF2)", 0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)", 0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded JPEG (SOF10)",
    0xCB: "arithmetic-coded JPEG (SOF11)",
    0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)",
    0xCF: "arithmetic-coded JPEG (SOF15)"}

# entries of the AC lookup table (16 peeked bits → one int):
# > 0, a whole coefficient: bits used | run << 5 | (value + 2048) << 9;
# < 0, -(code length | kind << 5 | run << 7 | size << 11) with kind
# EOB, ZRL or LONG (magnitude bits past the 16 peeked); 0, no code
_EOB, _ZRL, _LONG = 1, 2, 3


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _unsupported(what: str) -> ValueError:
    return ValueError(f"{what} is not decoded by the port (queued; only "
                      f"baseline JPEG is); convert the file to baseline "
                      f"JPEG or PNG")


def _extend(raw, size):
    """JPEG's sign extension of a `size`-bit magnitude category."""
    return np.where(raw < (1 << size) >> 1, raw - (1 << size) + 1, raw)


@functools.lru_cache(maxsize=16)
def _huffman_lut(counts: bytes, symbols: bytes, ac: bool) -> List[int]:
    """A table's canonical codes → its 65536-entry lookup table on the
    next 16 bits (AC: the entries above; DC: bits used | (diff + 4096) << 5
    when code and magnitude fit in 16 bits, else -(code length | size <<
    11)). Tables repeat from file to file (most encoders write the
    standard ones), so the last 16 are kept; the decoder only reads
    them."""
    length = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    code, at = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            if code >= 1 << n:
                raise ValueError("JPEG: bad Huffman table")
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            length[lo:hi], sym[lo:hi] = n, symbols[at]
            code, at = code + 1, at + 1
        code <<= 1
    peek = np.arange(1 << 16, dtype=np.int64)
    size = (sym & 15) if ac else sym
    run = (sym >> 4) if ac else 0 * sym
    total = length + size
    fits = total <= 16
    raw = (peek >> np.clip(16 - total, 0, 16)) & ((1 << size) - 1)
    value = _extend(raw, size)
    if ac:
        entry = np.where(fits, total | (run << 5) | ((value + 2048) << 9),
                         -(length | (_LONG << 5) | (run << 7)
                           | (size << 11)))
        entry = np.where(sym == 0x00, -(length | (_EOB << 5)), entry)
        entry = np.where(sym == 0xF0, -(length | (_ZRL << 5)), entry)
    else:
        entry = np.where(fits, total | ((value + 4096) << 5),
                         -(length | (size << 11)))
    return np.where(length == 0, 0, entry).tolist()


def _windows(segment: bytes) -> List[int]:
    """The unstuffed entropy bytes → for each byte offset the 40 bits that
    start there (zeros past the end, as libjpeg inserts)."""
    b = np.frombuffer(segment.replace(b"\xff\x00", b"\xff") + bytes(8),
                      np.uint8).astype(np.int64)
    n = len(b) - 4
    w = b[:n] << 32
    for i in range(1, 5):
        w |= b[i:i + n] << (32 - 8 * i)
    return w.tolist()


def _decode_interval(win, blocks, dc_luts, ac_luts, out):
    """Huffman-decode the blocks of one restart interval: `blocks` lists
    (component slot, flat offset of the block's coefficients) in scan
    order; each coefficient is appended to `out` as (flat offset + zigzag
    index) << 16 | (value + 32768)."""
    pos = 0
    pred = [0] * len(dc_luts)
    for c, base in blocks:
        dlut, alut = dc_luts[c], ac_luts[c]
        w = win[pos >> 3]
        e = dlut[(w >> (24 - (pos & 7))) & 0xFFFF]
        if e > 0:
            pos += e & 31
            diff = (e >> 5) - 4096
        elif e < 0:
            e = -e
            pos += e & 31
            size = e >> 11
            w = win[pos >> 3]
            raw = (w >> (40 - (pos & 7) - size)) & ((1 << size) - 1)
            pos += size
            diff = (raw - (1 << size) + 1 if size and raw < 1 << (size - 1)
                    else raw)
        else:
            raise ValueError("JPEG: corrupt data (no DC code)")
        pred[c] += diff
        base <<= 16
        out(base | (pred[c] + 32768))
        k = 1
        while k < 64:
            w = win[pos >> 3]
            e = alut[(w >> (24 - (pos & 7))) & 0xFFFF]
            if e > 0:
                pos += e & 31
                k += (e >> 5) & 15
                out(base | (k << 16) | ((e >> 9) + 30720))
                k += 1
                continue
            if e == 0:
                raise ValueError("JPEG: corrupt data (no AC code)")
            e = -e
            pos += e & 31
            kind = (e >> 5) & 3
            if kind == _EOB:
                break
            if kind == _ZRL:
                k += 16
                continue
            size = e >> 11
            w = win[pos >> 3]
            raw = (w >> (40 - (pos & 7) - size)) & ((1 << size) - 1)
            pos += size
            k += (e >> 7) & 15
            out(base | (k << 16) | (32768 + (
                raw - (1 << size) + 1 if raw < 1 << (size - 1) else raw)))
            k += 1
        if k > 64:
            raise ValueError("JPEG: corrupt data (run past the block)")


# jidctint.c's constants (CONST_BITS = 13)
_C = {"0.298631336": 2446, "0.390180644": 3196, "0.541196100": 4433,
      "0.765366865": 6270, "0.899976223": 7373, "1.175875602": 9633,
      "1.501321110": 12299, "1.847759065": 15137, "1.961570560": 16069,
      "2.053119869": 16819, "2.562915447": 20995, "3.072711026": 25172}


def _idct_pass(x, shift):
    """One 1-D pass of `jpeg_idct_islow` along the last axis of int64
    [..., 8], descaled by `shift` bits."""
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * _C["0.541196100"]
    tmp2 = z1 - z3 * _C["1.847759065"]
    tmp3 = z1 + z2 * _C["0.765366865"]
    tmp0 = (x[..., 0] + x[..., 4]) << 13
    tmp1 = (x[..., 0] - x[..., 4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _C["1.175875602"]
    t0 = t0 * _C["0.298631336"]
    t1 = t1 * _C["2.053119869"]
    t2 = t2 * _C["3.072711026"]
    t3 = t3 * _C["1.501321110"]
    z1 = z1 * -_C["0.899976223"]
    z2 = z2 * -_C["2.562915447"]
    z3 = z3 * -_C["1.961570560"] + z5
    z4 = z4 * -_C["0.390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], -1)
    return (out + (1 << (shift - 1))) >> shift


def _idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """int32 [N, 64] coefficients (natural order), quant [64] → uint8
    [N, 8, 8] samples, as `jpeg_idct_islow` with its range limit."""
    x = (coefs.astype(np.int64) * quant).reshape(-1, 8, 8)
    cols = _idct_pass(np.swapaxes(x, 1, 2), 13 - 2)     # columns first
    rows = _idct_pass(np.swapaxes(cols, 1, 2), 13 + 2 + 3)
    # the post-IDCT range-limit table: 10 bits, wrapping, then clamped
    rows = ((rows + 512) & 1023) - 512
    return np.clip(rows + 128, 0, 255).astype(np.uint8)


def _fancy_h2(x: np.ndarray, bias_even: int, bias_odd: int,
              shift: int) -> np.ndarray:
    """Double the last axis by the triangle filter: even outputs
    (3·near + left + bias_even) >> shift, odd (3·near + right + bias_odd)
    >> shift, edge samples their own neighbours."""
    left = np.concatenate([x[..., :1], x[..., :-1]], -1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], -1)
    out = np.empty(x.shape[:-1] + (2 * x.shape[-1],), np.int32)
    out[..., 0::2] = (3 * x + left + bias_even) >> shift
    out[..., 1::2] = (3 * x + right + bias_odd) >> shift
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's samples [h, w] (its downsampled size) → upsampled by
    (fh, fv) as libjpeg-turbo's `jdsample.c` with fancy upsampling."""
    h, w = plane.shape
    x = plane.astype(np.int32)
    if (fh, fv) == (2, 1) and w > 2:
        return _fancy_h2(x, 1, 2, 2)
    if (fh, fv) == (1, 2):
        return np.swapaxes(_fancy_h2(x.T, 1, 2, 2), 0, 1)
    if (fh, fv) == (2, 2) and w > 2:
        up = np.concatenate([x[:1], x[:-1]])
        down = np.concatenate([x[1:], x[-1:]])
        colsum = np.stack([3 * x + up, 3 * x + down], 1).reshape(2 * h, w)
        return _fancy_h2(colsum, 8, 7, 4)
    return np.repeat(np.repeat(x, fv, 0), fh, 1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """`jdcolor.c` `ycc_rgb_convert` with its fixed-point tables
    (SCALEBITS 16)."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half = 1 << 15
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _read_frame(data: bytes):
    """Markers → (frame header, quant tables, scans), each scan (its
    component indices with their table ids, restart interval, its
    restart intervals' entropy bytes)."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG")
    pos, frame, adobe = 2, None, None
    quant: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    restart, scans = 0, []
    while True:
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError("JPEG: no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                                  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise ValueError("JPEG: truncated marker segment")
        n = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + n]
        pos += n
        if marker in _UNSUPPORTED_SOF:
            raise _unsupported(_UNSUPPORTED_SOF[marker])
        if marker == 0xCC:
            raise _unsupported("arithmetic-coded JPEG (DAC)")
        if marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDB:                                # DQT
            at = 0
            while at < len(body):
                prec, tid = body[at] >> 4, body[at] & 15
                count = 64 * (2 if prec else 1)
                vals = np.frombuffer(body[at + 1:at + 1 + count],
                                     ">u2" if prec else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                quant[tid] = table
                at += 1 + count
        elif marker == 0xC4:                                # DHT
            at = 0
            while at < len(body):
                cls, tid = body[at] >> 4, body[at] & 15
                counts = bytes(body[at + 1:at + 17])
                total = sum(counts)
                symbols = bytes(body[at + 17:at + 17 + total])
                (ac_tabs if cls else dc_tabs)[tid] = _huffman_lut(
                    counts, symbols, bool(cls))
                at += 17 + total
        elif marker == 0xDD:                                # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker in (0xC0, 0xC1):                        # SOF0/1
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise _unsupported(f"{prec}-bit JPEG")
            if h == 0:
                raise _unsupported("JPEG with its height in a DNL marker")
            if w * h > MAX_IMAGE_PIXELS:
                raise ValueError(f"JPEG of {w}x{h} = {w * h} pixels "
                                 f"exceeds MAX_IMAGE_PIXELS "
                                 f"({MAX_IMAGE_PIXELS}): a possible "
                                 f"decompression bomb")
            comps = [struct.unpack(">BBB", body[6 + 3 * i:9 + 3 * i])
                     for i in range(nc)]
            frame = (h, w, [(cid, hv >> 4, hv & 15, tq)
                            for cid, hv, tq in comps])
        elif marker == 0xDA:                                # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            ns = body[0]
            ids = [c[0] for c in frame[2]]
            members = []
            for i in range(ns):
                cid, tables = body[1 + 2 * i], body[2 + 2 * i]
                if cid not in ids:
                    raise ValueError(f"JPEG: scan names component {cid}")
                try:
                    members.append((ids.index(cid), dc_tabs[tables >> 4],
                                    ac_tabs[tables & 15]))
                except KeyError:
                    raise ValueError("JPEG: scan uses an undefined "
                                     "Huffman table") from None
            end = re.compile(rb"\xff(?![\x00\xd0-\xd7\xff])").search(
                data, pos)
            stop = end.start() if end else len(data)
            intervals = re.split(rb"\xff[\xd0-\xd7]", data[pos:stop])
            scans.append((members, restart, intervals))
            pos = stop
    if frame is None or not scans:
        raise ValueError("JPEG: no frame or no scan")
    nc = len(frame[2])
    if nc == 4:
        raise _unsupported("CMYK/YCCK JPEG")
    if nc not in (1, 3):
        raise _unsupported(f"JPEG with {nc} components")
    if nc == 3 and adobe == 0:
        raise _unsupported("Adobe RGB JPEG (no colour transform)")
    return frame, quant, scans


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes → uint8 RGB [H, W, 3], as PIL's
    `Image.open(...).convert("RGB")`."""
    (H, W, comps), quant, scans = _read_frame(data)
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if any(hmax % h or vmax % v for _, h, v, _ in comps):
        raise _unsupported("JPEG with non-integral sampling factors")
    mcux = _ceil_div(W, 8 * hmax)
    mcuy = _ceil_div(H, 8 * vmax)
    # every component's blocks on its MCU-padded grid, in one flat array
    grids = [(mcuy * v, mcux * h) for _, h, v, _ in comps]
    first = np.cumsum([0] + [by * bx for by, bx in grids])
    packed: List[int] = []
    for members, restart, intervals in scans:
        if len(members) == 1:              # non-interleaved: the component
            ci = members[0][0]             # blocks inside the image only
            _, h, v, _ = comps[ci]
            nby = _ceil_div(_ceil_div(H * v, vmax), 8)
            nbx = _ceil_div(_ceil_div(W * h, hmax), 8)
            rows, cols = np.divmod(np.arange(nby * nbx), nbx)
            offs = [(first[ci] + rows * grids[ci][1] + cols) * 64]
            slots = [np.zeros(len(rows), np.int64)]
            per_mcu = 1
        else:                              # interleaved MCUs
            my, mx = np.divmod(np.arange(mcuy * mcux), mcux)
            offs, slots = [], []
            for slot, (ci, _, _) in enumerate(members):
                _, h, v, _ = comps[ci]
                yy, xx = np.divmod(np.arange(v * h), h)
                b = ((my[:, None] * v + yy) * grids[ci][1]
                     + mx[:, None] * h + xx)
                offs.append((first[ci] + b) * 64)
                slots.append(np.full(b.shape, slot))
            per_mcu = sum(o.shape[1] for o in offs)
        order = list(zip(np.concatenate(slots, -1).ravel().tolist(),
                         np.concatenate(offs, -1).ravel().tolist()))
        dc = [m[1] for m in members]
        ac = [m[2] for m in members]
        step = restart * per_mcu if restart else len(order)
        for i, start in enumerate(range(0, len(order), step)):
            if i >= len(intervals):
                raise ValueError("JPEG: missing restart interval data")
            _decode_interval(_windows(intervals[i]),
                             order[start:start + step], dc, ac,
                             packed.append)
    coefs = np.zeros(int(first[-1]) * 64, np.int32)
    packed = np.asarray(packed, np.int64)
    flat = packed >> 16
    coefs[(flat & ~63) | ZIGZAG[flat & 63]] = (packed & 0xFFFF) - 32768
    coefs = coefs.reshape(-1, 64)
    planes = []
    for ci, (_, h, v, tq) in enumerate(comps):
        if tq not in quant:
            raise ValueError(f"JPEG: quantisation table {tq} not defined")
        by, bx = grids[ci]
        px = _idct_islow(coefs[first[ci]:first[ci + 1]], quant[tq])
        plane = px.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(
            by * 8, bx * 8)
        dh, dw = _ceil_div(H * v, vmax), _ceil_div(W * h, hmax)
        plane = _upsample(plane[:dh, :dw], hmax // h, vmax // v)
        planes.append(plane[:H, :W])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, -1)
    return _ycc_to_rgb(*planes)
