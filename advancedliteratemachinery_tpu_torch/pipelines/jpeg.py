"""JPEG decoding in NumPy, as PIL's libjpeg-turbo (6.2 API) decodes it:
`decode_jpeg(data)` equals `Image.open(...).convert("RGB")`.

- Frames: SOF0 and SOF1 (sequential) and SOF2 (progressive) with 8-bit
  samples, any sampling factors, interleaved scans or not, restart
  intervals (DRI/RSTn) and any Huffman tables (optimised ones too).
- Colour: one component (gray, given as RGB); three as YCbCr, or RGB
  where libjpeg's `default_decompress_parms` says so (an Adobe marker
  with transform 0 and no JFIF marker, or component ids R, G, B); four
  as CMYK (Adobe transform 0, or no Adobe marker) or YCCK (any other
  transform; `jdcolor.c` `ycck_cmyk_convert`), which PIL reads as
  inverted `CMYK;I` samples and converts with `Convert.c` `cmyk2rgb`.
- Progressive scans decode into one coefficient array a component: DC
  first and refinement scans (interleaved or not), AC first scans with
  EOB runs, and AC refinement with its correction bits (ITU T.81
  G.1.2.3). A file whose scans leave any of the first ten AC
  coefficients of a component not fully refined is block-smoothed as
  libjpeg-turbo 3.1 smooths it (`jdcoefct.c` `smoothing_ok`,
  `decompress_smooth_data`): each such coefficient still zero is
  estimated from the 5x5 neighbourhood of quantised DC values (with the
  DC itself interpolated where no AC data came), edge blocks repeating
  their last row or column. Files written with libjpeg's default
  progression (PIL's `progressive=True`) refine every coefficient.
- Lossless and hierarchical frames, arithmetic coding and 12-bit samples
  raise `ValueError` naming the variant: they are queued, and nothing
  falls back.
- Huffman decoding looks up 16 bits at a time, as libjpeg's `jdhuff.c`
  does with its lookahead: one table entry gives a short code's run, its
  length with its magnitude bits and the coefficient's value, so the
  Python loop takes one step per coefficient (per coefficient position
  of a band in an AC refinement scan). DC refinement scans, one bit a
  block, are read in NumPy.
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
    0xC3: "lossless JPEG (SOF3)",
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
# EOB (every run/size symbol of size 0 but ZRL; its run is a progressive
# EOB run's r), ZRL or LONG (magnitude bits past the 16 peeked); 0, no
# code
_EOB, _ZRL, _LONG = 1, 2, 3


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _unsupported(what: str) -> ValueError:
    return ValueError(f"{what} is not decoded by the port (queued; "
                      f"baseline and progressive Huffman-coded 8-bit JPEG "
                      f"are); convert the file to baseline JPEG or PNG")


def _extend(raw, size):
    """JPEG's sign extension of a `size`-bit magnitude category."""
    return np.where(raw < (1 << size) >> 1, raw - (1 << size) + 1, raw)


@functools.lru_cache(maxsize=32)
def _huffman_lut(counts: bytes, symbols: bytes, ac: bool) -> List[int]:
    """A table's canonical codes → its 65536-entry lookup table on the
    next 16 bits (AC: the entries above; DC: bits used | (diff + 4096) << 5
    when code and magnitude fit in 16 bits, else -(code length | size <<
    11)). Tables repeat from file to file (most encoders write the
    standard ones; a progressive file has one a scan), so the last 32
    are kept; the decoder only reads
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
        entry = np.where((size == 0) & (sym != 0xF0),
                         -(length | (_EOB << 5) | (run << 7)), entry)
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


# libjpeg-turbo's block smoothing (jdcoefct.c `smoothing_ok`) reads the
# first SAVED_COEFS coefficients' precision and these quantisers
_SMOOTH_COEFS = 10
_SMOOTH_QUANT = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
# block smoothing on (libjpeg-turbo's default, PIL's); off only in the
# control that shows a smoothed file's plain decode misses PIL's
_SMOOTHING = True


def _read_frame(data: bytes):
    """Markers → (frame header, progressive?, colour space, quant tables,
    scans), each scan (its members: component index with its Huffman
    tables' (counts, symbols) or None; restart interval; (Ss, Se, Ah,
    Al); its restart intervals' entropy bytes)."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG")
    pos, frame, adobe, jfif, progressive = 2, None, None, False, False
    quant: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, tuple] = {}
    ac_tabs: Dict[int, tuple] = {}
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
        if marker == 0xE0 and body.startswith(b"JFIF\x00") and len(body) >= 12:
            jfif = True                     # libjpeg's APP0_DATA_LEN - 2
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
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
                (ac_tabs if cls else dc_tabs)[tid] = (
                    counts, bytes(body[at + 17:at + 17 + total]))
                at += 17 + total
        elif marker == 0xDD:                                # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker in (0xC0, 0xC1, 0xC2):                  # SOF0/1/2
            progressive = marker == 0xC2
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
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            members = []
            for i in range(ns):
                cid, tables = body[1 + 2 * i], body[2 + 2 * i]
                if cid not in ids:
                    raise ValueError(f"JPEG: scan names component {cid}")
                # a table the scan does not use may be undefined
                members.append((ids.index(cid), dc_tabs.get(tables >> 4),
                                ac_tabs.get(tables & 15)))
            end = re.compile(rb"\xff(?![\x00\xd0-\xd7\xff])").search(
                data, pos)
            stop = end.start() if end else len(data)
            intervals = re.split(rb"\xff[\xd0-\xd7]", data[pos:stop])
            scans.append((members, restart, (ss, se, a >> 4, a & 15),
                          intervals))
            pos = stop
    if frame is None or not scans:
        raise ValueError("JPEG: no frame or no scan")
    return frame, progressive, _colour_space(frame, jfif, adobe), quant, \
        scans


def _colour_space(frame, jfif: bool, adobe) -> str:
    """The coded colour space as libjpeg's `default_decompress_parms`
    (jdapimin.c) tells it from the components, JFIF and Adobe markers."""
    comps = frame[2]
    if len(comps) == 1:
        return "gray"
    if len(comps) == 3:
        if jfif:
            return "ycc"
        if adobe is not None:
            return "rgb" if adobe == 0 else "ycc"
        return "rgb" if [c[0] for c in comps] == [82, 71, 66] else "ycc"
    if len(comps) == 4:
        return "cmyk" if adobe is None or adobe == 0 else "ycck"
    raise _unsupported(f"JPEG with {len(comps)} components")


def _lut(table, ac: bool) -> List[int]:
    if table is None:
        raise ValueError("JPEG: scan uses an undefined Huffman table")
    return _huffman_lut(table[0], table[1], ac)


def _scan_blocks(members, comps, grids, first, H, W, hmax, vmax):
    """A scan's blocks in coding order → (component slot of each, global
    block index of each, blocks an MCU). A non-interleaved scan covers
    the component's blocks inside the image, ceil(w/8) × ceil(h/8) of
    its own size; an interleaved one whole MCUs."""
    mcux = _ceil_div(W, 8 * hmax)
    mcuy = _ceil_div(H, 8 * vmax)
    if len(members) == 1:
        ci = members[0][0]
        _, h, v, _ = comps[ci]
        nby = _ceil_div(_ceil_div(H * v, vmax), 8)
        nbx = _ceil_div(_ceil_div(W * h, hmax), 8)
        rows, cols = np.divmod(np.arange(nby * nbx), nbx)
        return (np.zeros(len(rows), np.int64),
                first[ci] + rows * grids[ci][1] + cols, 1)
    my, mx = np.divmod(np.arange(mcuy * mcux), mcux)
    blocks, slots = [], []
    for slot, (ci, _, _) in enumerate(members):
        _, h, v, _ = comps[ci]
        yy, xx = np.divmod(np.arange(v * h), h)
        blocks.append(first[ci] + (my[:, None] * v + yy) * grids[ci][1]
                      + mx[:, None] * h + xx)
        slots.append(np.full(blocks[-1].shape, slot))
    return (np.concatenate(slots, -1).ravel(),
            np.concatenate(blocks, -1).ravel(),
            sum(b.shape[1] for b in blocks))


def _intervals(scan, per_mcu, n):
    """(interval's entropy bytes, its first and last block + 1) of a
    scan of `n` blocks."""
    _, restart, _, intervals = scan
    step = restart * per_mcu if restart else n
    for i, start in enumerate(range(0, n, step)):
        if i >= len(intervals):
            raise ValueError("JPEG: missing restart interval data")
        yield intervals[i], start, min(n, start + step)


def _baseline_coefs(scans, comps, grids, first, H, W, hmax, vmax):
    """Sequential scans → int32 [blocks, 64] coefficients, natural order."""
    packed: List[int] = []
    for scan in scans:
        members = scan[0]
        slots, blocks, per_mcu = _scan_blocks(members, comps, grids, first,
                                              H, W, hmax, vmax)
        order = list(zip(slots.tolist(), (blocks * 64).tolist()))
        dc = [_lut(m[1], False) for m in members]
        ac = [_lut(m[2], True) for m in members]
        for seg, a, b in _intervals(scan, per_mcu, len(order)):
            _decode_interval(_windows(seg), order[a:b], dc, ac,
                             packed.append)
    coefs = np.zeros(int(first[-1]) * 64, np.int32)
    packed = np.asarray(packed, np.int64)
    flat = packed >> 16
    coefs[(flat & ~63) | ZIGZAG[flat & 63]] = (packed & 0xFFFF) - 32768
    return coefs.reshape(-1, 64)


def _bits(win, pos, n):
    return (win[pos >> 3] >> (40 - (pos & 7) - n)) & ((1 << n) - 1)


def _dc_first(win, blocks, slots, luts, al, coef):
    """A DC first scan's interval: each block's DC difference, predicted
    from its component's last DC, shifted up by Al."""
    pos = 0
    pred = [0] * len(luts)
    out = []
    for c in slots:
        e = luts[c][(win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
        if e > 0:
            pos += e & 31
            diff = (e >> 5) - 4096
        elif e < 0:
            e = -e
            pos += e & 31
            size = e >> 11
            raw = _bits(win, pos, size)
            pos += size
            diff = (raw - (1 << size) + 1 if size and raw < 1 << (size - 1)
                    else raw)
        else:
            raise ValueError("JPEG: corrupt data (no DC code)")
        pred[c] += diff
        out.append(pred[c] << al)
    coef[blocks, 0] = out


def _dc_refine(seg, blocks, al, coef):
    """A DC refinement scan's interval: one bit a block, in NumPy."""
    bits = np.unpackbits(np.frombuffer(
        seg.replace(b"\xff\x00", b"\xff"), np.uint8))[:len(blocks)]
    bits = np.pad(bits, (0, len(blocks) - len(bits))).astype(np.int32)
    coef[blocks, 0] |= bits << al


def _ac_first(win, blocks, lut, ss, se, al, coef):
    """An AC first scan's interval (one component): run/size codes from
    Ss to Se, EOB runs spanning blocks (ITU T.81 G.1.2.2)."""
    pos, eobrun = 0, 0
    at, vals = [], []
    for blk in blocks:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = lut[(win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
            if e > 0:
                pos += e & 31
                k += (e >> 5) & 15
                at.append(blk * 64 + k)
                vals.append(((e >> 9) - 2048) << al)
                k += 1
                continue
            if e == 0:
                raise ValueError("JPEG: corrupt data (no AC code)")
            e = -e
            pos += e & 31
            kind = (e >> 5) & 3
            if kind == _EOB:
                r = (e >> 7) & 15
                eobrun = (1 << r) + (_bits(win, pos, r) if r else 0) - 1
                pos += r
                break
            if kind == _ZRL:
                k += 16
                continue
            size = e >> 11
            raw = _bits(win, pos, size)
            pos += size
            k += (e >> 7) & 15
            at.append(blk * 64 + k)
            vals.append((raw - (1 << size) + 1 if raw < 1 << (size - 1)
                         else raw) << al)
            k += 1
        if k > se + 1:
            raise ValueError("JPEG: corrupt data (run past the band)")
    if at:
        coef.reshape(-1)[np.asarray(at)] = vals


def _ac_refine(win, blocks, lut, ss, se, al, coef):
    """An AC refinement scan's interval (ITU T.81 G.1.2.3, libjpeg's
    `decode_mcu_AC_refine`): a correction bit for each coefficient
    already nonzero that a zero run or an EOB run passes, read between
    the run counts, and newly nonzero coefficients of ±2^Al."""
    p1, m1 = 1 << al, -1 << al
    rows = coef[blocks].tolist()
    pos, eobrun = 0, 0
    for row in rows:
        k = ss
        if not eobrun:
            while k <= se:
                e = lut[(win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
                if e > 0:
                    pos += e & 31
                    r = (e >> 5) & 15
                    if ((e >> 9) - 2048) not in (1, -1):
                        raise ValueError("JPEG: corrupt data (refinement "
                                         "coefficient of more than 1 bit)")
                    s = p1 if (e >> 9) > 2048 else m1
                elif e == 0:
                    raise ValueError("JPEG: corrupt data (no AC code)")
                else:
                    e = -e
                    pos += e & 31
                    kind = (e >> 5) & 3
                    if kind == _EOB:
                        r = (e >> 7) & 15
                        eobrun = (1 << r) + (_bits(win, pos, r) if r else 0)
                        pos += r
                        break
                    if kind == _ZRL:
                        r, s = 15, 0
                    else:               # a 16-bit code and its sign bit
                        if e >> 11 != 1:
                            raise ValueError(
                                "JPEG: corrupt data (refinement "
                                "coefficient of more than 1 bit)")
                        r = (e >> 7) & 15
                        s = p1 if _bits(win, pos, 1) else m1
                        pos += 1
                while k <= se:
                    c = row[k]
                    if c:
                        if (win[pos >> 3] >> (39 - (pos & 7))) & 1 and \
                                not c & p1:
                            row[k] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    elif r:
                        r -= 1
                    else:
                        break
                    k += 1
                if s:
                    if k > se:
                        raise ValueError("JPEG: corrupt data (run past "
                                         "the band)")
                    row[k] = s
                k += 1
        if eobrun:
            for k in range(k, se + 1):
                c = row[k]
                if c:
                    if (win[pos >> 3] >> (39 - (pos & 7))) & 1 and \
                            not c & p1:
                        row[k] = c + p1 if c >= 0 else c + m1
                    pos += 1
            eobrun -= 1
    coef[blocks] = rows


def _progressive_coefs(scans, comps, grids, first, H, W, hmax, vmax,
                       quant):
    """Progressive scans → int32 [blocks, 64] coefficients, natural order,
    block-smoothed where libjpeg-turbo smooths them."""
    coef = np.zeros((int(first[-1]), 64), np.int32)        # zigzag order
    coef_bits = np.full((len(comps), 64), -1)
    for scan in scans:
        members, _, (ss, se, ah, al), _ = scan
        if ss > se or se > 63 or (ss == 0) != (se == 0) or (
                ss and len(members) != 1):
            raise ValueError(f"JPEG: bad progression parameters Ss={ss} "
                             f"Se={se}")
        slots, blocks, per_mcu = _scan_blocks(members, comps, grids, first,
                                              H, W, hmax, vmax)
        if ss == 0 and ah == 0:
            luts = [_lut(m[1], False) for m in members]
        elif ss:
            lut = _lut(members[0][2], True)
        for seg, a, b in _intervals(scan, per_mcu, len(blocks)):
            if ss == 0 and ah:
                _dc_refine(seg, blocks[a:b], al, coef)
                continue
            win = _windows(seg)
            if ss == 0:
                _dc_first(win, blocks[a:b], slots[a:b].tolist(), luts, al,
                          coef)
            elif ah == 0:
                _ac_first(win, blocks[a:b].tolist(), lut, ss, se, al, coef)
            else:
                _ac_refine(win, blocks[a:b], lut, ss, se, al, coef)
        for ci, _, _ in members:
            coef_bits[ci, ss:se + 1] = al
    natural = np.empty_like(coef)
    natural[:, ZIGZAG] = coef
    if _smoothing_ok(comps, quant, coef_bits):
        _block_smooth(natural, coef_bits, comps, grids, first, H, W, hmax,
                      vmax, quant)
    return natural


def _smoothing_ok(comps, quant, coef_bits) -> bool:
    """`jdcoefct.c` `smoothing_ok`: every component's DC coded and its DC
    and first nine AC quantisers nonzero, and some component's first
    nine AC coefficients not all refined to full precision."""
    if not _SMOOTHING:
        return False
    for ci, (_, _, _, tq) in enumerate(comps):
        q = quant.get(tq)
        if (q is None or coef_bits[ci, 0] < 0
                or not q[list(_SMOOTH_QUANT)].all()):
            return False
    return bool((coef_bits[:, 1:_SMOOTH_COEFS] != 0).any())


# `decompress_smooth_data`'s estimates: natural position → the
# weights of the 5x5 neighbourhood of quantised DC values (rows
# -2..2 × columns -2..2) when some AC data is known (None: not
# estimated then), and when none is (with the DC interpolated too)
_SMOOTH_TAPS = {
    1: (  # AC01
        [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7],
         [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
        [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
         [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]]),
    8: (  # AC10
        [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0, 0, 0, 0, 0],
         [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],
        [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0, 0, 0, 0, 0],
         [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]]),
    16: (  # AC20
        [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
         [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]],
        [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
         [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]]),
    9: (  # AC11
        [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0],
         [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]],
        [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
         [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]]),
    2: (  # AC02
        [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-1, 13, -24, 13, -1],
         [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
        [[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1],
         [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]]),
    3: (  # AC03
        None,
        [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
         [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]]),
    10: (  # AC12
        None,
        [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0],
         [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]]),
    17: (  # AC21
        None,
        [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, -3, 0, 3, 0],
         [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]]),
    24: (  # AC30
        None,
        [[0, 0, 0, 0, 0], [0, 1, 2, 1, 0], [0, 0, 0, 0, 0],
         [0, -1, -2, -1, 0], [0, 0, 0, 0, 0]]),
}
_SMOOTH_DC = [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
              [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
              [-2, -6, -8, -6, -2]]


def _neighbour_rows(height: int, v: int, total: int) -> np.ndarray:
    """For each block row r < height of a component (v block rows an
    iMCU row, `total` iMCU rows) → the rows `decompress_smooth_data`
    reads as r-2 .. r+2: its clamps count rows on the padded grid, and
    in the last iMCU row by that row's own count of block rows."""
    out = np.zeros((height, 5), np.int64)
    for r in range(height):
        R, b = divmod(r, v)
        if R < total - 1:
            rows, at, n = v, r, v * total
        else:
            rows = height % v or v
            at, n = R * rows + b, rows * total
        prev = r - 1 if at > 0 else r
        prev2 = r - 2 if at > 1 else prev
        nxt = r + 1 if at < n - 1 else r
        nxt2 = r + 2 if at < n - 2 else nxt
        out[r] = (prev2, prev, r, nxt, nxt2)
    return out


def _block_smooth(natural, coef_bits, comps, grids, first, H, W, hmax,
                  vmax, quant):
    """libjpeg-turbo's `decompress_smooth_data` on the quantised blocks of
    every component, in place: a zero coefficient among the first nine
    AC ones whose precision is not full (`coef_bits` not 0) is estimated
    from the 5x5 neighbourhood of quantised DC values, clamped below 2^Al
    when Al > 0; a component with no AC data at all also has its DC
    interpolated. Edge blocks repeat their row's or column's last DC."""
    total = _ceil_div(H, 8 * vmax)
    for ci, (_, h, v, tq) in enumerate(comps):
        by, bx = grids[ci]
        height = _ceil_div(_ceil_div(H * v, vmax), 8)
        width = _ceil_div(_ceil_div(W * h, hmax), 8)
        q = quant[tq].astype(np.int64)
        blocks = natural[first[ci]:first[ci + 1]].reshape(by, bx, 64)
        dc = blocks[..., 0].astype(np.int64)
        rows = _neighbour_rows(height, v, total)
        cols = np.clip(np.arange(width)[:, None] + np.arange(-2, 3), 0,
                       width - 1)
        grid = dc[rows[:, :, None, None], cols[None, None, :, :]]
        grid = grid.transpose(0, 2, 1, 3)          # [height, width, 5, 5]
        bits = coef_bits[ci]
        change_dc = bool((bits[1:_SMOOTH_COEFS] == -1).all())
        work = blocks[:height, :width].astype(np.int64)
        for k, (pos, (taps, dc_taps)) in enumerate(_SMOOTH_TAPS.items()):
            al = int(bits[k + 1])
            if al == 0 or (taps is None and not change_dc):
                continue
            weights = np.asarray(dc_taps if change_dc else taps, np.int64)
            num = q[0] * (grid * weights).sum((-2, -1))
            qk = int(q[pos])
            pred = ((qk << 7) + np.abs(num)) // (qk << 8)
            if al > 0:
                pred = np.minimum(pred, (1 << al) - 1)
            pred = np.where(num >= 0, pred, -pred)
            work[..., pos] = np.where(work[..., pos] == 0, pred,
                                      work[..., pos])
        if change_dc:
            num = q[0] * (grid * np.asarray(_SMOOTH_DC)).sum((-2, -1))
            pred = ((q[0] << 7) + np.abs(num)) // (q[0] << 8)
            work[..., 0] = np.where(num >= 0, pred, -pred)
        blocks[:height, :width] = work


def _cmyk_rgb(c, m, y, k) -> np.ndarray:
    """PIL's CMYK (inverted `CMYK;I` samples, as its JPEG plugin reads
    every 4-component file) → RGB: Convert.c `cmyk2rgb`."""
    nk = 255 - k.astype(np.int64)

    def channel(v):
        t = v.astype(np.int64) * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)

    return np.stack([channel(c), channel(m), channel(y)], -1).astype(
        np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline or progressive JPEG bytes → uint8 RGB [H, W, 3], as PIL's
    `Image.open(...).convert("RGB")`."""
    (H, W, comps), progressive, space, quant, scans = _read_frame(data)
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if any(hmax % h or vmax % v for _, h, v, _ in comps):
        raise _unsupported("JPEG with non-integral sampling factors")
    mcux = _ceil_div(W, 8 * hmax)
    mcuy = _ceil_div(H, 8 * vmax)
    # every component's blocks on its MCU-padded grid, in one flat array
    grids = [(mcuy * v, mcux * h) for _, h, v, _ in comps]
    first = np.cumsum([0] + [by * bx for by, bx in grids])
    geometry = (comps, grids, first, H, W, hmax, vmax)
    coefs = (_progressive_coefs(scans, *geometry, quant) if progressive
             else _baseline_coefs(scans, *geometry))
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
    if space == "gray":
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, -1)
    if space == "ycc":
        return _ycc_to_rgb(*planes)
    if space == "rgb":
        return np.stack(planes, -1).astype(np.uint8)
    # libjpeg gives CMYK (YCCK's first three through `ycck_cmyk_convert`:
    # 255 - its YCbCr → RGB); PIL reads it inverted
    cmy = (_ycc_to_rgb(*planes[:3]) if space == "ycck"
           else 255 - np.stack(planes[:3], -1))
    return _cmyk_rgb(cmy[..., 0], cmy[..., 1], cmy[..., 2],
                     255 - planes[3])
