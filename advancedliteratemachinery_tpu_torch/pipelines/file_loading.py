"""Document file loading: images and (multi-page) PDFs → uint8 RGB arrays
(port of `advancedliteratemachinery_tpu/pipelines/file_loading.py`;
reference Applications/DocXChain/modules/file_loading.py:22).

The card's machine has no PIL, so `load_image` decodes the page formats
itself, each as PIL's `Image.open(...).convert("RGB")` gives it (Pillow
12.1 with libtiff 4.7 and libjpeg-turbo 3.1), told apart by signature:

- PNG of every bit depth and colour type (gray, gray + alpha, RGB, RGBA
  and palette; 1, 2, 4, 8 and 16 bits), plain or Adam7-interlaced,
  inflated with stdlib `zlib` and unfiltered here. Alpha and `tRNS` are
  dropped, gray is replicated, palettes looked up, 1-, 2- and 4-bit gray
  scaled to 8 bits; 16-bit gray is PIL's mode `I;16`, which
  `convert("RGB")` clips at 255, and 16-bit colour keeps its high byte;
- JPEG, baseline or progressive (block-smoothed as libjpeg-turbo smooths
  a file whose scans leave low AC coefficients coarse), gray, YCbCr,
  Adobe RGB, CMYK and YCCK (`pipelines/jpeg.py`); lossless,
  hierarchical, arithmetic-coded and 12-bit files raise `ValueError`
  naming the variant;
- BMP (`pipelines/bmp.py`): every header PIL reads, 1-32 bits, bit
  fields, RLE4 and RLE8;
- GIF (`pipelines/gif.py`): the first frame, on its logical screen;
- TIFF (`pipelines/tiff.py`): the first page; uncompressed, PackBits,
  LZW, Deflate and CCITT fax (`pipelines/ccitt.py`) strips or tiles, with
  the horizontal predictor, planar or not; gray, palette, RGB and CMYK;
  JPEG-in-TIFF and YCbCr raise `ValueError` naming them;
- `.npy` arrays (uint8 [H, W], [H, W, 3] or [H, W, 4]).

WebP and any other format raise `ValueError`. As PIL refuses a
decompression bomb, every decoder refuses an image of more than
MAX_IMAGE_PIXELS pixels before it inflates anything, and `decode_png`
inflates no more than the image's rows hold. PDF rasterization takes
whichever of PyMuPDF (`fitz`) and `pdf2image` is present, as in the JAX
package.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import List, Optional

import numpy as np
from numpy.lib.stride_tricks import as_strided

from advancedliteratemachinery_tpu_torch.pipelines.bmp import decode_bmp
from advancedliteratemachinery_tpu_torch.pipelines.gif import decode_gif
from advancedliteratemachinery_tpu_torch.pipelines.jpeg import (
    MAX_IMAGE_PIXELS, decode_jpeg)
from advancedliteratemachinery_tpu_torch.pipelines.tiff import decode_tiff

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
NPY_MAGIC = b"\x93NUMPY"
BMP_SIGNATURE = b"BM"
GIF_SIGNATURES = (b"GIF87a", b"GIF89a")
# PIL's TIFF prefixes (byte order and 42; BigTIFF's 43)
TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II\x00*", b"MM*\x00",
                   b"II+\x00", b"MM\x00+")
# colour type → (samples a pixel, the bit depths PNG allows)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


# filter type → its predictor of a byte from its left (a), upper (b) and
# upper-left (c) neighbours
_PREDICT = (lambda a, b, c: 0, lambda a, b, c: a, lambda a, b, c: b,
            lambda a, b, c: (a + b) >> 1, _paeth)


def _unfilter_wavefront(prior: np.ndarray, line: np.ndarray,
                        kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Rows `line` [n, stride] of any filter types below the decoded row
    `prior` → decoded uint8 [n, stride]. A byte needs only its left
    (`bpp` back), upper and upper-left neighbours, so the cells (row r,
    pixel c) of one anti-diagonal r + c are decoded together: n + stride /
    bpp NumPy steps. Diagonal d of the padded grid (row 0 the prior row,
    pixel 0 a zero column) is the contiguous row Z[d], cell (r, c) at
    Z[r + c, r]."""
    n, stride = line.shape
    P = stride // bpp
    L = (n + 1) * bpp
    D = n + P + 1
    Z = np.zeros((D, L), np.int16)
    F = np.zeros((D, L), np.int16)

    def cells(A):
        it = A.itemsize
        return as_strided(A, (n + 1, P + 1, bpp),
                          ((L + bpp) * it, L * it, it))

    cells(Z)[0, 1:] = prior.reshape(P, bpp)
    cells(F)[1:, 1:] = line.reshape(n, P, bpp)
    counts = [np.concatenate([[0], np.cumsum(kinds == t)]).tolist()
              for t in range(5)]
    masks = [np.repeat(np.concatenate([[False], kinds == t]), bpp)
             for t in range(5)]
    for d in range(2, D):
        r0, r1 = max(1, d - P), min(n, d - 1) + 1
        lo, hi = r0 * bpp, r1 * bpp
        a = Z[d - 1, lo:hi]
        b = Z[d - 1, lo - bpp:hi - bpp]
        c = Z[d - 2, lo - bpp:hi - bpp]
        kinds_here = [t for t in range(5)
                      if counts[t][r1 - 1] - counts[t][r0 - 1]]
        if len(kinds_here) == 1:
            pred = _PREDICT[kinds_here[0]](a, b, c)
        else:
            pred = 0
            for t in kinds_here:
                pred = np.where(masks[t][lo:hi], _PREDICT[t](a, b, c), pred)
        Z[d, lo:hi] = (F[d, lo:hi] + pred) & 255
    return cells(Z)[1:, 1:].reshape(n, stride).astype(np.uint8)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) →
    uint8 [h, stride]. Rows before the first and after the last Average
    or Paeth row decode a row at a time; the rows between, whose bytes
    depend on their left neighbours, in one anti-diagonal wavefront."""
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    kinds, line = rows[:, 0], rows[:, 1:]
    if h and kinds.max() > 4:
        raise ValueError(f"PNG: unknown row filter {int(kinds.max())}")
    out = np.zeros((h + 1, stride), np.uint8)        # out[0]: zero prior
    wave = np.flatnonzero(kinds >= 3)
    y0, y1 = (int(wave[0]), int(wave[-1]) + 1) if len(wave) else (h, h)

    def row_by_row(ys):
        for y in ys:
            kind, cur = kinds[y], line[y]
            if kind == 1:         # Sub: running sums per byte of a pixel
                cur = np.cumsum(cur.reshape(-1, bpp), axis=0,
                                dtype=np.uint8).reshape(-1)
            elif kind == 2:
                cur = cur + out[y]
            out[y + 1] = cur

    row_by_row(range(y0))
    if y0 < y1:
        out[y0 + 1:y1 + 1] = _unfilter_wavefront(out[y0], line[y0:y1],
                                                 kinds[y0:y1], bpp)
    row_by_row(range(y1, h))
    return out[1:]


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] → samples [h, w, ch] (uint16 for 16-bit
    images, else uint8 with 1-, 2- and 4-bit samples unpacked)."""
    h = len(rows)
    if depth == 8:
        return rows.reshape(h, w, ch)
    if depth == 16:
        v = (rows[:, 0::2].astype(np.uint16) << 8) | rows[:, 1::2]
        return v.reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :w, None]


def _png_rgb(px: np.ndarray, ctype: int, depth: int, palette) -> np.ndarray:
    """Samples [H, W, ch] → uint8 RGB as PIL's `convert("RGB")`."""
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[px[..., 0]]
    if depth == 16:                  # I;16 clips; colour keeps high bytes
        px = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(
            np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):                            # gray (+ alpha)
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (any bit depth and colour type, plain or Adam7) → uint8
    RGB [H, W, 3]."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos, idat, palette, header = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3],
                                    np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1] \
            or interlace not in (0, 1):
        raise ValueError(f"PNG: bit depth {depth} with colour type {ctype}, "
                         f"interlace {interlace} is not a valid PNG")
    if w * h > MAX_IMAGE_PIXELS:
        raise ValueError(f"PNG of {w}x{h} = {w * h} pixels exceeds "
                         f"MAX_IMAGE_PIXELS ({MAX_IMAGE_PIXELS}): a "
                         f"possible decompression bomb")
    ch = _PNG_TYPES[ctype][0]
    bits = ch * depth
    passes = [(0, 0, 1, 1)] if not interlace else _ADAM7
    dims = [(-(-(w - x0) // dx), -(-(h - y0) // dy))
            for x0, y0, dx, dy in passes]
    strides = [(pw * bits + 7) // 8 for pw, _ in dims]
    # the filter byte and samples of every row of every pass
    size = sum(ph * (s + 1) for (pw, ph), s in zip(dims, strides) if pw)
    raw = zlib.decompressobj().decompress(b"".join(idat), size)
    if len(raw) < size:
        raise ValueError(f"PNG: {len(raw)} bytes of image data, {size} "
                         f"expected")
    px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for (x0, y0, dx, dy), (pw, ph), stride in zip(passes, dims, strides):
        if not pw or not ph:
            continue
        n = ph * (stride + 1)
        rows = _unfilter(raw[at:at + n], ph, stride, max(1, bits // 8))
        px[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        at += n
    return _png_rgb(px, ctype, depth, palette)


def _from_npy(data: bytes) -> np.ndarray:
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[-1] not in (3, 4)):
        raise ValueError(f".npy image must be uint8 [H, W], [H, W, 3] or "
                         f"[H, W, 4]; got {arr.dtype} {arr.shape}")
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def other_format(data: bytes) -> Optional[str]:
    """The name of a format PIL reads that the port does not decode
    (WebP), told by its signature, else None."""
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    return None


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes (PNG, JPEG, BMP, GIF, TIFF or `.npy`), told apart
    by their magic bytes → uint8 RGB [H, W, 3]."""
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data)
    if data.startswith(NPY_MAGIC):
        return _from_npy(data)
    if data.startswith(BMP_SIGNATURE):
        return decode_bmp(data)
    if data.startswith(GIF_SIGNATURES):
        return decode_gif(data)
    if data.startswith(TIFF_SIGNATURES):
        return decode_tiff(data)
    kind = other_format(data) or "unrecognised"
    raise ValueError(f"{kind} image: the port decodes PNG, JPEG (baseline "
                     f"and progressive; gray, YCbCr, RGB, CMYK and YCCK), "
                     f"BMP, GIF, TIFF and .npy; WebP is queued")


def load_image(path: str) -> np.ndarray:
    """Image file → uint8 RGB [H, W, 3]."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def _pdf_backend():
    try:
        import fitz  # PyMuPDF
        return "fitz", fitz
    except ImportError:
        pass
    try:
        import pdf2image
        return "pdf2image", pdf2image
    except ImportError:
        return None, None


def load_pdf(path: str, dpi: int = 150) -> List[np.ndarray]:
    """PDF → list of uint8 RGB page arrays (load_pdf, file_loading.py:22)."""
    name, mod = _pdf_backend()
    if name == "fitz":
        pages = []
        with mod.open(path) as doc:
            zoom = dpi / 72.0
            for page in doc:
                pix = page.get_pixmap(matrix=mod.Matrix(zoom, zoom))
                arr = np.frombuffer(pix.samples, np.uint8).reshape(
                    pix.height, pix.width, pix.n)
                pages.append(np.ascontiguousarray(arr[..., :3]))
        return pages
    if name == "pdf2image":
        return [np.asarray(p.convert("RGB"), np.uint8)
                for p in mod.convert_from_path(path, dpi=dpi)]
    raise ImportError(
        "PDF loading needs PyMuPDF (`fitz`) or pdf2image; neither is "
        "installed in this environment. Rasterize the PDF to images "
        "externally and use load_image instead.")


def load_document(path: str, dpi: int = 150) -> List[np.ndarray]:
    """Any supported document file → list of uint8 RGB page arrays."""
    if path.lower().endswith(".pdf"):
        return load_pdf(path, dpi=dpi)
    return [load_image(path)]
