"""Document file loading: images and (multi-page) PDFs → uint8 RGB arrays
(port of `advancedliteratemachinery_tpu/pipelines/file_loading.py`;
reference Applications/DocXChain/modules/file_loading.py:22).

The card's machine has no PIL, so `load_image` decodes two formats itself:
8-bit non-interlaced PNG (gray, gray + alpha, RGB, RGBA and palette;
stdlib `zlib` and the five PNG row filters), converted as PIL's
`convert("RGB")` does (alpha dropped, gray replicated, palette looked
up), and `.npy` arrays (uint8 [H, W], [H, W, 3] or [H, W, 4]). Any other
format raises `ImportError` naming PIL. As PIL refuses a decompression
bomb, `decode_png` refuses an image of more than MAX_IMAGE_PIXELS pixels
before it inflates anything, and inflates no more than the image's
rows hold. PDF rasterization takes whichever
of PyMuPDF (`fitz`) and `pdf2image` is present, as in the JAX package.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import List

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
NPY_MAGIC = b"\x93NUMPY"
# colour type → samples a pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the most pixels an image may have: PIL's DecompressionBombError limit
# (twice its Image.MAX_IMAGE_PIXELS)
MAX_IMAGE_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) →
    uint8 [h, stride]."""
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:         # Sub: running sums per byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """8-bit non-interlaced PNG bytes → uint8 RGB [H, W, 3]."""
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
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in _PNG_CHANNELS:
        raise ImportError(
            f"PNG with bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}: only 8-bit non-interlaced PNGs decode without "
            f"PIL; install Pillow for other images")
    if w * h > MAX_IMAGE_PIXELS:
        raise ValueError(f"PNG of {w}x{h} = {w * h} pixels exceeds "
                         f"MAX_IMAGE_PIXELS ({MAX_IMAGE_PIXELS}): a "
                         f"possible decompression bomb")
    ch = _PNG_CHANNELS[ctype]
    size = h * (w * ch + 1)              # the filter byte and samples a row
    raw = zlib.decompressobj().decompress(b"".join(idat), size)
    if len(raw) < size:
        raise ValueError(f"PNG: {len(raw)} bytes of image data, {size} "
                         f"expected")
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        return palette[px[..., 0]]
    if ch <= 2:                                   # gray (+ alpha)
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _from_npy(data: bytes) -> np.ndarray:
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[-1] not in (3, 4)):
        raise ValueError(f".npy image must be uint8 [H, W], [H, W, 3] or "
                         f"[H, W, 4]; got {arr.dtype} {arr.shape}")
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes (PNG or `.npy`) → uint8 RGB [H, W, 3]."""
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(NPY_MAGIC):
        return _from_npy(data)
    raise ImportError("only PNG and .npy images decode without PIL; "
                      "install Pillow (PIL) for other formats")


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
