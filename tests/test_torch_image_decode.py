"""The port's image decoders (`pipelines/file_loading.py`, `pipelines/
jpeg.py`) against PIL's `Image.open(...).convert("RGB")`, which the JAX
`load_image` returns:

- PNG: every row filter on every colour type and bit depth PNG allows,
  plain and Adam7-interlaced, written here with `zlib`; the wavefront
  unfilter against the per-byte loop it replaced; 16-bit gray clipped at
  255 as PIL's `I;16`;
- JPEG: baseline files PIL encodes at quality 50/75/95 with 4:4:4, 4:2:2
  and 4:2:0 chroma, grayscale, optimised Huffman tables, restart markers
  and odd sizes: equal to PIL bit for bit (the stated bound, JPEG_LEVELS,
  is 0); progressive, CMYK and 12-bit files raise a `ValueError` naming
  the variant; the committed smoke pages decode to their recorded
  hashes;
- `ops/image.py` `resize_bicubic_u8` against PIL's default
  `Image.resize(size)` (BICUBIC) on seeded RGB pages: downscales,
  upscales, odd sizes and one axis unchanged, bit-equal, where a float
  bicubic with antialias parts from PIL by a level on many pixels."""

import hashlib
import io
import json
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from advancedliteratemachinery_tpu_torch.ops.image import resize_bicubic_u8
from advancedliteratemachinery_tpu_torch.pipelines import (
    file_loading as tload, jpeg as tjpeg)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
JPEG_LEVELS = 0          # largest uint8 difference from PIL allowed
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def unfilter_loop(raw, h, stride, bpp):
    """The per-byte loop `_unfilter` replaced: the reference."""
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = bytes(stride)
    for y in range(h):
        kind, cur = rows[y, 0], bytearray(rows[y, 1:].tobytes())
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            elif kind == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                        else c)
            else:
                pred = 0
            cur[i] = (cur[i] + pred) & 0xFF
        out[y] = np.frombuffer(bytes(cur), np.uint8)
        prior = bytes(cur)
    return out


def filter_rows(data: np.ndarray, bpp: int, filters) -> bytes:
    """Byte rows [h, stride] → PNG filtered scanlines, row y taking
    filters[y % len]."""
    data = data.astype(np.int64)
    raw = bytearray()
    prior = np.zeros(data.shape[1], np.int64)
    for y, cur in enumerate(data):
        f = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if f == 4:
            pa, pb, pc = (abs(prior - ul), abs(left - ul),
                          abs(left + prior - 2 * ul))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, ul))
        else:
            pred = [0 * cur, left, prior, (left + prior) // 2][f]
        raw += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur
    return bytes(raw)


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, ch] → PNG byte rows [h, stride]."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint16)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, -1).astype(
            np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def png_file(samples, ctype, depth, filters=(0, 1, 2, 3, 4), interlace=0,
             palette=None) -> bytes:
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += filter_rows(pack_rows(sub, depth), bpp, filters)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


PNG_CASES = [(c, d) for c, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                      (3, (1, 2, 4, 8)), (4, (8, 16)),
                                      (6, (8, 16)))
             for d in depths]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", PNG_CASES)
def test_png_every_type_and_depth_matches_pil(ctype, depth, interlace):
    rng = np.random.default_rng(10 * ctype + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) - 1
    h, w = 13, 11                   # odd: every Adam7 pass partly filled
    samples = rng.integers(0, top + 1, (h, w, ch))
    samples[2:6, 3:9] = top // 3               # a flat block
    palette = (rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
               if ctype == 3 else None)
    data = png_file(samples, ctype, depth, interlace=interlace,
                    palette=palette)
    got = tload.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, pil_rgb(data))


def test_png_16bit_gray_clips_like_pil():
    """PIL opens 16-bit gray as mode I;16, whose convert("RGB") clips at
    255 (not its high byte): 250, 500, 750 → 250, 255, 255."""
    samples = np.array([[[250], [500], [750], [3]]])
    data = png_file(samples, 0, 16, filters=(0,))
    got = tload.decode_image(data)[0, :, 0]
    np.testing.assert_array_equal(got, [250, 255, 255, 3])
    np.testing.assert_array_equal(tload.decode_image(data), pil_rgb(data))


@pytest.mark.parametrize("bpp,filters", [
    (3, (4,)), (3, (3,)), (1, (0, 1, 2, 3, 4)), (4, (4, 1, 3, 2, 0, 4, 4)),
    (6, (2, 3)), (2, (1, 0, 4))])
def test_unfilter_wavefront_matches_the_loop(bpp, filters):
    """The anti-diagonal wavefront against the per-byte loop it replaced,
    rows of mixed filters included (the wavefront spans the first to the
    last Average/Paeth row; the rows around it decode a row at a time)."""
    rng = np.random.default_rng(bpp)
    h, w = 19, 23
    rows = rng.integers(0, 256, (h, w * bpp), dtype=np.uint8)
    rows[4:9] = rows[3]                        # repeats: small residuals
    raw = filter_rows(rows, bpp, filters)
    got = tload._unfilter(raw, h, w * bpp, bpp)
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(got, unfilter_loop(raw, h, w * bpp, bpp))


def jpeg_bytes(image: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", **kw)
    return buf.getvalue()


def jpeg_page(h, w, seed=0):
    """Noise, a flat block and smooth ramps: every coefficient size and
    the chroma edges the upsampling filters."""
    rng = np.random.default_rng(seed)
    page = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    page[h // 4:h // 2, w // 5:w // 2] = (200, 30, 90)
    yy, xx = np.mgrid[:h, :w]
    ramp = np.stack([(xx * 3) % 256, (yy * 2) % 256, (xx + yy) % 256], -1)
    page[h // 2:] = ramp[h // 2:]
    return page


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_baseline_jpeg_matches_pil(quality, subsampling):
    for hw, kw in (((37, 53), {}), ((64, 48), {"optimize": True}),
                   ((17, 9), {"restart_marker_blocks": 3}),
                   ((31, 130), {"restart_marker_rows": 1}), ((1, 1), {})):
        page = jpeg_page(*hw, seed=quality + subsampling)
        data = jpeg_bytes(page, quality=quality, subsampling=subsampling,
                          **kw)
        got = tload.decode_image(data)
        assert got.shape == (*hw, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - pil_rgb(data)).max()
        assert diff <= JPEG_LEVELS, (hw, kw, diff)


def test_grayscale_jpeg_matches_pil():
    page = jpeg_page(29, 41, seed=3)
    for quality in (50, 95):
        data = jpeg_bytes(np.asarray(Image.fromarray(page).convert("L")),
                          quality=quality)
        got = tload.decode_image(data)
        assert (got[..., 0] == got[..., 2]).all()
        assert np.abs(got.astype(int) - pil_rgb(data)).max() <= JPEG_LEVELS


def test_unsupported_jpeg_variants_raise():
    page = jpeg_page(24, 24)
    progressive = jpeg_bytes(page, progressive=True)
    with pytest.raises(ValueError, match="progressive JPEG"):
        tload.decode_image(progressive)
    buf = io.BytesIO()
    Image.fromarray(page).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        tload.decode_image(buf.getvalue())
    data = bytearray(jpeg_bytes(page))
    at = data.index(b"\xff\xc0")
    data[at + 4] = 12                               # 12-bit samples
    with pytest.raises(ValueError, match="12-bit"):
        tload.decode_image(bytes(data))


def test_jpeg_bomb_refused_before_decoding():
    data = bytearray(jpeg_bytes(jpeg_page(8, 8)))
    at = data.index(b"\xff\xc0")
    data[at + 5:at + 9] = struct.pack(">HH", 20000, 20000)
    with pytest.raises(ValueError, match="decompression bomb"):
        tload.decode_image(bytes(data))


def test_committed_smoke_jpegs_decode_to_their_hashes():
    """`chip_smoke.py` reads two JPEG pages it cannot make (the card's
    machine has no PIL): their recorded hashes are PIL's decodes, and the
    port's decode equals PIL's."""
    record = json.loads((FIXTURES / "smoke_pages_jpeg.json").read_text())
    for name, want in record.items():
        data = (FIXTURES / name).read_bytes()
        pil = pil_rgb(data)
        assert hashlib.sha256(pil.tobytes()).hexdigest() == want["sha256"]
        assert list(pil.shape) == want["shape"]
        np.testing.assert_array_equal(tjpeg.decode_jpeg(data), pil)


def seeded_page(h, w, seed):
    """Noise over a smooth ramp: every level, and edges of every size."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    ramp = np.stack([yy * 255 // max(h - 1, 1), xx * 255 // max(w - 1, 1),
                     (xx + 2 * yy) % 256], -1)
    noise = rng.integers(-60, 61, (h, w, 3))
    return np.clip(ramp + noise * (rng.random((h, 1, 1)) < 0.5), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("src,dst", [
    ((100, 76), (64, 64)),        # downscale both axes
    ((1210, 901), (640, 640)),    # a large page, factors 1.9 and 1.4
    ((37, 53), (640, 640)),       # upscale ~17x
    ((301, 299), (150, 641)),     # down one axis, up the other
    ((480, 640), (640, 640)),     # width unchanged: one pass
    ((64, 64), (64, 31)),         # height unchanged, odd width
    ((5, 7), (3, 2)),
])
def test_bicubic_resize_bit_equal_to_pil(src, dst):
    page = seeded_page(*src, seed=sum(src))
    want = np.asarray(Image.fromarray(page).resize(dst[::-1]))
    got = resize_bicubic_u8(page, dst)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (*dst, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    on_tensor = resize_bicubic_u8(torch.from_numpy(page), dst)
    np.testing.assert_array_equal(on_tensor.numpy(), want)


def test_float_bicubic_is_not_pil():
    """The trap the fixed-point passes avoid: torch's float bicubic with
    antialias, rounded, leaves PIL's result by a level on many pixels."""
    page = seeded_page(1210, 901, seed=2111)
    want = np.asarray(Image.fromarray(page).resize((640, 640)))
    x = torch.from_numpy(page).permute(2, 0, 1)[None].float()
    flt = F.interpolate(x, (640, 640), mode="bicubic", antialias=True,
                        align_corners=False)
    flt = flt[0].permute(1, 2, 0).round().clamp(0, 255).numpy()
    assert (flt != want).mean() > 0.01
    np.testing.assert_array_equal(
        resize_bicubic_u8(page, (640, 640)).numpy(), want)
