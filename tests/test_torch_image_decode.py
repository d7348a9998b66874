"""The port's image decoders (`pipelines/file_loading.py`, `pipelines/
jpeg.py`) against PIL's `Image.open(...).convert("RGB")`, which the JAX
`load_image` returns:

- PNG: every row filter on every colour type and bit depth PNG allows,
  plain and Adam7-interlaced, written here with `zlib`; the wavefront
  unfilter against the per-byte loop it replaced; 16-bit gray clipped at
  255 as PIL's `I;16`;
- JPEG: baseline and progressive files PIL encodes at quality 50/75/95
  with 4:4:4, 4:2:2 and 4:2:0 chroma, grayscale, optimised Huffman
  tables, restart markers and odd sizes, Adobe CMYK, YCCK and RGB files,
  and progressive files with scans taken out (block-smoothed where
  libjpeg-turbo smooths them): equal to PIL bit for bit (the stated
  bound, JPEG_LEVELS, is 0); lossless and 12-bit files raise a `ValueError`
  naming the variant; the committed smoke pages decode to their recorded
  hashes, and the DocXChain front pages regenerate byte for byte from
  the smoke's seeded pages (`python tests/test_torch_image_decode.py`
  writes them);
- BMP, GIF and TIFF (`pipelines/bmp.py`, `gif.py`, `tiff.py`,
  `ccitt.py`) against PIL on files written here at small sizes: every
  BMP header, depth, bit field and RLE escape; GIF interlace, local
  tables, partial frames and table overflow; TIFF compressions ×
  predictors × photometrics × planar and tiled layouts × byte and fill
  orders; CCITT MH, T.4 1-D/2-D and G4 with runs of every length; and
  block-smoothed progressive cuts at 4:2:0, 4:4:4, 4:2:2 and gray; the
  smoke's written page files decode in PIL to the arrays it expects;
- `ops/image.py` `resize_bicubic_u8` against PIL's default
  `Image.resize(size)` (BICUBIC) on seeded RGB pages: downscales,
  upscales, odd sizes and one axis unchanged, bit-equal, where a float
  bicubic with antialias parts from PIL by a level on many pixels."""

import hashlib
import io
import json
import pathlib
import re
import struct
import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import chip_smoke
from advancedliteratemachinery_tpu_torch.ops.image import resize_bicubic_u8
from advancedliteratemachinery_tpu_torch.pipelines import (
    file_loading as tload, jpeg as tjpeg, tiff as ttiff)
from chip_smoke import (gif_lzw, jpeg_keep_scans as keep_scans,
                        jpeg_scan_spans as scan_spans, tiff_bytes)

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
    """12-bit, lossless and arithmetic-coded JPEG raise naming the
    variant; a progressive file cut early, which raised before block
    smoothing was ported, now decodes equal to PIL."""
    page = jpeg_page(24, 24)
    early = keep_scans(jpeg_bytes(page, progressive=True), (0, 1))
    np.testing.assert_array_equal(tload.decode_image(early), pil_rgb(early))
    data = bytearray(jpeg_bytes(page))
    at = data.index(b"\xff\xc0")
    data[at + 4] = 12                               # 12-bit samples
    with pytest.raises(ValueError, match="12-bit"):
        tload.decode_image(bytes(data))
    data[at + 1], data[at + 4] = 0xC3, 8           # a lossless frame
    with pytest.raises(ValueError, match="lossless JPEG"):
        tload.decode_image(bytes(data))
    data[at + 1] = 0xC9                              # arithmetic coding
    with pytest.raises(ValueError, match="arithmetic-coded JPEG"):
        tload.decode_image(bytes(data))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive_jpeg_matches_pil(subsampling):
    """libjpeg's default progression (10 scans for YCbCr: DC first
    interleaved, AC first with EOB runs, AC and DC refinement), always
    with optimised tables, at three qualities, odd sizes and restart
    intervals counted in blocks and in MCU rows."""
    for q, (hw, kw) in zip((50, 75, 95, 75, 95), (
            ((37, 53), {}), ((64, 48), {}),
            ((17, 9), {"restart_marker_blocks": 3}),
            ((31, 130), {"restart_marker_rows": 1}), ((1, 1), {}))):
        page = jpeg_page(*hw, seed=q + subsampling)
        data = jpeg_bytes(page, quality=q, subsampling=subsampling,
                          progressive=True, **kw)
        assert data[data.index(b"\xff\xc2") + 1] == 0xC2
        got = tload.decode_image(data)
        diff = np.abs(got.astype(int) - pil_rgb(data)).max()
        assert diff <= JPEG_LEVELS, (q, hw, kw, diff)


def test_progressive_grayscale_jpeg_matches_pil():
    gray = np.asarray(Image.fromarray(jpeg_page(29, 41, seed=3)).convert("L"))
    for q, kw in ((50, {}), (95, {"restart_marker_blocks": 5})):
        data = jpeg_bytes(gray, quality=q, progressive=True, **kw)
        got = tload.decode_image(data)
        assert np.abs(got.astype(int) - pil_rgb(data)).max() <= JPEG_LEVELS


def test_progressive_scans_that_stop_early():
    """Without the DC refinement every AC coefficient is still refined:
    libjpeg-turbo does not smooth. Cut after the DC and first AC scans,
    or without the last AC refinement, or to the DC scan alone, low AC
    coefficients stay coarse and libjpeg-turbo block-smooths: the port
    smooths as it does, equal to PIL, and its plain decode of such a file
    (the private switch off) differs from PIL's."""
    data = jpeg_bytes(jpeg_page(40, 56, seed=9), quality=85,
                      progressive=True)
    spans = scan_spans(data)
    assert len(spans) == 10 and keep_scans(data, range(10)) == data
    no_dc_refine = keep_scans(data, [i for i in range(10) if i != 6])
    np.testing.assert_array_equal(tload.decode_image(no_dc_refine),
                                  pil_rgb(no_dc_refine))
    for keep in ((0, 1), range(9), (0,)):
        cut = keep_scans(data, keep)
        want = pil_rgb(cut)
        np.testing.assert_array_equal(tload.decode_image(cut), want)
        try:
            tjpeg._SMOOTHING = False
            assert not np.array_equal(tload.decode_image(cut), want)
        finally:
            tjpeg._SMOOTHING = True


def test_adobe_colour_jpegs_match_pil():
    """4-component files (PIL reads every one as inverted CMYK, then
    `cmyk2rgb`): Adobe CMYK (transform 0), YCCK (transform 2, and 1,
    which libjpeg also takes as YCCK), baseline and progressive, with
    and without subsampling; 3-component RGB: Adobe transform 0 without
    JFIF, component ids R, G, B without markers, and Adobe 0 under a JFIF
    marker (YCbCr, as libjpeg reads it)."""
    page = Image.fromarray(jpeg_page(29, 41, seed=4))
    cases = []
    for kw in ({"quality": 80}, {"quality": 60, "subsampling": 2},
               {"quality": 90, "progressive": True}):
        buf = io.BytesIO()
        page.convert("CMYK").save(buf, "JPEG", **kw)
        cmyk = bytearray(buf.getvalue())
        at = cmyk.index(b"Adobe") + 11
        assert cmyk[at] == 0
        cases.append(bytes(cmyk))
        for transform in (2, 1):
            cmyk[at] = transform
            cases.append(bytes(cmyk))
    for kw in ({}, {"progressive": True}):
        rgb = jpeg_bytes(np.asarray(page), quality=85, keep_rgb=True, **kw)
        at = rgb.index(b"\xff\xee")
        n = struct.unpack(">H", rgb[at + 2:at + 4])[0]
        jfif = (b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                b"\x00\x00")
        sof = re.search(rb"\xff[\xc0\xc2]", rgb).start()
        assert rgb[sof + 10:sof + 19:3] == b"RGB"   # the component ids
        cases += [rgb, rgb[:at] + rgb[at + 2 + n:], rgb[:2] + jfif + rgb[2:]]
    for data in cases:
        np.testing.assert_array_equal(tload.decode_image(data),
                                      pil_rgb(data))


def test_jpeg_bomb_refused_before_decoding():
    data = bytearray(jpeg_bytes(jpeg_page(8, 8)))
    at = data.index(b"\xff\xc0")
    data[at + 5:at + 9] = struct.pack(">HH", 20000, 20000)
    with pytest.raises(ValueError, match="decompression bomb"):
        tload.decode_image(bytes(data))


@pytest.mark.parametrize("comp", [1, 4, 5, 8, 32773])
def test_tiff_tile_bomb_refused_before_decoding(comp):
    """A 1x1 bilevel TIFF whose one tile is 65535 pixels square (a G4
    tile of 8 KB of V0 codes would fill it) is refused by its tile size
    before any tile is read; PIL opens it, and so does `image_check`."""
    body = dict(comp=comp) if comp != 4 else {}
    data = tiff_bytes(np.zeros((1, 1, 1), np.uint8), (1,), 0, tile=(16, 16),
                      tags={259: (3, [comp]), 322: (3, [65535]),
                            323: (3, [65535])}, **body)
    with pytest.raises(ValueError, match="tile .* MAX_IMAGE_PIXELS"):
        tload.decode_image(data)
    assert Image.open(io.BytesIO(data)).size == (1, 1)
    assert ttiff.check_tiff(data) == (1, 1)


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


# the DocXChain front's committed page files: name → (page kind, how PIL
# writes it); PIL's decode of each is recorded in FRONT_RECORD
FRONT_RECORD = "smoke_front_pages_jpeg.json"
FRONT_PAGES = {
    "smoke_doc_page0_prog420_rst_q90.jpg": (
        "doc", {"quality": 90, "progressive": True,
                "restart_marker_blocks": 37}),
    "smoke_doc_page0_prog444_q60.jpg": (
        "doc", {"quality": 60, "progressive": True, "subsampling": 0}),
    "smoke_doc_page0_proggray_q60.jpg": (
        "doc_gray", {"quality": 60, "progressive": True}),
    "smoke_doc_page0_cmyk_q50.jpg": ("doc_cmyk", {"quality": 50}),
    "smoke_doc_page0_ycck_q50.jpg": ("doc_ycck", {"quality": 50}),
    "smoke_table_page0_prog_q90.jpg": (
        "table", {"quality": 90, "progressive": True}),
}
# the ones the port decodes in this test (each other page takes about a
# second; `chip_smoke.py` decodes all six)
FRONT_DECODED_IN_TEST = ("smoke_doc_page0_proggray_q60.jpg",
                      "smoke_doc_page0_ycck_q50.jpg")


def front_page_files():
    """The front's page files made with PIL from `chip_smoke.py`'s seeded
    page 0 of `document_pages` and of `table_pages` → {name: bytes}. The
    YCCK page stores the YCbCr of the inverted page with K = 255 (so it
    decodes to the page) as PIL's Adobe CMYK file, whose transform byte
    is then set to 2."""
    doc = Image.fromarray(chip_smoke.document_pages(1)[0])
    ycc = np.asarray(Image.fromarray(255 - np.asarray(doc)).convert("YCbCr"))
    images = {
        "doc": doc, "table": Image.fromarray(chip_smoke.table_pages(1)[0]),
        "doc_gray": doc.convert("L"), "doc_cmyk": doc.convert("CMYK"),
        "doc_ycck": Image.fromarray(np.concatenate(
            [255 - ycc, np.zeros_like(ycc[..., :1])], -1), "CMYK")}
    files = {}
    for name, (kind, kw) in FRONT_PAGES.items():
        buf = io.BytesIO()
        images[kind].save(buf, "JPEG", **kw)
        data = bytearray(buf.getvalue())
        if kind == "doc_ycck":
            at = data.index(b"Adobe") + 11
            assert data[at] == 0
            data[at] = 2
        files[name] = bytes(data)
    return files


def test_front_pages_regenerate_and_decode_to_their_hashes():
    """The committed front pages are PIL's files of the smoke's seeded
    pages, byte for byte; PIL's decodes have the recorded hashes, and the
    port's decode equals PIL's (on FRONT_DECODED_IN_TEST)."""
    record = json.loads((FIXTURES / FRONT_RECORD).read_text())
    assert set(record) == set(FRONT_PAGES)
    for name, data in front_page_files().items():
        assert (FIXTURES / name).read_bytes() == data, name
        pil = pil_rgb(data)
        assert hashlib.sha256(pil.tobytes()).hexdigest() == \
            record[name]["sha256"], name
        if name in FRONT_DECODED_IN_TEST:
            np.testing.assert_array_equal(tjpeg.decode_jpeg(data), pil)


# ---------------- BMP, GIF, TIFF and CCITT against PIL ----------------


def pil_or_none(data: bytes):
    try:
        return pil_rgb(data)
    except Exception:                        # noqa: BLE001 — PIL's any
        return None


def same_as_pil(data: bytes, tag) -> None:
    """The port equals PIL where PIL decodes; where PIL refuses, so does
    the port (a `ValueError`)."""
    want = pil_or_none(data)
    if want is None:
        with pytest.raises(ValueError):
            tload.decode_image(data)
        return
    np.testing.assert_array_equal(tload.decode_image(data), want,
                                  err_msg=str(tag))


def bmp_file(rows: bytes, w, h, bits, header=40, comp=0, palette=(),
             colors=0, masks=None, top_down=False) -> bytes:
    """A BMP of the given raw pixel data (stored rows or an RLE stream),
    header size, bit fields and palette ((r, g, b) entries)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, comp, len(rows), 2835, 2835, colors, 0)
        if header > 40:
            m = list(masks or (0, 0, 0, 0)) + [0]
            info += (struct.pack("<4I", *m[:4])[:header - 40]
                     + bytes(max(0, header - 56)))
    extra = (struct.pack("<3I", *masks[:3]) if header == 40 and comp == 3
             else b"")
    pal = b"".join(bytes((b, g, r) + (() if header == 12 else (0,)))
                   for r, g, b in palette)
    off = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off) + info
            + extra + pal + rows)


def bmp_rows(samples: np.ndarray, bits: int, top_down=False) -> bytes:
    """Samples [h, w] (1-8 bits) or bytes [h, w * bytes] → stored rows,
    padded to 4 bytes, bottom-up unless `top_down`."""
    h = samples.shape[0]
    if bits < 8:
        b = (samples[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        rows = np.packbits(b.astype(np.uint8).reshape(h, -1), axis=1)
    else:
        rows = samples.astype(np.uint8).reshape(h, -1)
    out = np.zeros((h, (rows.shape[1] + 3) & ~3), np.uint8)
    out[:, :rows.shape[1]] = rows
    return (out if top_down else out[::-1]).tobytes()


@pytest.mark.parametrize("header", [12, 40, 52, 56, 108, 124])
def test_bmp_headers_and_depths_match_pil(header):
    """1-, 4- and 8-bit palettes (short ones, gray ramps PIL drops, black
    and white), 16-bit 5-5-5 and bit fields 5-6-5, 24 and 32 bits with
    PIL's bit field layouts, rows both ways; truncations refused."""
    rng = np.random.default_rng(header)
    h, w = 7, 13
    cases = []
    for bits in (1, 4, 8):
        for n in (1 << bits, max(1, (1 << bits) - 3), 2):
            pal = [tuple(int(v) for v in rng.integers(0, 256, 3))
                   for _ in range(n)]
            if header == 12:
                pal = (pal + [(0, 0, 0)] * (1 << bits))[:1 << bits]
            idx = rng.integers(0, min(n + 2, 1 << bits), (h, w))
            cases.append((bits, pal, idx, 0, None))
        ramp = ([(0, 0, 0), (255, 255, 255)] if bits == 1 else
                [(i, i, i) for i in range(1 << bits)])
        cases.append((bits, ramp, rng.integers(0, 1 << bits, (h, w)), 0,
                      None))
    if header != 12:
        for comp, masks in ((0, None), (3, (0xF800, 0x7E0, 0x1F, 0)),
                            (3, (0x7C00, 0x3E0, 0x1F, 0))):
            v = rng.integers(0, 65536, (h, w)).astype("<u2")
            cases.append((16, [], v.view(np.uint8), comp, masks))
        for masks in ((0xFF0000, 0xFF00, 0xFF, 0),
                      (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                      (0xFF000000, 0xFF0000, 0xFF00, 0xFF)):
            cases.append((32, [], rng.integers(0, 256, (h, 4 * w)), 3,
                          masks))
    cases.append((24, [], rng.integers(0, 256, (h, 3 * w)), 0, None))
    cases.append((32, [], rng.integers(0, 256, (h, 4 * w)), 0, None))
    for i, (bits, pal, px, comp, masks) in enumerate(cases):
        top = header != 12 and i % 2 == 1
        data = bmp_file(bmp_rows(px, min(bits, 8), top), w, h, bits, header,
                        comp, pal, len(pal) if header != 12 else 0, masks,
                        top)
        same_as_pil(data, (header, bits, comp, masks))
        same_as_pil(data[:len(data) - 5], (header, bits, "truncated"))


def test_bmp_rle_matches_pil():
    """RLE8 and RLE4 as PIL's `BmpRleDecoder` reads them: encoded runs cut
    at the row's end, absolute runs (odd RLE4 ones lose a pixel) with
    their word padding, end of line, end of bitmap, and the delta escape,
    whose two bytes PIL skips before reading its offsets from the next
    two; a stream that ends early is refused."""
    rng = np.random.default_rng(5)
    for t in range(60):
        w, h = int(rng.integers(1, 30)), int(rng.integers(1, 12))
        bits = 4 if t % 2 else 8
        pal = [tuple(int(v) for v in rng.integers(0, 256, 3))
               for _ in range(1 << bits)]
        ops = bytearray()
        for _ in range(int(rng.integers(1, 40))):
            r = rng.random()
            if r < .4:
                ops += bytes((int(rng.integers(1, 20)),
                              int(rng.integers(0, 256))))
            elif r < .6:
                c = int(rng.integers(3, 12))
                ops += bytes((0, c)) + rng.integers(
                    0, 256, (c + 1) // 2 if bits == 4 else c).astype(
                    np.uint8).tobytes()
                if rng.random() < .7 and len(ops) % 2:
                    ops += b"\0"
            elif r < .75:
                ops += b"\0\0"
            else:
                ops += bytes([0, 2] + rng.integers(0, 6, 4).tolist())
        ops += b"\0\1" if t % 3 else b""
        same_as_pil(bmp_file(bytes(ops), w, h, bits, 40,
                             2 if bits == 4 else 1, pal, 0, None, t % 4 == 1),
                    ("rle", t))


def gif_file(sw, sh, frame, idx, bits, global_table=None, local=None,
             transparency=None, interlace=False, background=0) -> bytes:
    """A GIF89a of one frame (x, y, w, h) of indices `idx` [h, w]."""
    def table(entries):
        n = max(1, (len(entries) - 1).bit_length())
        return n, b"".join(bytes(c) for c in entries) + bytes(
            3 * ((1 << n) - len(entries)))

    flags, gt = 0, b""
    if global_table is not None:
        n, gt = table(global_table)
        flags = 0x80 | (n - 1) | ((n - 1) << 4)
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, background, 0) + gt
    if transparency is not None:
        out += b"!\xf9\x04\x01\0\0" + bytes((transparency,)) + b"\0"
    fflags, lt = 0x40 if interlace else 0, b""
    if local is not None:
        n, lt = table(local)
        fflags |= 0x80 | (n - 1)
    x, y, w, h = frame
    if interlace:
        idx = idx[np.r_[0:h:8, 4:h:8, 2:h:4, 1:h:2]]
    data = gif_lzw(idx.astype(np.uint8).tobytes(), bits)
    blocks = b"".join(bytes((len(data[i:i + 255]),)) + data[i:i + 255]
                      for i in range(0, len(data), 255)) + b"\0"
    return (out + b"," + struct.pack("<HHHHB", x, y, w, h, fflags) + lt
            + bytes((bits,)) + blocks + b";")


def test_gif_matches_pil():
    """The first frame on its screen: interlaced or not, local and global
    tables (gray ramps PIL drops, indices past the table), frames smaller
    than the screen and past it, with and without a transparent index and
    a background index, code sizes 2-8, a frame that fills the LZW table
    (deferred clears), PIL's own file; truncations refused."""
    rng = np.random.default_rng(6)
    for t in range(40):
        n = int(rng.integers(1, 257))
        bits = max(2, (n - 1).bit_length())
        pal = [tuple(int(v) for v in rng.integers(0, 256, 3))
               for _ in range(n)]
        if t % 10 == 3:
            pal = [(i, i, i) for i in range(1 << bits)]
        sw, sh = int(rng.integers(1, 40)), int(rng.integers(1, 30))
        fw, fh = int(rng.integers(1, 40)), int(rng.integers(1, 30))
        frame = (int(rng.integers(0, 8)), int(rng.integers(0, 8)), fw, fh)
        idx = rng.integers(0, min(n + 2, 1 << bits), (fh, fw))
        data = gif_file(
            sw, sh, frame, idx, bits, None if t % 7 == 0 else pal,
            pal[:max(1, n // 2)] if t % 5 == 1 else None,
            int(rng.integers(0, n)) if t % 3 == 0 else None, t % 2 == 1,
            int(rng.integers(0, 4)))
        same_as_pil(data, ("gif", t))
        same_as_pil(data[:int(rng.integers(10, len(data)))], ("cut", t))
    big = rng.integers(0, 256, (120, 160))
    pal = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(256)]
    same_as_pil(gif_file(160, 120, (0, 0, 160, 120), big, 8, pal), "clears")
    buf = io.BytesIO()
    Image.fromarray(jpeg_page(30, 41, seed=4)).save(buf, "GIF")
    same_as_pil(buf.getvalue(), "PIL's GIF")


TIFF_LAYOUTS = [   # (photometric, bits per sample, extra samples)
    (0, (1,), ()), (1, (1,), ()), (0, (2,), ()), (1, (2,), ()),
    (0, (4,), ()), (1, (4,), ()), (0, (8,), ()), (1, (8,), ()),
    (0, (16,), ()), (1, (16,), ()), (1, (8, 8), (2,)),
    (2, (8, 8, 8), ()), (2, (8,) * 4, ()), (2, (8,) * 4, (0,)),
    (2, (8,) * 4, (1,)), (2, (8,) * 4, (2,)), (2, (8,) * 5, (1, 0)),
    (2, (16,) * 3, ()), (2, (16,) * 4, (1,)), (2, (16,) * 4, (2,)),
    (3, (1,), ()), (3, (2,), ()), (3, (4,), ()), (3, (8,), ()),
    (3, (8, 8), (2,)), (5, (8,) * 4, ()), (5, (8,) * 5, (0,)),
    (5, (16,) * 4, ())]


@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
def test_tiff_layouts_match_pil(comp):
    """Every photometric, bit depth and extra-sample layout the port
    reads, in strips (the last one short) and padded tiles, planar and
    contiguous, both byte orders, both fill orders and the horizontal
    predictor: equal to PIL, or refused where PIL refuses (PIL's own
    uncompressed decoder and libtiff differ on planar files, fill order
    2 and associated alpha, and both are followed)."""
    rng = np.random.default_rng(comp)
    for i, (photo, bps, extra) in enumerate(TIFF_LAYOUTS):
        for trial in range(2):
            H, W = int(rng.integers(1, 23)), int(rng.integers(1, 29))
            bits = bps[0]
            px = rng.integers(0, 1 << bits, (H, W, len(bps)))
            if extra[:1] == (1,):
                px[..., :3] = np.minimum(px[..., :3], px[..., 3:4])
            kw = dict(comp=comp, order="<>"[(i + trial) % 2], extra=extra,
                      planar=2 if trial and len(bps) > 1 else 1,
                      fill=2 if (i + trial) % 5 == 0 else 1,
                      colormap=(rng.integers(0, 65536, 3 << bits).tolist()
                                if photo == 3 else None))
            if comp in (5, 8) and bits in (8, 16) and trial:
                kw["predictor"] = 2
            if trial:
                kw["tile"] = (16, 16)
            else:
                kw["rps"] = int(rng.integers(1, H + 1))
            same_as_pil(tiff_bytes(px, bps, photo, **kw), (photo, bps, kw))


def test_tiff_lzw_tables_and_old_style_lzw(monkeypatch):
    """LZW strips long enough to widen to 12-bit codes and clear the
    table, as libtiff reads them; the old LSB-first LZW libtiff still
    reads; a multi-page file gives its first page; Deflate under 32946."""
    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, (60, 90, 3))
    px[:, 45:] = px[:, :1]
    same_as_pil(tiff_bytes(px, (8, 8, 8), 2, comp=5, rps=60), "widen")
    same_as_pil(tiff_bytes(px, (8, 8, 8), 2, comp=32946), "32946")
    pages = [Image.fromarray(jpeg_page(20, 30, seed=s)) for s in (1, 2)]
    buf = io.BytesIO()
    pages[0].save(buf, "TIFF", save_all=True, append_images=pages[1:],
                  compression="tiff_lzw")
    assert Image.open(io.BytesIO(buf.getvalue())).n_frames == 2
    same_as_pil(buf.getvalue(), "multi-page")

    def old_style(data: bytes) -> bytes:
        """LSB-first 9-bit codes from a clear, no early change."""
        codes, table, w = [256], {bytes((i,)): i for i in range(256)}, b""
        for b in data:
            if w + bytes((b,)) in table:
                w += bytes((b,))
                continue
            codes.append(table[w])
            table[w + bytes((b,))] = len(table) + 2
            w = bytes((b,))
        codes += [table[w], 257]
        acc = sum(c << (9 * i) for i, c in enumerate(codes))
        return acc.to_bytes(-(-9 * len(codes) // 8), "little")

    monkeypatch.setattr(chip_smoke, "tiff_lzw", old_style)
    data = tiff_bytes(rng.integers(0, 4, (6, 8, 1)), (8,), 1, comp=5)
    assert data[8] == 0 and data[9] & 1          # libtiff's old-style test
    same_as_pil(data, "old-style LZW")


def test_tiff_orientation_turns_as_pil():
    """PIL's TIFF `load_end` applies `exif_transpose`: `open().convert()`
    returns the page turned or flipped by its `Orientation` (1-8; 0 and 9
    keep it), through PIL's own decoder and through libtiff."""
    px = np.random.default_rng(3).integers(0, 256, (5, 7, 3))
    for comp in (1, 5):
        for orientation in range(10):
            same_as_pil(tiff_bytes(px, (8, 8, 8), 2, comp=comp,
                                  tags={274: (3, [orientation])}),
                        (comp, orientation))


def test_ccitt_fax_matches_pil():
    """MH, T.4 1-D, T.4 2-D (with and without fill bits), G4 and G4 with
    FillOrder 2, written by PIL's libtiff, on noise, long runs and rows of
    runs of every length up to 2,600; both photometric senses."""
    rng = np.random.default_rng(0)
    images = []
    for t in range(8):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 300))
        a = (rng.random((h, w)) < 0.5 if t % 3 == 0 else
             np.cumsum(rng.random((h, w)) < 0.1, axis=1) % 2 == 1)
        images.append(a)
    runs = np.zeros((3, 2700), bool)
    x, k, colour = 0, 0, False
    while x < 2700:
        runs[0, x:x + k] = colour
        x, k, colour = x + k, (k + 37) % 2650, not colour
    runs[1] = ~runs[0]
    runs[2, 100:2690] = True
    images.append(runs)
    for a in images:
        for comp, info in (("group4", None), ("group3", None),
                           ("group3", {292: 1}), ("group3", {292: 5}),
                           ("tiff_ccitt", None), ("group4", {266: 2})):
            buf = io.BytesIO()
            Image.fromarray(a).save(buf, "TIFF", compression=comp,
                                    **({"tiffinfo": info} if info else {}))
            data = bytearray(buf.getvalue())
            same_as_pil(bytes(data), (comp, info, a.shape))
    # WhiteIsZero: the same codes, the other sense
    at = data.index(struct.pack("<HHII", 262, 3, 1, 1))
    data[at + 8] = 0
    same_as_pil(bytes(data), "WhiteIsZero")


@pytest.mark.parametrize("subsampling", [0, 1, 2, "gray"])
def test_block_smoothed_progressive_matches_pil(subsampling):
    """Progressive files cut to their first one, two, three and five
    scans, and without their last one or two: libjpeg-turbo block-smooths
    the coarse low AC coefficients (with the DC interpolated where no AC
    data came), and the port equals PIL at odd sizes, qualities and
    restart intervals."""
    for (h, w), q in (((40, 56), 85), ((17, 9), 95), ((130, 33), 95),
                      ((64, 80), 50)):
        page = jpeg_page(h, w, seed=h + q)
        if subsampling == "gray":
            page = np.asarray(Image.fromarray(page).convert("L"))
            data = jpeg_bytes(page, quality=q, progressive=True)
        else:
            data = jpeg_bytes(page, quality=q, subsampling=subsampling,
                              progressive=True, restart_marker_blocks=3)
        n = len(scan_spans(data))
        for keep in ((0,), (0, 1), range(3), range(5), range(n - 1),
                     range(n - 2)):
            cut = keep_scans(data, keep)
            np.testing.assert_array_equal(tload.decode_image(cut),
                                          pil_rgb(cut), err_msg=str(keep))


def test_unported_page_variants_raise():
    """JPEG-in-TIFF, YCbCr TIFF, float TIFF, WebP (by its signature) and
    arithmetic-coded JPEG raise a `ValueError` naming the variant; BMP
    with BI_ALPHABITFIELDS raises, as PIL does."""
    page = Image.fromarray(jpeg_page(16, 24, seed=1))
    buf = io.BytesIO()
    page.save(buf, "TIFF", compression="jpeg")
    with pytest.raises(ValueError, match="JPEG-in-TIFF"):
        tload.decode_image(buf.getvalue())
    ycc = tiff_bytes(np.asarray(page.convert("YCbCr")), (8, 8, 8), 6, comp=5)
    assert Image.open(io.BytesIO(ycc)).mode == "RGB"      # PIL opens it
    with pytest.raises(ValueError, match="YCbCr TIFF"):
        tload.decode_image(ycc)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.float32)).save(buf, "TIFF")
    with pytest.raises(ValueError, match="float"):
        tload.decode_image(buf.getvalue())
    with pytest.raises(ValueError, match="WebP"):
        tload.decode_image(b"RIFF\0\0\0\0WEBPVP8 " + bytes(20))
    alpha = bmp_file(bytes(16), 2, 2, 32, 40, 6)
    with pytest.raises(ValueError, match="ALPHABITFIELDS"):
        tload.decode_image(alpha)


# the smoke's format page files: the G4 TIFF of the thresholded doc page
# is committed; the cut progressive page is made at run time; PIL's
# decode of each is recorded in FORMAT_RECORD
FORMAT_RECORD = "smoke_front_formats.json"


def format_fixture_files():
    """name → bytes of the committed G4 TIFF (PIL's, of `chip_smoke`'s
    seeded doc page 0 thresholded at 128) and of the cut page."""
    doc = Image.fromarray(chip_smoke.document_pages(1)[0])
    buf = io.BytesIO()
    doc.convert("L").point(lambda v: 255 if v >= 128 else 0).convert(
        "1").save(buf, "TIFF", compression="group4")
    prog = (FIXTURES / chip_smoke.FRONT_DOCS[0]).read_bytes()
    return {chip_smoke.FORMAT_G4: buf.getvalue(),
            chip_smoke.FORMAT_CUT: chip_smoke.jpeg_keep_scans(
                prog, chip_smoke.FORMAT_CUT_SCANS)}


LZW_CROP = (slice(0, 250), slice(0, 490))


def test_smoke_format_pages():
    """`chip_smoke.py`'s written TIFF, BMP and GIF pages decode in PIL to
    the arrays the smoke holds the port to, and so does the port: the
    seeded 1024x768 pages themselves, but for the LZW files, whose Python
    writer is slow, cut to LZW_CROP (two tiles and four strips down,
    three tiles across, edge tiles padded both ways); the committed G4
    TIFF regenerates byte for byte; the recorded hashes are PIL's decodes
    of it and of the cut page, which the port decodes equal."""
    doc = chip_smoke.document_pages(1)[0]
    table = chip_smoke.table_pages(1)[0]
    assert doc.shape == table.shape == (1024, 768, 3)
    for name, write in chip_smoke.FORMAT_WRITERS.items():
        crop = LZW_CROP if "lzw" in name else (slice(None),) * 2
        data, want = write(doc[crop], table[crop])
        np.testing.assert_array_equal(pil_rgb(data), want, err_msg=name)
        np.testing.assert_array_equal(tload.decode_image(data), want,
                                      err_msg=name)
    record = json.loads((FIXTURES / FORMAT_RECORD).read_text())
    files = format_fixture_files()
    assert (FIXTURES / chip_smoke.FORMAT_G4).read_bytes() == \
        files[chip_smoke.FORMAT_G4]
    for name, data in files.items():
        pil = pil_rgb(data)
        assert hashlib.sha256(pil.tobytes()).hexdigest() == \
            record[name]["sha256"], name
        np.testing.assert_array_equal(tload.decode_image(data), pil)


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


if __name__ == "__main__":          # writes the front pages and record
    record = {}
    for name, data in front_page_files().items():
        (FIXTURES / name).write_bytes(data)
        pil = pil_rgb(data)
        record[name] = {
            "sha256": hashlib.sha256(pil.tobytes()).hexdigest(),
            "shape": list(pil.shape), "bytes": len(data),
            "source": f"chip_smoke {FRONT_PAGES[name][0]} page 0, PIL "
                      f"JPEG {FRONT_PAGES[name][1]}"}
    (FIXTURES / FRONT_RECORD).write_text(json.dumps(record, indent=1)
                                         + "\n")
    record = {}
    for name, data in format_fixture_files().items():
        if name.endswith(".tif"):
            (FIXTURES / name).write_bytes(data)
        pil = pil_rgb(data)
        record[name] = {
            "sha256": hashlib.sha256(pil.tobytes()).hexdigest(),
            "shape": list(pil.shape), "bytes": len(data),
            "source": ("chip_smoke doc page 0 thresholded at 128, PIL TIFF "
                       "group4" if name.endswith(".tif") else
                       "chip_smoke FRONT_DOCS[0] cut to its DC and first "
                       "AC scans")}
    (FIXTURES / FORMAT_RECORD).write_text(json.dumps(record, indent=1)
                                          + "\n")
