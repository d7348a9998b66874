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
  and progressive files with scans taken out: equal to PIL bit for bit
  (the stated bound, JPEG_LEVELS, is 0), or, where libjpeg-turbo would
  block-smooth a progressive file whose scans stop early, a `ValueError`
  naming the cause; lossless and 12-bit files raise a `ValueError`
  naming the variant; the committed smoke pages decode to their recorded
  hashes, and the DocXChain front pages regenerate byte for byte from
  the smoke's seeded pages (`python tests/test_torch_image_decode.py`
  writes them);
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
    early = keep_scans(jpeg_bytes(page, progressive=True), (0, 1))
    with pytest.raises(ValueError, match="progressive JPEG whose scans "
                                         "leave low AC coefficients"):
        tload.decode_image(early)
    data = bytearray(jpeg_bytes(page))
    at = data.index(b"\xff\xc0")
    data[at + 4] = 12                               # 12-bit samples
    with pytest.raises(ValueError, match="12-bit"):
        tload.decode_image(bytes(data))
    data[at + 1], data[at + 4] = 0xC3, 8           # a lossless frame
    with pytest.raises(ValueError, match="lossless JPEG"):
        tload.decode_image(bytes(data))


def scan_spans(data: bytes):
    """The byte span of each scan of a JPEG (the DHT segments just
    before its SOS, the SOS and its entropy data) and the offset of
    EOI."""
    pos, start, spans = 2, None, []
    while True:
        marker = data[pos + 1]
        if marker == 0xD9:
            return spans, pos
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xC4 and start is None:
            start = pos
        elif marker == 0xDA:
            end = re.compile(rb"\xff(?![\x00\xd0-\xd7\xff])").search(
                data, end).start()
            spans.append((pos if start is None else start, end))
            start = None
        elif marker != 0xC4:
            start = None
        pos = end


def keep_scans(data: bytes, keep) -> bytes:
    """A progressive JPEG with only the scans `keep` (indices), each with
    its Huffman tables, then EOI."""
    spans, _ = scan_spans(data)
    out = data[:spans[0][0]]
    for i in keep:
        out += data[slice(*spans[i])]
    return out + b"\xff\xd9"


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
    libjpeg-turbo does not smooth, and the decode equals PIL. Cut after
    the DC and first AC scans, or without the last AC refinement, low AC
    coefficients stay coarse and libjpeg-turbo block-smooths: the port
    raises, naming it (its plain decode of such a file differs from
    PIL's)."""
    data = jpeg_bytes(jpeg_page(40, 56, seed=9), quality=85,
                      progressive=True)
    spans, _ = scan_spans(data)
    assert len(spans) == 10 and keep_scans(data, range(10)) == data
    no_dc_refine = keep_scans(data, [i for i in range(10) if i != 6])
    np.testing.assert_array_equal(tload.decode_image(no_dc_refine),
                                  pil_rgb(no_dc_refine))
    for keep in ((0, 1), range(9), (0,)):
        with pytest.raises(ValueError, match="block-smooths"):
            tload.decode_image(keep_scans(data, keep))


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
    import chip_smoke
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
