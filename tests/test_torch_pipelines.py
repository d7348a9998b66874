"""The port's document pipelines (pipelines/, ops/image.py's cv2-free
image ops, engine/http_serving.py, cli.py) on the CPU.

- `order_point`, and the resize and quad crop against cv2 on seeded
  pages with rectangular, rotated and perspective quads: within one uint8
  level (the measured bound against cv2 5.0; the resize equals it bit for
  bit on downscales);
- every pipeline against the JAX pipeline with the same injected module
  callables, so the crops, the assembly, the reading order, the
  `equation` branch and `cells_to_html` must give equal outputs;
- `load_image` against PIL on seeded PNGs of each colour type and all
  five row filters;
- the HTTP routes and the CLI commands with stub engines."""

import base64
import io
import json
import struct
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import advancedliteratemachinery_tpu.pipelines.document as jdoc
import advancedliteratemachinery_tpu.pipelines.modules as jmod
from advancedliteratemachinery_tpu_torch import cli
from advancedliteratemachinery_tpu_torch.engine import http_serving
from advancedliteratemachinery_tpu_torch.engine.http_serving import (
    RecognitionHTTPServer)
from advancedliteratemachinery_tpu_torch.ops.image import (
    crop_quads_u8, resize_each_u8, resize_linear_u8)
from advancedliteratemachinery_tpu_torch.pipelines import (
    document as tdoc, file_loading as tload, modules as tmod)

torch.set_num_threads(2)

CV2_LEVELS = 1          # largest uint8 difference from cv2 allowed


def seeded_page(seed=0, h=120, w=160):
    """Noise under a few flat blocks and sharp edges (where a coordinate
    error shows most)."""
    rng = np.random.default_rng(seed)
    page = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    page[20:45, 30:110] = 255
    page[60:72, 10:150] = 0
    page[80:110, 100:140] = (200, 40, 90)
    return page


QUADS = {      # tl, tr, br, bl (x, y)
    "rect": [10, 12, 80, 12, 80, 34, 10, 34],
    "rect_frac": [10.3, 12.7, 80.2, 12.7, 80.2, 30.2, 10.3, 30.2],
    "rotated": [30.5, 5.25, 70.75, 40.5, 40.1, 80.3, 0.2, 45.6],
    "perspective": [10.3, 12.7, 80.2, 9.1, 83.5, 30.2, 11.1, 33.9],
    "outside": [-5, -3, 170, 2, 165, 125, -2, 118],
    "thin": [40, 60, 150, 61, 150, 66, 40, 65],
}


# ---------------- order_point, item 5's image ops ----------------


def test_order_point_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        q = rng.uniform(0, 100, 8).astype(np.float32)
        np.testing.assert_array_equal(tmod.order_point(q),
                                      jmod.order_point(q))
    for q in QUADS.values():
        perm = np.asarray(q, np.float32).reshape(4, 2)[[2, 0, 3, 1]]
        np.testing.assert_array_equal(tmod.order_point(perm.reshape(-1)),
                                      jmod.order_point(perm.reshape(-1)))


@pytest.mark.parametrize("hw", [(32, 128), (512, 512), (48, 65), (60, 80),
                                (240, 320), (120, 160), (7, 300)])
def test_resize_matches_cv2(hw):
    page = seeded_page()
    want = cv2.resize(page, (hw[1], hw[0]))
    got = resize_linear_u8(torch.from_numpy(page)[None], hw)[0].numpy()
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= CV2_LEVELS
    if hw[0] <= page.shape[0] and hw[1] <= page.shape[1]:
        assert diff.max() == 0      # cv2's own fixed point on downscales


def test_resize_each_matches_one_at_a_time():
    """Crops of their own sizes resized together (the HTTP server's and
    `cli recognize`'s batches) equal each crop's own resize; the rows
    past the crops are zero."""
    page = seeded_page()
    crops = [page[:h, :w] for h, w in ((24, 60), (47, 159), (32, 128),
                                       (5, 150))]
    got = resize_each_u8(crops, (32, 128), "cpu", batch=6).numpy()
    assert got.shape == (6, 32, 128, 3) and not got[4:].any()
    for c, g in zip(crops, got):
        np.testing.assert_array_equal(g, resize_linear_u8(
            torch.from_numpy(c)[None], (32, 128))[0].numpy())


@pytest.mark.parametrize("kind", sorted(QUADS))
def test_crop_image_matches_cv2(kind):
    page = seeded_page(2)
    pts = jmod.order_point(QUADS[kind])
    want = jmod.crop_image(page, pts)
    got = tmod.crop_image(page, pts, device="cpu")
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= CV2_LEVELS
    on_tensor = tmod.crop_image(torch.from_numpy(page), pts)
    np.testing.assert_array_equal(on_tensor.numpy(), got)


def test_crop_quads_batch_matches_cv2():
    """All quads of a page in one batch, each rectified to its own size
    and resized to 32x128: the JAX TextRecognition's crops."""
    page = seeded_page(3)
    quads = np.stack([jmod.order_point(q) for q in QUADS.values()])
    got = crop_quads_u8(torch.from_numpy(page), quads).numpy()
    assert got.shape == (len(quads), 32, 128, 3)
    for g, q in zip(got, quads):
        want = cv2.resize(jmod.crop_image(page, q), (128, 32))
        assert np.abs(g.astype(int) - want).max() <= CV2_LEVELS
    empty = crop_quads_u8(torch.from_numpy(page), np.zeros((0, 4, 2)))
    assert empty.shape == (0, 32, 128, 3)


# ---------------- pipelines against the JAX pipelines ----------------


def fake_detector(image):
    quads = np.asarray([[10, 10, 60, 10, 60, 25, 10, 25],
                        [70, 12, 150, 14, 148, 30, 72, 28],
                        [10, 60, 80, 60, 80, 76, 10, 76],
                        [100, 85, 150, 80, 152, 100, 102, 104]], np.float32)
    return quads, np.asarray([0.9, 0.7, 0.8, 0.6], np.float32)


class FakeRecognizer:
    """(text, conf, head) per crop: the text numbers the crop, the
    confidence reads its mean (a wrong crop shows), and every batch's
    shape and zero padding are recorded."""

    def __init__(self):
        self.batches = []

    def __call__(self, batch):
        b = np.asarray(batch)
        self.batches.append((b.shape, str(b.dtype),
                             [int(r.any()) for r in b]))
        n = sum(len(s[2]) for s in self.batches[:-1])
        return [(f"w{n + i}", round(float(b[i].mean()) / 255.0, 2), "char")
                for i in range(len(b))]


def fake_layout(image):
    quads = np.asarray([
        [0, 0, 160, 0, 160, 40.4, 0, 40.4],       # text (2 lines)
        [0, 50, 95.5, 50, 95.5, 120, 0, 120],     # table
        [96, 78, 160, 78, 160, 119.5, 96, 119.5],  # equation
        [0, 0, 24, 0, 24, 8, 0, 8],               # header, same row as 1
    ], np.float32)
    return quads, np.asarray([0.95, 0.9, 0.85, 0.5]), np.asarray(
        [2, 7, 10, 3])


def fake_table(image):
    return {"polygons": np.asarray([
                [0, 0, 80, 0, 80, 40, 0, 40],
                [80, 0, 160, 0, 160, 40, 80, 40],
                [0, 40, 160, 40, 160, 120, 0, 120]], np.float32),
            "logi_coords": np.asarray([[0, 0, 0, 0], [0, 0, 1, 1],
                                       [1, 1, 0, 1]], np.int32)}


def latex_fn(crop):
    c = np.asarray(crop)
    return f"x^{c.shape[0]}_{c.shape[1]}"


def both(make):
    """The same pipeline built from the JAX modules and the port's, each
    with its own fake recognizer."""
    jr, tr = FakeRecognizer(), FakeRecognizer()
    return (make(jmod, jdoc, jmod.TextRecognition(jr, batch_size=3)), jr,
            make(tmod, tdoc, tmod.TextRecognition(tr, batch_size=3,
                                                  device="cpu")), tr)


def test_general_text_reading_matches_jax():
    page = seeded_page(4)
    jp, jr, tp, tr = both(lambda m, d, rec: d.GeneralTextReading(
        m.TextDetection(fake_detector), rec))
    assert tp(page) == jp(page)
    # 4 crops in batches of 3, the last zero-padded, uint8 on both sides
    assert jr.batches == tr.batches == [
        ((3, 32, 128, 3), "uint8", [1, 1, 1]),
        ((3, 32, 128, 3), "uint8", [1, 0, 0])]


def test_document_structurization_matches_jax():
    page = seeded_page(5)
    jf = jmod.FormulaRecognition(latex_fn)
    tf = tmod.FormulaRecognition(latex_fn, device="cpu")

    def make(m, d, rec):
        return d.DocumentStructurization(
            m.LayoutAnalysis(fake_layout), m.TextDetection(fake_detector),
            rec, formula_recognition=jf if m is jmod else tf,
            **({} if m is jmod else {"device": "cpu"}))

    jp, _, tp, _ = both(make)
    want = jp(page)
    assert tp(page) == want
    names = [r["category_name"] for r in want]
    assert names == ["header", "plain text", "table", "equation"]
    assert want[3]["text_list"][0]["content"]["latex"].startswith("x^")
    on_regions = tf.on_regions(page, fake_layout(page)[0][2:3])
    assert on_regions[0]["latex"] == jf.on_regions(
        page, fake_layout(page)[0][2:3])[0]["latex"]


def test_table_parsing_and_html_match_jax():
    page = seeded_page(6)
    jp, _, tp, _ = both(lambda m, d, rec: d.TableParsing(
        m.TableStructureRecognition(fake_table),
        m.TextDetection(fake_detector), rec))
    want = jp(page)
    assert tp(page) == want
    assert 'colspan="2"' in want["html"] and want["html"].count("<tr>") == 2
    for cells in ([], want["cells"], want["cells"][::-1]):
        assert tdoc.cells_to_html(cells) == jdoc.cells_to_html(cells)


def test_reading_order_matches_jax():
    """Python's round in the key: centers at y = 8 and 24 sit on a
    half-way point of the 16-pixel rows and round to even."""
    rng = np.random.default_rng(8)
    items = []
    for cy in (8.0, 24.0, 40.0, 7.9, 23.5, 56.0):
        for cx in rng.uniform(0, 200, 2):
            items.append({"region_poly": [cx - 4, cy - 3, cx + 4, cy - 3,
                                          cx + 4, cy + 3, cx - 4, cy + 3]})
    assert tdoc.sort_reading_order(items) == jdoc.sort_reading_order(items)


def test_convert_document_matches_jax(tmp_path):
    page = seeded_page(9)
    path = str(tmp_path / "page.png")
    Image.fromarray(page).save(path)
    jp, _, tp, _ = both(lambda m, d, rec: d.DocumentStructurization(
        m.LayoutAnalysis(fake_layout), m.TextDetection(fake_detector), rec))
    assert tdoc.convert_document(path, tp) == jdoc.convert_document(path,
                                                                    jp)


# ---------------- load_image against PIL ----------------


def png_bytes(rows: np.ndarray, ctype: int, filters, palette=None) -> bytes:
    """An 8-bit PNG written with the given row filters (cycled)."""
    h, w = rows.shape[:2]
    data = rows.reshape(h, -1).astype(np.int64)
    bpp = rows.shape[2] if rows.ndim == 3 else 1
    raw = bytearray()
    prior = np.zeros(data.shape[1], np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = data[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if f == 4:
            p = left + prior - ul
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, ul))
        else:
            pred = [0 * cur, left, prior, (left + prior) // 2][f]
        raw += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND",
                                                                   b"")


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_load_image_matches_pil(tmp_path, mode):
    rng = np.random.default_rng(10)
    base = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    base[5:20, 5:30] = 200
    im = {"L": lambda: Image.fromarray(base[..., 0]),
          "LA": lambda: Image.fromarray(base[..., :2], "LA"),
          "RGB": lambda: Image.fromarray(base[..., :3]),
          "RGBA": lambda: Image.fromarray(base),
          "P": lambda: Image.fromarray(base[..., :3]).convert(
              "P", palette=Image.ADAPTIVE, colors=50)}[mode]()
    for optimize in (False, True):
        path = str(tmp_path / f"{mode}{optimize}.png")
        im.save(path, optimize=optimize)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(tload.load_image(path), want)
    # every row filter, by a writer of our own
    ctype = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6, "P": 3}[mode]
    arr = np.asarray(im)
    pal = (np.asarray(im.getpalette(), np.uint8).reshape(-1, 3)
           if mode == "P" else None)
    data = png_bytes(arr, ctype, (0, 1, 2, 3, 4), pal)
    np.testing.assert_array_equal(
        tload.decode_image(data),
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_load_image_npy_and_refusals(tmp_path):
    page = seeded_page(11, 20, 30)
    np.save(tmp_path / "page.npy", page)
    np.testing.assert_array_equal(tload.load_image(str(tmp_path / "page.npy")),
                                  page)
    np.save(tmp_path / "gray.npy", page[..., 0])
    assert tload.load_image(str(tmp_path / "gray.npy")).shape == (20, 30, 3)
    Image.fromarray(page).save(tmp_path / "page.jpg")
    with pytest.raises(ImportError, match="PIL"):
        tload.load_image(str(tmp_path / "page.jpg"))
    with pytest.raises(ImportError, match="(?i)pdf"):
        tload.load_document(str(tmp_path / "doc.pdf"))


def test_decode_png_refuses_bombs():
    """A header past PIL's bomb limit is refused before anything is
    inflated; a small header over a stream that inflates far past its rows
    inflates only what the rows hold; a short stream is an error."""
    side = 20000                              # 4e8 pixels > 1.79e8
    head = png_bytes(np.zeros((1, 1, 3), np.uint8), 2, (0,))
    ihdr = struct.pack(">IIBBBBB", side, side, 8, 2, 0, 0, 0)
    big = (head[:8] + struct.pack(">I", 13) + b"IHDR" + ihdr
           + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)) + head[33:])
    with pytest.raises(ValueError, match="decompression bomb"):
        tload.decode_image(big)
    rows = np.full((4, 5, 3), 7, np.uint8)
    data = png_bytes(rows, 2, (0,))
    idat = zlib.compress(b"".join([b"\0" + rows[0].tobytes()] * 4)
                         + bytes(32 << 20), 9)     # 32 MiB past the rows
    body = data[:33] + struct.pack(">I", len(idat)) + b"IDAT" + idat + \
        struct.pack(">I", zlib.crc32(b"IDAT" + idat)) + data[-12:]
    np.testing.assert_array_equal(tload.decode_image(body), rows)
    short = zlib.compress(b"\0" + rows[0].tobytes())
    body = data[:33] + struct.pack(">I", len(short)) + b"IDAT" + short + \
        struct.pack(">I", zlib.crc32(b"IDAT" + short)) + data[-12:]
    with pytest.raises(ValueError, match="expected"):
        tload.decode_image(body)


# ---------------- the HTTP server with a stub engine ----------------


class StubEngine:
    device = torch.device("cpu")

    def __init__(self):
        self.batches = []

    def recognize(self, crops):
        crops = np.asarray(crops)
        self.batches.append(crops.dtype)
        return [(f"m{int(c.mean())}", 0.5, "char") for c in crops]


def png_body(rng, h=40, w=160):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def post(port, path, body, content_type="image/png"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body,
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def server():
    def detect_fn(image):
        h, w = image.shape[:2]
        return (np.asarray([[0, 0, w // 2, 0, w // 2, h, 0, h],
                            [w // 2, 0, w, 0, w, h, w // 2, h]], np.float32),
                np.asarray([0.9, 0.8], np.float32))

    engine = StubEngine()
    srv = RecognitionHTTPServer(engine, batch_size=8, max_wait_ms=20.0,
                                port=0, detect_fn=detect_fn).start()
    yield srv, engine
    srv.stop()


def test_http_routes(server):
    srv, engine = server
    rng = np.random.default_rng(12)
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True, "model": "mgp_str",
                                        "device": "cpu"}
    body = png_body(rng)
    status, payload = post(srv.port, "/v1/recognize", body)
    crop = cv2.resize(tload.decode_image(body), (128, 32))
    assert status == 200 and set(payload) == {"text", "confidence", "head"}
    assert payload["text"] in {f"m{int(crop.mean()) + d}" for d in (-1, 0,
                                                                     1)}
    b64 = json.dumps({"image_b64": base64.b64encode(body).decode()})
    assert post(srv.port, "/v1/recognize", b64.encode(),
                "application/json")[1] == payload
    page = png_body(rng, 64, 256)
    status, payload = post(srv.port, "/v1/read", page)
    assert status == 200 and len(payload["words"]) == 2
    assert set(payload["words"][0]) == {"text", "confidence", "det_score",
                                        "quad"}
    assert np.asarray(payload["words"][0]["quad"]).shape == (8,)
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/stats",
                                timeout=30) as r:
        assert set(json.loads(r.read())) >= {"batches", "items"}
    assert set(engine.batches) == {np.dtype(np.uint8)}
    for path, body, code in (("/v1/recognize", b"not an image", 400),
                             ("/v1/nope", b"x", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(srv.port, path, body)
        assert e.value.code == code and "error" in json.loads(e.value.read())


def test_http_concurrent_requests_share_batches(server):
    srv, _ = server
    rng = np.random.default_rng(13)
    bodies = [png_body(rng) for _ in range(8)]
    before = dict(srv.batcher.stats)
    with ThreadPoolExecutor(8) as ex:
        results = list(ex.map(lambda b: post(srv.port, "/v1/recognize", b),
                              bodies))
    assert all(s == 200 for s, _ in results)
    assert srv.batcher.stats["items"] - before["items"] == 8
    assert srv.batcher.stats["batches"] - before["batches"] < 8


def test_http_refuses_large_bodies_and_engines_without_device(
        server, monkeypatch):
    srv, _ = server
    monkeypatch.setattr(http_serving, "MAX_BODY_BYTES", 1000)
    with pytest.raises(urllib.error.HTTPError) as e:
        post(srv.port, "/v1/recognize", bytes(2000))
    assert e.value.code == 413 and "1000" in json.loads(e.value.read())[
        "error"]

    class NoDevice:
        def recognize(self, crops):
            return []

    with pytest.raises(ValueError, match="device"):
        RecognitionHTTPServer(NoDevice(), port=0)


# ---------------- the CLI with stub engines ----------------


@pytest.fixture
def stub_cli(monkeypatch):
    engine = StubEngine()
    monkeypatch.setattr(cli, "_rec_engine", lambda args: engine)
    monkeypatch.setattr(cli, "_db_detect_fn", lambda args: fake_detector)
    monkeypatch.setattr(cli, "_lore_table_fn", lambda args: fake_table)
    return engine


@pytest.mark.parametrize("cmd", ["read", "structurize", "table", "convert"])
def test_cli_page_commands(stub_cli, tmp_path, capsys, cmd):
    page = seeded_page(14)
    path = str(tmp_path / "page.png")
    Image.fromarray(page).save(path)
    assert cli.main([cmd, path, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    rec = tmod.TextRecognition(stub_cli.recognize, device="cpu")
    det = tmod.TextDetection(fake_detector)
    want = {"read": lambda: tdoc.GeneralTextReading(det, rec),
            "table": lambda: tdoc.TableParsing(
                tmod.TableStructureRecognition(fake_table), det, rec)}.get(
        cmd, lambda: tdoc.DocumentStructurization(
            tmod.LayoutAnalysis(cli._whole_page_layout), det, rec,
            device="cpu"))()(page)
    assert out == json.loads(json.dumps([want] if cmd == "convert"
                                        else want, default=float))


def test_cli_recognize(stub_cli, tmp_path, capsys):
    rng = np.random.default_rng(15)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"w{i}.png"))
        Image.fromarray(rng.integers(0, 256, (20, 90, 3), np.uint8)).save(
            paths[-1])
    assert cli.main(["recognize", *paths, "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["image"] for ln in lines] == paths
    assert set(stub_cli.batches) == {np.dtype(np.uint8)}


@pytest.mark.parametrize("argv,names", [
    (["table", "p.png", "--ckpt", "d"], "--torch-ckpt"),
    (["read", "p.png", "--visualize", "o.png"], "visualization.py"),
    (["structurize", "p.png", "--formula-onnx", "d"], "latex_ocr")])
def test_cli_refuses_unported_options(stub_cli, argv, names):
    with pytest.raises(SystemExit, match=names):
        cli.main(argv)


@pytest.mark.parametrize("cmd", ["recognize", "read", "structurize",
                                 "table", "convert", "serve"])
def test_cli_commands_registered(cmd):
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--help"])
    assert e.value.code == 0


def test_cli_builds_the_port_models(monkeypatch, tmp_path, capsys):
    """The CLI's own model functions (`_rec_engine` for the three
    recognizers, with `--torch-ckpt` for MGP-STR, `_db_detect_fn`,
    `_lore_table_fn`) end to end on the CPU, their model configurations swapped for tiny
    ones (the golden MGP-STR's, so that its checkpoint imports) and the
    detector's and table model's page sizes cut to 128²."""
    import functools

    import chip_smoke
    from advancedliteratemachinery_tpu_torch.models import (
        db, dla, focalnet, levocr, lister, lore, mgp_str)

    Db, Lore, Lister = db.DBConfig, lore.LoreConfig, lister.LISTERConfig
    monkeypatch.setattr(db, "DETECT_HW", (128, 128))
    monkeypatch.setattr(lore, "make_table_predict_fn", functools.partial(
        lore.make_table_predict_fn, input_size=128))
    seg = dla.DLASegConfig(
        dla=dla.DLAConfig(channels=(4, 8, 8, 16, 16, 32)), head_conv=8,
        heads=(("hm", 2), ("st", 8), ("wh", 8), ("ax", 8), ("cr", 8),
               ("reg", 2)))
    monkeypatch.setattr(mgp_str, "MGPSTRConfig",
                        lambda **kw: chip_smoke.GOLDEN_MGP_STR)
    monkeypatch.setattr(db, "DBConfig",
                        lambda: Db(width=8, fpn_dim=16, head_dim=8))
    monkeypatch.setattr(lore, "LoreConfig", lambda: Lore(
        backbone=seg, input_size=8, hidden_size=8, tsfm_layers=1,
        stacking_layers=1, num_heads=2))
    monkeypatch.setattr(lister, "LISTERConfig", lambda **kw: Lister(
        max_ch=6, nhead=2, window_size=5, focalnet=focalnet.FocalNetConfig(
            embed_dim=8, depths=(1, 1, 1, 1))))
    monkeypatch.setattr(levocr, "LevOCRConfig",
                        lambda: chip_smoke.GOLDEN_LEVOCR)
    page = seeded_page(16)
    path = str(tmp_path / "page.png")
    Image.fromarray(page).save(path)
    golden = f"{chip_smoke.GOLDEN_DIR}/mgp_str.pth"
    assert cli.main(["table", path, "--device", "cpu",
                     "--torch-ckpt", golden]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"cells", "html"} and out["html"].startswith(
        "<table>")
    for model in ("lister", "levocr"):
        assert cli.main(["recognize", path, path, "--model", model,
                         "--device", "cpu"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert [json.loads(ln)["head"] for ln in lines] == [model] * 2
