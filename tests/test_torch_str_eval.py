"""The port's STR evaluation path (`data/lmdb_reader.py`,
`data/lmdb_writer.py`, `data/str_dataset.py`, `eval/str_metrics.py`,
`eval/str_eval.py`, the CLI's `create-lmdb` and `eval`) against the JAX
package on the CPU, on inputs made from numpy seeds:

- LMDB files byte-equal to the JAX writer's wherever its layout fits its
  pages, each reader reading the other's files (overflow chains
  included); past the JAX writer's limits (30 small values on a leaf,
  more than one branch page of leaves) the port's files still read back;
- `create_str_lmdb` keeps and skips the files PIL's `open` + `verify`
  keeps and skips, checked without PIL (`image_check`, equal to PIL on
  truncated and corrupted PNGs and JPEGs);
- dataset items equal to the JAX ones (PIL decodes) for PNG of each
  colour type and baseline JPEG, with `rgb=True` and `rgb=False`, and with
  charset and length filters; formats the port does not decode raise;
- the collates against the JAX ones (cv2): equal on downscales, within
  CV2_LEVELS on upscales;
- the counters, `fuse_predictions` and the mixer equal to the JAX ones;
- `eval` through both CLIs on the same reference-layout checkpoint.
"""

import contextlib
import functools
import hashlib
import io
import json
import pathlib
import struct

import jax
import Levenshtein
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from advancedliteratemachinery_tpu import cli as jcli
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.data import lmdb_reader as jreader
from advancedliteratemachinery_tpu.data import lmdb_writer as jwriter
from advancedliteratemachinery_tpu.data import str_dataset as jds
from advancedliteratemachinery_tpu.eval import str_metrics as jmetrics
from advancedliteratemachinery_tpu.models import mgp_str as jmgp
from advancedliteratemachinery_tpu_torch import cli as tcli
from advancedliteratemachinery_tpu_torch.data import lmdb_reader as treader
from advancedliteratemachinery_tpu_torch.data import lmdb_writer as twriter
from advancedliteratemachinery_tpu_torch.data import str_dataset as tds
from advancedliteratemachinery_tpu_torch.eval import str_metrics as tmetrics
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.models import mgp_str as tmgp
from advancedliteratemachinery_tpu_torch.models.mgp_str import MGPSTRConfig
from advancedliteratemachinery_tpu_torch.models.vit import ViTConfig
from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
    load_image)
from test_torch_mgp_str import fast_engine

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
CV2_LEVELS = 1          # largest uint8 difference from cv2 on upscales
TINY = {"vit": {"embed_dim": 32, "depth": 2, "num_heads": 2},
        "bpe_vocab_size": 64, "wp_vocab_size": 64}
EVAL_RECOGNIZER_LENGTH = 5


def store(n, rng, big=0.5, small=200):
    """An STR-shaped key/value store of n samples: values of 1001-9000
    bytes (overflow chains) or of at most `small` bytes (inline)."""
    out = {}
    for i in range(1, n + 1):
        size = (int(rng.integers(1001, 9000)) if rng.random() < big
                else int(rng.integers(0, small)))
        out[b"image-%09d" % i] = rng.integers(0, 256, size,
                                              np.uint8).tobytes()
        out[b"label-%09d" % i] = b"w%d" % i
    out[b"num-samples"] = str(n).encode()
    return out


def read_all(reader_cls, path, data):
    with reader_cls(path) as r:
        assert len(r) == len(data)
        assert dict(r.items()) == data
        assert all(r.get(k) == v for k, v in data.items())
        assert r.get(b"zz") is None and r.get(b"a") is None


@pytest.mark.parametrize("n", [0, 1, 40, 300])
def test_lmdb_writer_byte_equal_and_cross_read(tmp_path, n):
    data = store(n, np.random.default_rng(n))
    jwriter.write_lmdb(str(tmp_path / "j.mdb"), data)
    twriter.write_lmdb(str(tmp_path / "t.mdb"), data)
    assert (tmp_path / "j.mdb").read_bytes() == (tmp_path / "t.mdb"
                                                 ).read_bytes()
    for reader in (jreader.LmdbReader, treader.LmdbReader):
        read_all(reader, str(tmp_path / "t.mdb"), data)


@pytest.mark.parametrize("n,big,small", [(3000, 1.0, 50), (300, 0.0, 1000)])
def test_lmdb_writer_past_the_jax_writers_pages(tmp_path, n, big, small):
    """3,000 samples (IIIT5k_3000's count) need more leaves than one branch
    page holds; 30 inline values of up to 1000 bytes overflow a leaf. The
    JAX writer raises on both; the port's files read back with both
    readers."""
    data = store(n, np.random.default_rng(7), big, small)
    with pytest.raises(struct.error):
        jwriter.write_lmdb(str(tmp_path / "j.mdb"), data)
    twriter.write_lmdb(str(tmp_path / "t.mdb"), data)
    for reader in (jreader.LmdbReader, treader.LmdbReader):
        read_all(reader, str(tmp_path / "t.mdb"), data)


def encoded(img, fmt, **kw):
    bio = io.BytesIO()
    img.save(bio, fmt, **kw)
    return bio.getvalue()


def pil_verifies(data):
    try:
        Image.open(io.BytesIO(data)).verify()
        return True
    except Exception:                        # noqa: BLE001 — PIL's any
        return False


def sample_files(rng, hw=(19, 37)):
    """name → encoded bytes: PNGs of each colour type (and 16-bit gray,
    a tRNS chunk, Adam7), baseline JPEGs (4:2:0, 4:4:4, gray), a
    progressive JPEG, BMP and GIF, of noise."""
    base = rng.integers(0, 256, (*hw, 3), np.uint8)
    base[4:12, 5:30] = (30, 60, 200)
    rgb = Image.fromarray(base)
    files = {f"png_{m}": encoded(rgb.convert(m), "PNG")
             for m in ("1", "L", "LA", "RGB", "RGBA", "P")}
    files["png_i16"] = encoded(Image.fromarray(
        base[..., 0].astype(np.uint16) * 257), "PNG")
    files["png_trns"] = encoded(rgb.convert("L"), "PNG", transparency=7)
    files["png_adam7"] = encoded(rgb, "PNG", interlace=1)
    files["jpg_420"] = encoded(rgb, "JPEG", quality=80)
    files["jpg_444"] = encoded(rgb, "JPEG", quality=95, subsampling=0)
    files["jpg_gray"] = encoded(rgb.convert("L"), "JPEG", quality=90)
    files["jpg_progressive"] = encoded(rgb, "JPEG", progressive=True)
    files["bmp"] = encoded(rgb, "BMP")
    files["gif"] = encoded(rgb, "GIF")
    return files


def test_image_check_matches_pil_verify():
    """`image_check` passes exactly what PIL's `open` + `verify` passes on
    valid PNGs and JPEGs, on every 7th truncation and on seeded byte
    corruptions of each."""
    rng = np.random.default_rng(3)
    files = {k: v for k, v in sample_files(rng).items()
             if k.startswith(("png", "jpg"))}
    cases = 0
    for name, data in files.items():
        variants = [data] + [data[:k] for k in range(0, len(data), 7)]
        for _ in range(40):
            bad = bytearray(data)
            for _ in range(int(rng.integers(1, 4))):
                bad[int(rng.integers(0, len(bad)))] = int(
                    rng.integers(0, 256))
            variants.append(bytes(bad))
        for v in variants:
            assert (twriter.image_check(v) is None) == pil_verifies(v), (
                name, len(v), twriter.image_check(v))
            cases += 1
    assert cases > 1000


def test_image_check_matches_pil_verify_on_bmp_gif_tiff():
    """`image_check` follows PIL's BMP, GIF and TIFF plugins' `_open`
    (their `verify()` checks nothing more): it passes exactly what PIL's
    `open` + `verify` passes on files PIL writes (BMP of four modes, GIF,
    TIFF uncompressed, LZW, Deflate and PackBits, little- and big-endian),
    every 5th truncation and seeded byte flips of the headers and IFDs."""
    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (13, 21, 3), np.uint8)
    rgb = Image.fromarray(base)
    files = [encoded(rgb.convert(m), "BMP") for m in ("1", "L", "P", "RGB")]
    files += [encoded(rgb, "GIF"), encoded(rgb.convert("L"), "GIF")]
    files += [encoded(rgb.convert(m), "TIFF", compression=c)
              for m in ("1", "L", "RGB", "CMYK")
              for c in ("raw", "tiff_lzw", "tiff_deflate", "packbits")]
    files.append(encoded(Image.fromarray(base[..., 0].astype(np.uint16)
                                         * 257).convert("I;16B"), "TIFF"))
    cases = passed = 0
    for data in files:
        variants = [data] + [data[:k] for k in range(0, len(data), 5)]
        for _ in range(60):
            bad = bytearray(data)
            at = int(rng.integers(0, min(len(bad), 300)))
            bad[at] ^= 1 << int(rng.integers(0, 8))
            variants.append(bytes(bad))
        for v in variants:
            ok = pil_verifies(v)
            assert (twriter.image_check(v) is None) == ok, (
                len(v), twriter.image_check(v))
            cases, passed = cases + 1, passed + ok
    assert cases > 2000 and 0.2 < passed / cases < 0.9


def test_create_str_lmdb_keeps_what_the_jax_writer_keeps(tmp_path, capsys):
    """The same samples kept and skipped, and (every kept image past the
    1000 bytes of an inline value, so that the JAX writer's leaves fit)
    the same file."""
    files = sample_files(np.random.default_rng(4), hw=(80, 120))
    files["png_truncated"] = files["png_RGB"][:-30]
    bad = bytearray(files["png_L"])
    bad[60] ^= 0xFF                                   # an IDAT CRC fails
    files["png_corrupt"] = bytes(bad)
    files["jpg_truncated"] = files["jpg_420"][:150]
    files["text"] = b"not an image at all"
    lines = []
    for i, (name, data) in enumerate(files.items()):
        (tmp_path / name).write_bytes(data)
        lines.append(f"{name}\tword{i}")
    gt = tmp_path / "gt.txt"
    gt.write_text("\n".join(lines) + "\n\n", encoding="utf-8")
    nj = jwriter.create_str_lmdb(str(gt), str(tmp_path / "j"),
                                 root=str(tmp_path))
    assert tcli.main(["create-lmdb", str(gt), str(tmp_path / "t"),
                      "--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[-1])["num_samples"] == nj
    assert nj == len(files) - 4
    assert out.count("skipping invalid image") == 2 * 4
    assert ((tmp_path / "j" / "data.mdb").read_bytes()
            == (tmp_path / "t" / "data.mdb").read_bytes())
    assert tcli.main(["create-lmdb", str(gt), str(tmp_path / "u"),
                      "--root", str(tmp_path), "--no-check"]) == 0
    assert json.loads(capsys.readouterr().out)["num_samples"] == len(files)


def dataset_lmdb(tmp_path, files, labels):
    data = {b"num-samples": str(len(files)).encode()}
    for i, (raw, label) in enumerate(zip(files, labels), 1):
        data[b"image-%09d" % i] = raw
        data[b"label-%09d" % i] = label.encode()
    (tmp_path / "ds").mkdir()
    twriter.write_lmdb(str(tmp_path / "ds" / "data.mdb"), data)
    return str(tmp_path / "ds")


def test_dataset_items_match_jax(tmp_path):
    files = sample_files(np.random.default_rng(5))
    names = [n for n in files if n not in ("jpg_progressive", "bmp", "gif")]
    labels = ["Hello", "WORLD", "a-b", "x" * 30, "ok", "Zz9", "é", "tiny",
              "Mixed", "abc", "12", "q"]
    path = dataset_lmdb(tmp_path, [files[n] for n in names], labels)
    for kw in ({}, {"rgb": False}, {"charset": "abcdefghijklmnopqrstuvwxyz"
                                    "0123456789", "max_length": 4},
               {"sensitive": True}, {"filter_off": True, "rgb": False}):
        j, t = jds.LmdbStrDataset(path, **kw), tds.LmdbStrDataset(path, **kw)
        assert j.indices == t.indices and len(j) == len(t) > 0, kw
        for i in range(len(j)):
            (ja, jl), (ta, tl) = j[i], t[i]
            assert jl == tl and ta.dtype == np.uint8
            np.testing.assert_array_equal(ta, ja, err_msg=f"{kw} {i}")
        t.close()


def test_dataset_names_formats_it_cannot_decode(tmp_path):
    """WebP and JPEG-in-TIFF raise naming the format; a progressive JPEG
    cut after its first two scans (which libjpeg-turbo block-smooths),
    BMP and GIF, which raised before their decoders were ported, decode
    to PIL's `convert("RGB")`."""
    from test_torch_image_decode import keep_scans
    files = sample_files(np.random.default_rng(6))
    early = keep_scans(files["jpg_progressive"], (0, 1))
    rgb = Image.fromarray(np.random.default_rng(7).integers(
        0, 256, (19, 37, 3), np.uint8))
    decoded = [early, files["bmp"], files["gif"]]
    refused = [b"RIFF\0\0\0\0WEBPVP8 " + bytes(20),
               encoded(rgb, "TIFF", compression="jpeg")]
    path = dataset_lmdb(tmp_path, decoded + refused, list("abcde"))
    ds = tds.LmdbStrDataset(path)
    for i, data in enumerate(decoded):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(ds[i][0], want)
    for i, word in enumerate(("WebP", "JPEG-in-TIFF"), len(decoded)):
        with pytest.raises(ValueError, match=word):
            ds[i]


def crops_of(sizes, seed):
    rng = np.random.default_rng(seed)
    return [(chip_smoke.word_crop(rng, h, w), f"w{h}x{w}") for h, w in sizes]


DOWN = [(40, 200), (33, 129), (64, 256), (96, 384), (32, 500)]
UP = [(16, 32), (20, 70), (31, 127), (8, 300), (100, 60)]


@pytest.mark.parametrize("keep_ratio", [False, True])
def test_align_collate_matches_cv2(keep_ratio):
    """Bit-equal where both sides shrink; within CV2_LEVELS where a side
    grows (the count of differing pixels is printed)."""
    for sizes, exact in ((DOWN, True), (UP, False)):
        samples = crops_of(sizes, 8)
        samples.append((samples[0][0][..., :1], "gray"))
        want, wl = jds.AlignCollate(keep_ratio_with_pad=keep_ratio)(samples)
        got, tl = tds.AlignCollate(keep_ratio_with_pad=keep_ratio,
                                   device="cpu")(samples)
        got = got.numpy()
        assert tl == wl and got.shape == want.shape == (len(samples), 32,
                                                        128, 3)
        diff = np.abs(got.astype(int) - want)
        print(f"keep_ratio={keep_ratio} exact={exact}: "
              f"{int((diff > 0).sum())} of {diff.size} values differ")
        assert diff.max() <= (0 if exact else CV2_LEVELS)


def test_lister_collate_matches_cv2():
    # widths 32·w/h = 40.5 and 41.5 round half to even: 40 and 42
    sizes = [(32, 40), (64, 81), (64, 83), (16, 200), (40, 50), (20, 33)]
    samples = crops_of(sizes, 9)
    want_b, want_m, wl = jds.ListerCollate()(samples)
    got_b, got_m, tl = tds.ListerCollate(device="cpu")(samples)
    assert tl == wl
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    assert np.abs(got_b.numpy().astype(int) - want_b).max() <= CV2_LEVELS


def test_balanced_mixer_draws_the_jax_batches():
    a = [(np.full((2, 2, 3), i, np.uint8), f"a{i}") for i in range(7)]
    b = [(np.full((2, 2, 3), i, np.uint8), f"b{i}") for i in range(3)]
    j = jds.BalancedMixer([a, b], [0.7, 0.3], batch_size=5, seed=11)
    t = tds.BalancedMixer([a, b], [0.7, 0.3], batch_size=5, seed=11)
    assert j.counts == t.counts
    for _ in range(6):
        assert [lb for _, lb in j.get_batch()] == [lb for _, lb in
                                                  t.get_batch()]


def seeded_strings(rng, n):
    alphabet = list("abcdeABCDE01xyzé ")
    return ["".join(rng.choice(alphabet, int(rng.integers(0, 12))))
            for _ in range(n)]


def test_counters_and_fusion_match_jax():
    rng = np.random.default_rng(12)
    preds, gts = seeded_strings(rng, 400), seeded_strings(rng, 400)
    preds[::7] = gts[::7]                       # some right
    preds[1::9] = [g.upper() for g in gts[1::9]]
    for a, b in zip(preds, gts):
        assert tmetrics.edit_distance(a, b) == Levenshtein.distance(a, b)
    for sensitive in (False, True):
        j = jmetrics.STRAccuracyCounter(case_sensitive=sensitive)
        t = tmetrics.STRAccuracyCounter(case_sensitive=sensitive)
        for p, g in zip(preds, gts):
            assert j.add(p, g) == t.add(p, g)
        assert (j.total, j.correct, j.by_length) == (t.total, t.correct,
                                                     t.by_length)
        assert abs(j.norm_ed - t.norm_ed) <= 1e-12
        assert j.length_bias() == t.length_bias()
        assert j.length_uniform_accuracy() == t.length_uniform_accuracy()
    per_set = {}
    for name in ("IIIT5k", "SVT"):
        per_set[name] = (jmetrics.STRAccuracyCounter(),
                         tmetrics.STRAccuracyCounter())
        for p, g in zip(preds[:150], gts[:150]):
            for c in per_set[name]:
                c.add(p, g)
    assert (jmetrics.benchmark_summary({k: v[0] for k, v in per_set.items()})
            == tmetrics.benchmark_summary({k: v[1]
                                           for k, v in per_set.items()}))
    cands = [[(p, float(c), h) for p, c, h in zip(
        seeded_strings(rng, 3), rng.random(3), ("char", "bpe", "wp"))]
        for _ in gts]
    for sensitive in (False, True):
        assert (jmetrics.fuse_predictions(cands, gts, sensitive)
                == tmetrics.fuse_predictions(cands, gts, sensitive))


def test_committed_smoke_crops_decode_to_their_hashes():
    """`chip_smoke.py`'s evaluation phase cycles these JPEG crops (the
    card's machine cannot encode JPEG): the recorded hashes are PIL's
    decodes, and the port decodes each to its hash."""
    record = json.loads((FIXTURES / "smoke_crops_jpeg.json").read_text())
    assert len(record) >= 8 and sum(
        (FIXTURES / n).stat().st_size for n in record) < 300_000
    for name, want in record.items():
        got = load_image(str(FIXTURES / name))
        assert list(got.shape) == want["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]


@pytest.fixture(scope="module")
def eval_sets(tmp_path_factory):
    """Two LMDB sets of seeded PNG and JPEG crops (up- and downscales),
    labelled with the JAX engine's own fused strings, one altered, and
    the reference-layout checkpoint both CLIs load."""
    d = tmp_path_factory.mktemp("eval")
    cfg = MGPSTRConfig(batch_max_length=EVAL_RECOGNIZER_LENGTH,
                       bpe_vocab_size=64, wp_vocab_size=64,
                       vit=ViTConfig(embed_dim=32, depth=2, num_heads=2))
    sd = chip_smoke.reference_mgp_str_state(cfg,
                                            torch.Generator().manual_seed(0))
    sd["char_head.bias"][0] = -1e4        # no string spells out "[GO]"
    torch.save(sd, d / "mgp.pth")
    rng = np.random.default_rng(13)
    jpegs = sorted(json.loads((FIXTURES / "smoke_crops_jpeg.json"
                               ).read_text()))
    sets = {}
    for name, n in (("IIIT5k_3000", 9), ("SVT", 6)):
        paths = []
        for i in range(n):
            if i % 3 == 2:
                paths.append(str(FIXTURES / jpegs[(i + n) % len(jpegs)]))
                continue
            h, w = int(rng.integers(16, 97)), int(rng.integers(32, 385))
            paths.append(str(d / f"{name}_{i}.png"))
            Image.fromarray(chip_smoke.word_crop(rng, h, w)).save(paths[-1])
        sets[name] = paths
    return d, sets


def write_sets(d, sets, labels, tag):
    dirs = []
    for name, paths in sets.items():
        gt = d / f"{tag}_{name}.txt"
        gt.write_text("".join(f"{p}\t{lb}\n" for p, lb in zip(
            paths, labels[name])), encoding="utf-8")
        dirs.append(str(d / tag / name))
        assert tcli.main(["create-lmdb", str(gt), dirs[-1]]) == 0
    return dirs


def run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def zeros_init(self, rng, *args, **kwargs):
    """The JAX model's init as zeros of its shapes: the CLI's random init,
    op by op, takes longer than the rest of the test, and every weight
    comes from --torch-ckpt anyway."""
    import flax.linen as nn
    shapes = jax.eval_shape(lambda r: nn.Module.init(self, r, *args,
                                                     **kwargs), rng)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_eval_cli_matches_jax(eval_sets, monkeypatch, capsys):
    """`eval --variant tiny --batch-max-length 6 --batch-size 4` with the
    same checkpoint through both CLIs (the port on the CPU, both models in
    f32): on sets
    labelled with the JAX engine's strings, one altered, the JSON outputs
    are equal, and both read one miss. Random weights never emit EOS, so
    the recognizer runs at batch_max_length 5 (`--config-json`; strings
    of at most 6 characters, the label filter's limit)."""
    d, sets = eval_sets
    monkeypatch.setattr(jmgp.MGPSTR, "init", zeros_init)
    # both engines in f32: the CLIs' bf16 defaults round differently in
    # XLA and in torch, which moves near-tied characters
    monkeypatch.setattr(jmgp, "MGPSTR", functools.partial(
        jmgp.MGPSTR, policy=J_FP32))
    monkeypatch.setattr(tmgp, "MGPSTR", functools.partial(
        tmgp.MGPSTR, policy=FP32_POLICY))
    seen, built = [], []
    make = jcli._rec_engine

    def recording(args):
        # the JAX CLI's engine, its run compiled op by op (FAST_COMPILE)
        # for the runner's padded batches of 4; kept for the second run
        engine = make(args)
        fast_engine(engine, engine.params, np.zeros((4, 32, 128, 3),
                                                    np.uint8))
        built.append(engine)
        recognize = engine.recognize

        def record(batch):
            out = recognize(batch)
            seen.append([t for t, _, _ in out])
            return out
        engine.recognize = record
        return engine

    common = ["eval", "--variant", "tiny", "--batch-max-length", "6",
              "--batch-size", "4", "--torch-ckpt", str(d / "mgp.pth"),
              "--config-json", json.dumps(
                  {**TINY, "batch_max_length": EVAL_RECOGNIZER_LENGTH})]
    placeholder = {k: ["x"] * len(v) for k, v in sets.items()}
    dirs = write_sets(d, sets, placeholder, "first")
    monkeypatch.setattr(jcli, "_rec_engine", recording)
    run_cli(jcli.main, common + ["--data", *dirs])
    engine = built[0]
    del engine.recognize                   # its own method again
    monkeypatch.setattr(jcli, "_rec_engine", lambda args: engine)
    strings = [s for batch in seen for s in batch]
    labels, at = {}, 0
    for name, paths in sets.items():
        # the JAX runner pads each set's last batch: drop the pad rows
        per_batch = [len(paths[i:i + 4]) for i in range(0, len(paths), 4)]
        got = []
        for k in per_batch:
            got += strings[at:at + k]
            at += 4
        labels[name] = list(got)
    assert all(0 < len(s) <= 6 for v in labels.values() for s in v)
    labels["SVT"][1] = "q" + labels["SVT"][1][1:]       # one miss
    dirs = write_sets(d, sets, labels, "self")
    capsys.readouterr()
    want = json.loads(run_cli(jcli.main, common + ["--data", *dirs]))
    got = json.loads(run_cli(tcli.main, common + ["--data", *dirs,
                                                  "--device", "cpu"]))
    assert got == want, (got, want, labels)
    assert want["SVT"] == 5 / 6 and want["IIIT5k_3000"] == 1.0, (want, labels)
    assert want["total_samples"] == 15


def test_rec_engine_takes_batch_length_and_config_json():
    """The port's `_rec_engine` builds MGP-STR at `--batch-max-length` and
    every model with `--config-json`, as the JAX engines do (it had fixed
    25 and read no overrides); its greedy ids then have that many
    positions and one for EOS. `eval` takes both
    (test_eval_cli_matches_jax)."""
    from argparse import Namespace

    ns = Namespace(model="mgp_str", variant="tiny", device="cpu",
                   torch_ckpt=None, batch_max_length=6,
                   config_json=json.dumps(TINY))
    engine = tcli._rec_engine(ns)
    cfg = engine.model.config
    assert cfg.max_tokens == 8 and cfg.vit.embed_dim == 32
    assert cfg.bpe_vocab_size == 64
    crops = np.stack([chip_smoke.word_crop(np.random.default_rng(i), 32,
                                           128) for i in range(3)])
    assert engine(crops)["char_ids"].shape == (3, cfg.max_tokens - 1)
    assert len(engine.recognize(crops)) == 3
    ns = Namespace(model="levocr", variant="tiny", device="cpu",
                   torch_ckpt=None, config_json=json.dumps(
                       {"max_len": 10, "d_model": 32, "heads": 2,
                        "ffn": 64, "layers": 1,
                        "vision": {"d_model": 64, "ffn": 256,
                                   "max_length": 6}}))
    assert tcli._rec_engine(ns).model.config.vision.max_length == 6
    with pytest.raises(ValueError, match="unknown config field"):
        tcli._rec_engine(Namespace(**{**vars(ns), "config_json":
                                      '{"nope": 1}'}))
