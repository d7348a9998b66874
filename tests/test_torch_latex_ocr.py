"""The port's LaTeX-OCR backend (`pipelines/latex_ocr.py`) and
`FormulaRecognition.from_onnx` against the JAX module's, on the same
seeded fake sessions in the style of `tests/test_latex_ocr.py`: the
pre-processing arrays (`_pad_gray`, `_resize`, `_resizer_loop`, with
resizers that settle after one, two and three rounds) bit-equal, the
strings and `post_process` equal on a corpus, and the construction
paths (`from_dir`, `from_paths` with and without an `onnxruntime`
module, the tokenizer json) behaving alike."""

import json
import sys
import types

import numpy as np
import pytest

import advancedliteratemachinery_tpu.pipelines.latex_ocr as jlx
import advancedliteratemachinery_tpu.pipelines.modules as jmod
from advancedliteratemachinery_tpu_torch.pipelines import (
    latex_ocr as tlx, modules as tmod)

VOCAB = {"[PAD]": 0, "[BOS]": 1, "[EOS]": 2, "\\frac": 3, "{": 4, "}": 5,
         "x": 6, "y": 7, "Ġ+": 8, "2": 9, "^": 10, "Ġ": 11, "\\alpha": 12,
         "\\mathrm": 13, "Ġd": 14, "_": 15, "=": 16, "a": 17, "b": 18}
ID2TOK = {i: t for t, i in VOCAB.items()}
CORPUS = ["x ^ { 2 } + 1", "\\alpha \\beta", "a b", "\\frac { x } { y }",
          "\\mathrm { d } x", "\\operatorname * { a r g } x", "a _ { 1 } b",
          "x = y", "\\text { if } x", "  spaced   out  ", "",
          "\\mathbf { A } \\mathbf { B }", "1 2 3 , 4 5"]


def encoder(feeds):
    x = feeds["input"]
    assert x.ndim == 4 and x.shape[:2] == (1, 1)
    return [np.stack([x.mean(axis=(2, 3)), x.std(axis=(2, 3))], -1)
            .astype(np.float32)]


def seeded_decoder(seed, steps):
    """A decoder whose logits are a seeded function of the tokens so far
    and the context; EOS after `steps` tokens."""
    def run(feeds):
        ids, ctx = feeds["x"], feeds["context"]
        t = ids.shape[1]
        rng = np.random.default_rng([seed, t, int(ids.sum())])
        logits = rng.normal(size=(1, t, len(VOCAB))).astype(np.float32)
        logits[0, -1] += 3 * np.sin(np.arange(len(VOCAB))
                                    * float(ctx.sum()))
        logits[0, -1, 2] = 50.0 if t > steps else -50.0
        return [logits]
    return run


def settling_resizer(widths):
    """A resizer predicting the width buckets `widths` in turn, then the
    last one for ever: it settles after len(widths) rounds."""
    calls = []

    def run(feeds):
        calls.append(feeds["input"].shape)
        out = np.zeros((1, 21), np.float32)
        out[0, widths[min(len(calls) - 1, len(widths) - 1)] // 32 - 1] = 1
        return [out]

    return run, calls


def images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw, np.uint8)
            for hw in ((20, 50, 3), (45, 300, 3), (7, 9), (200, 700, 3),
                       (64, 96))]


def test_preprocessing_is_bit_equal():
    for seed in (0, 1):
        for img in images(seed):
            t = tlx.LatexOcrOnnx(encoder, seeded_decoder(0, 1), ID2TOK)
            j = jlx.LatexOcrOnnx(encoder, seeded_decoder(0, 1), ID2TOK)
            g = t._pad_gray(img)
            np.testing.assert_array_equal(g, j._pad_gray(img))
            for wh in ((64, 32), (97, 33), (g.shape[1] * 2, 64), (32, 32)):
                np.testing.assert_array_equal(tlx.LatexOcrOnnx._resize(g, wh),
                                              jlx.LatexOcrOnnx._resize(g, wh))
            for widths in ((g.shape[1],), (128, 160), (96, 256, 672)):
                (tr, tc), (jr, jc) = (settling_resizer(widths),
                                      settling_resizer(widths))
                t.resizer, j.resizer = tr, jr
                np.testing.assert_array_equal(t._resizer_loop(g),
                                              j._resizer_loop(g))
                assert tc == jc
    # the three-width resizer settles after three rounds
    t.resizer, calls = settling_resizer((96, 256, 672))
    t._resizer_loop(t._pad_gray(images(0)[1]))
    assert len(calls) >= 3


def test_strings_equal_the_jax_modules():
    for seed in range(6):
        widths = (128, 96) if seed % 2 else (64,)
        t = tlx.LatexOcrOnnx(encoder, seeded_decoder(seed, 3 + 2 * seed),
                             ID2TOK, resizer=settling_resizer(widths)[0])
        j = jlx.LatexOcrOnnx(encoder, seeded_decoder(seed, 3 + 2 * seed),
                             ID2TOK, resizer=settling_resizer(widths)[0])
        for img in images(seed)[:3]:
            assert t(img) == j(img)
    capped = [tlx.LatexOcrOnnx(encoder, seeded_decoder(7, 10 ** 6), ID2TOK,
                               max_len=9),
              jlx.LatexOcrOnnx(encoder, seeded_decoder(7, 10 ** 6), ID2TOK,
                               max_len=9)]
    assert capped[0](images(2)[0]) == capped[1](images(2)[0])
    for s in CORPUS:
        assert tlx.post_process(s) == jlx.post_process(s)
    ids = list(range(len(VOCAB))) + [99]
    assert capped[0].detokenize(ids) == capped[1].detokenize(ids)


def artifacts(tmp_path, resizer=True):
    (tmp_path / "tokenizer.json").write_text(json.dumps({
        "model": {"vocab": VOCAB},
        "added_tokens": [{"id": 99, "content": "[MASK]"}]}))
    for name in ("encoder_model.onnx", "decoder_model.onnx") + (
            ("image_resizer.onnx",) if resizer else ()):
        (tmp_path / name).write_bytes(b"onnx")
    return tmp_path


class FakeSession:
    """onnxruntime.InferenceSession's surface: the seeded fakes by file
    name, inputs named as LaTeX-OCR's."""
    built = []

    def __init__(self, path, providers):
        self.path, self.providers = path, providers
        FakeSession.built.append(path.rsplit("/", 1)[-1])
        name = path.rsplit("/", 1)[-1]
        self.fn = {"encoder_model.onnx": encoder,
                   "decoder_model.onnx": seeded_decoder(3, 4),
                   "image_resizer.onnx": settling_resizer((96, 128))[0]}[
            name]
        self.inputs = {"encoder_model.onnx": ["input"],
                       "decoder_model.onnx": ["x", "context"],
                       "image_resizer.onnx": ["input"]}[name]

    def get_inputs(self):
        return [types.SimpleNamespace(name=n) for n in self.inputs]

    def run(self, outputs, feeds):
        assert outputs is None and set(feeds) == set(self.inputs)
        return self.fn(feeds)


@pytest.fixture
def fake_onnxruntime(monkeypatch):
    FakeSession.built = []
    monkeypatch.setitem(sys.modules, "onnxruntime", types.SimpleNamespace(
        InferenceSession=FakeSession))


def test_from_dir_with_a_fake_onnxruntime(tmp_path, fake_onnxruntime):
    d = str(artifacts(tmp_path))
    t, j = tlx.LatexOcrOnnx.from_dir(d), jlx.LatexOcrOnnx.from_dir(d)
    assert FakeSession.built == ["encoder_model.onnx", "decoder_model.onnx",
                                 "image_resizer.onnx"] * 2
    assert t.id2tok == j.id2tok and t.id2tok[99] == "[MASK]"
    for img in images(4)[:2]:
        assert t(img) == j(img)
    tf, jf = (tmod.FormulaRecognition.from_onnx(d, device="cpu"),
              jmod.FormulaRecognition.from_onnx(d))
    assert tf.device == "cpu"
    assert tf(images(5)[0]) == jf(images(5)[0])


def test_construction_errors_match_the_jax_modules(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "onnxruntime", None)   # not installed
    d = str(artifacts(tmp_path, resizer=False))
    for mod in (tlx, jlx):
        with pytest.raises(ImportError) as e:
            mod.LatexOcrOnnx.from_dir(d)
        assert "needs onnxruntime" in str(e.value)
    assert str(e.value) == str(pytest.raises(
        ImportError, tmod.FormulaRecognition.from_onnx, d).value)
    empty = tmp_path / "empty"
    empty.mkdir()
    for fr in (tmod.FormulaRecognition, jmod.FormulaRecognition):
        with pytest.raises(FileNotFoundError, match="encoder_model.onnx"):
            fr.from_onnx(str(empty))
    (tmp_path / "tokenizer.json").write_text('{"not": "a tokenizer"}')
    for mod in (tlx, jlx):
        with pytest.raises(ValueError, match="model.vocab"):
            mod._load_tokenizer_vocab(str(tmp_path / "tokenizer.json"))


def test_structurization_reaches_the_onnx_formula_model():
    """A layout with an "equation" region sends its crop through
    `FormulaRecognition(LatexOcrOnnx(...))`: the port's
    `DocumentStructurization` gives the JAX one's result, LaTeX included,
    on the same fake sessions."""
    import advancedliteratemachinery_tpu.pipelines.document as jdoc
    from advancedliteratemachinery_tpu_torch.pipelines import document as tdoc
    page = np.random.default_rng(8).integers(0, 256, (96, 128, 3), np.uint8)

    def layout(image):
        return (np.asarray([[4, 4, 120, 4, 120, 40, 4, 40],
                            [10, 50, 110, 50, 110, 90, 10, 90]],
                           np.float32), np.asarray([0.9, 0.8]),
                np.asarray([2, 10]))

    def detect(image):
        return (np.asarray([[8, 8, 60, 8, 60, 20, 8, 20]], np.float32),
                np.asarray([0.9], np.float32))

    def recognize(crops):
        return [("w", 0.5, "char") for _ in range(len(crops))]

    out = []
    for m, d, lx, kw in ((jmod, jdoc, jlx, {}),
                         (tmod, tdoc, tlx, {"device": "cpu"})):
        ocr = lx.LatexOcrOnnx(encoder, seeded_decoder(5, 6), ID2TOK,
                              resizer=settling_resizer((64, 96))[0])
        out.append(d.DocumentStructurization(
            m.LayoutAnalysis(layout), m.TextDetection(detect),
            m.TextRecognition(recognize, **kw),
            formula_recognition=m.FormulaRecognition(ocr, **kw), **kw)(page))
    assert out[1] == out[0]
    eq = [r for r in out[1] if r["category_name"] == "equation"]
    assert len(eq) == 1 and eq[0]["text_list"][0]["content"]["latex"]
