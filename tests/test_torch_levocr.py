"""LevOCR port (models/abinet, models/levocr, ops/levenshtein, engine/infer
`LevOCRInference`, engine/convert, engine/checkpoint `import_levocr`)
against the JAX package on the CPU, at the size of tests/test_levocr.py's
TINY (d 64, 2 heads, one layer, max_len 10, two rounds; vision d 64, one
transformer layer, 8 queries), with the same numpy-seeded weights carried
across by engine/convert. float32 on both sides (tolerance 1e-5: the same
arithmetic summed in other orders); one bf16 check of the three attention
modules under a stated looser bound. The importer is held to the JAX
importer + engine/convert on the torch mirror of tests/test_levocr_import.py,
and the golden tests/golden/levocr.pth is replayed through the port alone at
`golden_common.TOLERANCES`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_common as G
import test_levocr_import as LI
from advancedliteratemachinery_tpu.core.precision import (
    DEFAULT_POLICY as J_BF16, FP32_POLICY as J_FP32)
from advancedliteratemachinery_tpu.engine import checkpoint as jck
from advancedliteratemachinery_tpu.engine.infer import (
    LevOCRInference as JInference)
from advancedliteratemachinery_tpu.models import abinet as jabinet
from advancedliteratemachinery_tpu.models import levocr as jlevocr
from advancedliteratemachinery_tpu.ops import levenshtein as jlev
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, FP32_POLICY)
from advancedliteratemachinery_tpu_torch.engine import checkpoint as ck
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict, load_flax_params)
from advancedliteratemachinery_tpu_torch.engine.infer import LevOCRInference
from advancedliteratemachinery_tpu_torch.models import abinet, levocr
from advancedliteratemachinery_tpu_torch.ops import levenshtein as lev
from test_torch_mgp_str import FAST_COMPILE

torch.set_num_threads(2)

VISION_KW = dict(max_length=8, num_classes=37, d_model=64,
                 backbone_layers=1)
LEVOCR_KW = dict(max_len=10, d_model=64, heads=2, ffn=128, layers=1,
                 max_iter=1)
TOL = dict(rtol=1e-5, atol=1e-5)      # f32 on both sides, other sum orders
# the vision map and attention maps after ResNet45's 45 conv layers, whose
# f32 rounding differs between XLA's and torch's conv algorithms
MAP_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_RMS = 1e-2     # bf16 on both sides, the same rounding points: only
#                     the products' summation order differs, which moves
#                     a rounded value by one bf16 step (2^-8) here and there
# the golden artifact's configuration (tests/golden_common.run_levocr)
GOLDEN_CFG = levocr.LevOCRConfig(
    max_len=LI.MAXLEN, d_model=LI.DL, heads=2, ffn=64, layers=1,
    vision=abinet.ABINetVisionConfig(max_length=6, num_classes=37,
                                     d_model=LI.DV, ffn=256))


def configs():
    jv = jabinet.ABINetVisionConfig(**VISION_KW)
    tv = abinet.ABINetVisionConfig(**VISION_KW)
    return (jlevocr.LevOCRConfig(vision=jv, **LEVOCR_KW),
            levocr.LevOCRConfig(vision=tv, **LEVOCR_KW))


def random_variables(shapes, seed):
    """Kernels N(0, 1/fan_in), biases N(0, 0.1²), norm scales near 1,
    BatchNorm means N(0, 0.1²) and variances in [0.5, 1.5], embeddings
    N(0, 1) (so that the heads' logits are far apart), position tables
    N(0, 0.3²)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        elif name in ("bias", "mean"):
            n = 0.1 * n
        elif name == "var":
            n = rng.uniform(0.5, 1.5, s.shape)
        elif name != "embedding":
            n = 0.3 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(got, want, err_msg=""):
    """Within 1e-5 relative, and 1e-5 absolute of the values' RMS: the
    heads' logits are products with N(0, 1) embeddings and run to ~30,
    the vision logits (a classifier widened x4) to ~10."""
    scale = max(1.0, float(np.sqrt(np.mean(np.square(want)))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=err_msg)


def readable_vision(variables):
    """Random weights read a near-uniform attention map, so every query
    reads the same vector and the vision branch predicts one class
    everywhere. Sharper queries (the position projection x16), a wider
    classifier (x4) and the null class's bias raised by 6 make the
    predictions vary along the crop and end early on most crops, so the
    rounds have room to insert and delete."""
    v = jax.tree.map(np.copy, variables)
    vis = v["params"]["vision"]
    vis["attention"]["project"]["kernel"] *= 16
    vis["cls"]["kernel"] *= 4
    vis["cls"]["bias"][0] += 6.0
    return v


def port_model(variables, policy=FP32_POLICY):
    tm = levocr.LevOCR(configs()[1], policy=policy, device="cpu")
    return load_flax_params(tm, variables["params"],
                            variables["batch_stats"])


@pytest.fixture(scope="module")
def jax_run():
    """One set of weights; the JAX engine on 6 uint8 crops (its compiled
    normalize + refine also gives the tokens and scores), and one compiled
    JAX run of the heads forward and of the vision branch on the same
    normalized crops."""
    jcfg, _ = configs()
    jm = jlevocr.LevOCR(jcfg, policy=J_FP32)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (6, 32, 128, 3)).astype(np.uint8)
    x = (u8.astype(np.float32) * (2.0 / 255.0) - 1.0)
    d = jlevocr.LevtDictionary(max_len=jcfg.max_len)
    noised = d.encode(["ab", "xyz", "", "hello", "q1", "zz9"])
    masked = d.encode(["abc", "xyz", "a", "hell", "q12", "z9"])
    tok = jnp.asarray(noised)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), tok, tok, train=False))
    variables = readable_vision(random_variables(shapes, seed=3))
    engine = JInference(jm, variables)
    texts = engine.recognize(u8)
    tokens, scores = jax.tree.map(np.asarray, engine._run(variables, u8))

    def heads_and_vision(v, x, a, b):
        return (jm.apply(v, x, a, b, train=False),
                jm.apply(v, x, method=lambda mod, x: mod.vision(x)))

    heads, vis = jax.tree.map(np.asarray, jax.jit(
        heads_and_vision, compiler_options=FAST_COMPILE)(
        variables, jnp.asarray(x), tok, jnp.asarray(masked)))
    return dict(variables=variables, u8=u8, x=x, noised=noised,
                masked=masked, texts=texts, tokens=tokens, scores=scores,
                heads=heads, vision=vis)


# ---------------- the edit ops ----------------


def edit_case(seed, B=96, L=12):
    """Rows of every length from 2 (bos eos) to L, ids over the whole
    vocabulary (so bos/eos/pad/unk also appear inside), deletion flags
    everywhere, insertion counts from 0 to 255 (a third of the rows ask
    for more than the buffer holds), predicted words and scores."""
    rng = np.random.default_rng(seed)
    tokens = np.full((B, L), levocr.PAD, np.int32)
    for i, n in enumerate(rng.integers(2, L + 1, B)):
        tokens[i, 0] = levocr.BOS
        tokens[i, 1:n - 1] = rng.integers(0, 40, n - 2)
        tokens[i, n - 1] = levocr.EOS
    scores = rng.standard_normal((B, L)).astype(np.float32)
    ins = rng.integers(0, 4, (B, L - 1))
    ins[::3] = rng.integers(0, 256, (len(ins[::3]), L - 1))
    return dict(tokens=tokens, scores=scores,
                del_pred=rng.random((B, L)) < 0.5,
                ins_pred=ins.astype(np.int32),
                word_pred=rng.integers(0, 40, (B, L)).astype(np.int32),
                word_score=rng.standard_normal((B, L)).astype(np.float32))


EDIT_OPS = {
    "del": (lambda m, c: m.apply_del_words(c["tokens"], c["scores"],
                                           c["del_pred"], 1, 0, 2)),
    "ins_masks": (lambda m, c: m.apply_ins_masks(c["tokens"], c["scores"],
                                                 c["ins_pred"], 1, 3)),
    "ins_words": (lambda m, c: m.apply_ins_words(
        c["tokens"], c["scores"], c["word_pred"], c["word_score"], 3)),
}


@pytest.mark.parametrize("op", sorted(EDIT_OPS))
def test_edit_ops_equal_jax(op):
    case = edit_case(seed=len(op))
    want = jax.jit(lambda c: EDIT_OPS[op](jlev, c))(
        {k: jnp.asarray(v) for k, v in case.items()})
    got = EDIT_OPS[op](lev, {k: torch.from_numpy(v)
                             for k, v in case.items()})
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if w.dtype == jnp.int32
                           else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if op == "ins_masks":          # overflow clamped at the buffer's end
        n_in = (case["tokens"] != levocr.PAD).sum(1)
        assert (case["ins_pred"].sum(1) > 12 - n_in).any()
        assert ((got[0] != levocr.PAD).sum(1) <= 12).all()
    if op == "del":                # bos/eos flagged for deletion survive
        t = torch.from_numpy(case["tokens"])
        flagged = torch.from_numpy(case["del_pred"]) & (
            (t == levocr.BOS) | (t == levocr.EOS))
        assert flagged.any()
        assert torch.equal((got[0] == levocr.BOS).sum(1),
                           (t == levocr.BOS).sum(1))
        assert torch.equal((got[0] == levocr.EOS).sum(1),
                           (t == levocr.EOS).sum(1))


def test_dictionary_round_trip():
    d, jd = levocr.LevtDictionary(max_len=8), jlevocr.LevtDictionary(
        max_len=8)
    texts = ["abc", "", "hello world", "z9", "toolongword"]
    ids = d.encode(texts)
    np.testing.assert_array_equal(ids, jd.encode(texts))
    assert d.decode(ids) == jd.decode(ids) == [
        "abc", "", "hello", "z9", "toolon"]


def test_argmax_ties_take_the_first_index():
    """Planted ties: all-equal rows, a tie between the first and a later
    class, and null (class 0) tied with a character at the first query:
    the port's vision tokens against a transcription of the JAX refine
    (models/levocr.py:315-335) on `jnp.argmax`."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((5, 8, 37)).astype(np.float32)
    logits[0] = 0.0
    logits[1, :, 7] = logits[1, :, 2] = logits[1].max() + 1.0
    logits[2, 0, 0] = logits[2, 0, 4] = logits[2, 0].max() + 1.0
    logits[3, 3, [0, 9]] = logits[3, 3].max() + 1.0
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(levocr.first_argmax(t).numpy(),
                                  np.asarray(jnp.argmax(logits, -1)))
    L = 10
    vis_ids = np.asarray(jnp.argmax(logits, -1))
    is_null = vis_ids == 0
    length = np.where(is_null.any(1), np.asarray(jnp.argmax(is_null, 1)),
                      8)
    length = np.minimum(length, L - 2)
    pos = np.arange(L)[None]
    char_ids = np.take_along_axis(np.pad(vis_ids, ((0, 0), (0, L)))[:, :L],
                                  np.clip(pos - 1, 0, L - 1), 1) + 3
    want = np.where(pos == 0, levocr.BOS, levocr.PAD)
    want = np.where((pos >= 1) & (pos - 1 < length[:, None]), char_ids, want)
    want = np.where(pos == length[:, None] + 1, levocr.EOS, want)
    _, tcfg = configs()
    tm = levocr.LevOCR(tcfg, policy=FP32_POLICY, device="cpu")
    got = tm.vision_tokens(t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 1] == levocr.EOS and got[2, 1] == levocr.EOS


# ---------------- the modules ----------------


@pytest.mark.parametrize("width", [128, 100])
def test_vision_matches_jax(jax_run, width):
    """At 32x128 every nearest resize of the key path doubles; at 32x100
    the map is 8x25 and the resizes 2x4 → 4x7 → 8x13 → 8x25 are not
    integer ratios, where half-pixel centres (jax.image.resize) and
    torch's default "nearest" pick other rows."""
    v = jax_run["variables"]
    vv = {"params": v["params"]["vision"],
          "batch_stats": v["batch_stats"]["vision"]}
    x = jax_run["x"]
    if width == 128:
        want = jax_run["vision"]
    else:
        x = np.random.default_rng(1).standard_normal(
            (2, 32, width, 3)).astype(np.float32)
        jm = jabinet.ABINetVision(jabinet.ABINetVisionConfig(**VISION_KW),
                                  policy=J_FP32)
        want = jax.tree.map(np.asarray, jax.jit(jm.apply)(vv, x))
    tm = abinet.ABINetVision(abinet.ABINetVisionConfig(**VISION_KW),
                             policy=FP32_POLICY, device="cpu")
    load_flax_params(tm, vv["params"], vv["batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got["features"].shape == (x.shape[0], 8, width // 4, 64)
    for key in ("logits", "feature"):
        assert_close(got[key].numpy(), want[key], err_msg=key)
    for key in ("features", "attn_scores"):      # after 45 conv layers
        np.testing.assert_allclose(got[key].numpy(), want[key], **MAP_TOL,
                                   err_msg=key)
    if width == 100:     # the trap: torch's default "nearest" differs here
        k = torch.arange(28.0).view(1, 1, 4, 7)
        assert not torch.equal(
            torch.nn.functional.interpolate(k, (8, 13), mode="nearest"),
            torch.nn.functional.interpolate(k, (8, 13),
                                            mode="nearest-exact"))


def attention_modules(policy, tpolicy):
    """(JAX module, port module, input builder) for the three attention
    rounding points."""
    return {
        "post_norm": (jlevocr.PostNormSelfAttnLayer(64, 2, 128, policy),
                      levocr.PostNormSelfAttnLayer(64, 2, 128, tpolicy),
                      (4, 10, 64)),
        "abinet_encoder": (jabinet.ABINetEncoderLayer(64, 2, 128, policy),
                           abinet.ABINetEncoderLayer(64, 2, 128, tpolicy),
                           (2, 24, 64)),
        "position_attention": (jabinet.PositionAttention(8, 64,
                                                         policy=policy),
                               abinet.PositionAttention(8, 64,
                                                        policy=tpolicy),
                               (2, 8, 32, 64)),
    }


def run_attention_module(name, policy, tpolicy):
    jm, tm, shape = attention_modules(policy, tpolicy)[name]
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    args = [jnp.asarray(x, policy.compute_dtype)]
    targs = [torch.from_numpy(x).to(tpolicy.compute_dtype)]
    if name == "post_norm":           # True where padded
        pad = np.arange(10)[None, :] >= np.array([[10], [6], [2], [1]])
        args.append(jnp.asarray(pad))
        targs.append(torch.from_numpy(pad))
    if name == "position_attention":
        targs[0] = targs[0].permute(0, 3, 1, 2)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    v = random_variables(shapes, seed=11)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.jit(jm.apply)(v, *args))
    load_flax_params(tm, v["params"], v.get("batch_stats"))
    tm.eval()
    with torch.no_grad():
        got = tm(*targs)
    if name == "position_attention":
        got = got[0]
        want = want[0]
    return got.float().numpy(), want


def test_post_norm_layer_with_pad_mask():
    got, want = run_attention_module("post_norm", J_FP32, FP32_POLICY)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["post_norm", "abinet_encoder",
                                  "position_attention"])
def test_attention_rounding_points_bf16(name):
    got, want = run_attention_module(name, J_BF16, DEFAULT_POLICY)
    rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    assert rms <= BF16_RMS, rms


def test_heads_forward_matches_jax(jax_run):
    tm = port_model(jax_run["variables"])
    with torch.no_grad():
        got = tm(torch.from_numpy(jax_run["x"]),
                 torch.from_numpy(jax_run["noised"]),
                 torch.from_numpy(jax_run["masked"]))
    assert got["mask_ins_logits"].shape == (6, 9, 256)
    for key, want in jax_run["heads"].items():
        assert_close(got[key].numpy(), want, err_msg=key)


def test_refine_matches_jax(jax_run):
    """Equal tokens and scores within 1e-5 after two rounds; the rounds
    really edit: some rows change length and some gain characters."""
    tm = port_model(jax_run["variables"])
    with torch.no_grad():
        got = tm.refine(torch.from_numpy(jax_run["x"]))
    np.testing.assert_array_equal(got["tokens"].numpy(), jax_run["tokens"])
    assert_close(got["scores"].numpy(), jax_run["scores"])
    assert_close(got["vision_logits"].numpy(),
                 jax_run["vision"]["logits"])
    vis = got["vision_tokens"].numpy()
    n = (jax_run["tokens"] != levocr.PAD).sum(1)
    assert (n != (vis != levocr.PAD).sum(1)).any()
    assert (jax_run["scores"] != 0).any()


def test_recognize_matches_jax_engine(jax_run):
    engine = LevOCRInference(port_model(jax_run["variables"]),
                             device="cpu")
    got = engine.recognize(jax_run["u8"])
    want = jax_run["texts"]
    assert [g[0] for g in got] == [w[0] for w in want]
    assert any(w[0] for w in want)
    assert all(g[2] == "levocr" for g in got)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-5)


# ---------------- the importer and the golden ----------------


@pytest.fixture
def mirror(monkeypatch):
    """The torch mirror of the reference LevOCRModel at the golden's size
    (tests/test_levocr_import.py), its BatchNorm statistics and the U-Net
    conv biases made nonzero, as a state dict."""
    monkeypatch.setattr(LI.av, "D", LI.DV)
    monkeypatch.setattr(LI.av, "T", 6)
    monkeypatch.setattr(LI.av, "NC", 37)
    torch.manual_seed(0)
    sd = dict(LI.TLevOCR().eval().state_dict())
    g = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if k.endswith("running_mean") or "k_encoder" in k and \
                k.endswith("0.bias") or "k_decoder" in k and \
                k.endswith("1.bias"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
    return sd


def test_import_levocr_equals_jax_importer(mirror):
    """Every tensor equal to the JAX importer + engine/convert, except the
    U-Net key convs' BatchNorm means, into which the port folds the
    reference's conv biases (the JAX importer drops them): those equal the
    JAX means minus the biases."""
    jm = jlevocr.LevOCR(jlevocr.LevOCRConfig(
        max_len=LI.MAXLEN, d_model=LI.DL, heads=2, ffn=64, layers=1,
        vision=jabinet.ABINetVisionConfig(max_length=6, num_classes=37,
                                          d_model=LI.DV, ffn=256)),
        policy=J_FP32)
    img = jnp.zeros((1, 32, 128, 3))
    tok = jnp.ones((1, LI.MAXLEN), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img, tok,
                                            tok, train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jv = jck.import_levocr({k: v.numpy() for k, v in mirror.items()},
                           zeros)
    port = levocr.LevOCR(GOLDEN_CFG, policy=FP32_POLICY, device="cpu")
    want = flax_state_dict(port, jv["params"], jv["batch_stats"])
    got = ck.import_levocr(mirror, port)
    assert set(got) == set(want)
    folded = 0
    for k, w in want.items():
        path = k.rsplit(".bn.running_mean", 1)[0]
        if "attention.k_" in k and k.endswith("bn.running_mean"):
            j = int(path[-1])
            src = (f"vision.attention.k_encoder.{j}.0.bias"
                   if "k_enc" in path else
                   f"vision.attention.k_decoder.{j}.1.bias")
            w = w - mirror[src]
            folded += 1
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    assert folded == 8
    assert torch.equal(port.state_dict()["decoder.word_emb_out.weight"],
                       mirror["levt.decoder.embed_tokens.weight"])


def test_import_levocr_errors(mirror):
    port = levocr.LevOCR(GOLDEN_CFG, policy=FP32_POLICY, device="cpu")
    untied = dict(mirror)
    untied["levt.decoder.embed_tokens.weight"] = \
        mirror["levt.decoder.embed_tokens.weight"] + 1.0
    with pytest.raises(ValueError, match="embed_tokens"):
        ck.import_levocr(untied, port)
    missing = {k: v for k, v in mirror.items() if k != "bn4_2.running_var"}
    with pytest.raises(KeyError, match="bn4_2.running_var"):
        ck.import_levocr(missing, port)
    extra = dict(mirror, **{"aux_head.weight": torch.ones(2),
                            "levt.decoder.extra.weight": torch.ones(2)})
    with pytest.warns(UserWarning, match="aux_head"):
        with pytest.warns(UserWarning, match="decoder.extra"):
            ck.import_levocr(extra, port)


def test_golden_levocr_replays():
    sd = ck.load_torch_state_dict(os.path.join(G.GOLDEN_DIR, "levocr.pth"))
    data = np.load(os.path.join(G.GOLDEN_DIR, "levocr.npz"))
    port = levocr.LevOCR(GOLDEN_CFG, policy=FP32_POLICY, device="cpu")
    ck.import_levocr(sd, port)
    with torch.no_grad():
        got = port(torch.from_numpy(data["in_image"]),
                   torch.from_numpy(data["in_noised"]),
                   torch.from_numpy(data["in_masked"]))
    rtol, atol = G.TOLERANCES["levocr"]
    for key in ("vision_logits", "mask_ins_logits", "word_ins_logits",
                "word_del_logits"):
        np.testing.assert_allclose(got[key].numpy(), data[f"out_{key}"],
                                   rtol=rtol, atol=atol, err_msg=key)
