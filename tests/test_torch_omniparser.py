"""OmniParser port (codecs/coords, models/swin, models/omniparser,
engine/checkpoint `import_swin`/`import_omniparser`/`resize_embedding`,
eval/spotting_eval) against the JAX package on the CPU, at a tiny size
(Swin embed 8, window 4, depths 2-1-1-2; decoder d 32, 2 heads, 1 layer;
20 bins over the charset "ab", 3 VIE categories), with the same
numpy-seeded weights carried across by engine/convert. float32 on both
sides: 1e-4 relative for maps and logits (the same arithmetic summed in
other orders, through a few layers), 1e-5 for decode probabilities, equal
tokens. The page is 100 x 76 with a partial mask: 25 x 19 patches, stage
sizes 25x19 → 13x10 → 7x5 → 4x3 (PatchMerging pads odd sizes), nearest
resizes off a ratio of 2, a shifted window block on the padded 28x20 map
of stage 0 and one in stage 3 whose shift is turned off (one window covers
it). The JAX side is one jitted run in a module fixture. The importer is held to the JAX importer +
engine/convert on the torch mirror of tests/test_omniparser_import.py, and
the golden tests/golden/omniparser.pth is replayed through the port. The
`vie`, `table-html` and `table-eval` commands of both CLIs run on the same
seeded PNG files (a 90 x 70 page resized to 64², PubTabNet records of
test_torch_pubtabnet.py) with this model and its carried weights
(`decode_table_class` reads any index of the band, so the 3 categories
serve the table commands): the same JSON, floats within 1e-5."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_common as G
import test_omniparser_import as OI
from advancedliteratemachinery_tpu.codecs import coords as jcoords
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.engine import checkpoint as jck
from advancedliteratemachinery_tpu.eval import spotting_eval as jeval
from advancedliteratemachinery_tpu.models import omniparser as jomni
from advancedliteratemachinery_tpu.models import swin as jswin
from advancedliteratemachinery_tpu_torch.codecs import coords
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine import checkpoint as ck
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict, load_flax_params)
from advancedliteratemachinery_tpu_torch.eval import spotting_eval
from advancedliteratemachinery_tpu_torch.models import omniparser, swin
from test_torch_mgp_str import FAST_COMPILE

torch.set_num_threads(2)

SWIN_KW = dict(embed_dim=8, depths=(2, 1, 1, 2), num_heads=(1, 2, 2, 2),
               window_size=4)
# three VIE categories: one model serves infer_spotting, whose masks leave
# the category tokens out, and infer_vie
OMNI_KW = dict(d_model=32, nhead=2, dec_layers=1, dim_feedforward=64,
               num_bins=20, chars="ab", max_position_embeddings=64,
               pt_seq_length=12, poly_length=4, rec_length=4,
               max_instances=4, vie_categories=3)
H, W = 100, 76


def configs():
    return (jomni.OmniParserConfig(swin=jswin.SwinConfig(
                drop_path_rate=0.0, **SWIN_KW), drop_path_rate=0.0,
                **OMNI_KW),
            omniparser.OmniParserConfig(swin=swin.SwinConfig(**SWIN_KW),
                                        **OMNI_KW))


def flax_shapes(module):
    """The flax parameter tree of the JAX twin of the port's `module`, as
    zeros: each state-dict tensor under its flax path (the inverse of
    engine/convert.py: Linear weight [out, in] → Dense kernel [in, out],
    conv OIHW → HWIO, norm weight → scale, Embedding weight → embedding).
    flax's `apply` refuses a tree whose names or shapes are not the
    model's, so this stands in for `jax.eval_shape(model.init)` at a
    fraction of its tracing time."""
    tree = {}
    for key, v in module.state_dict().items():
        path, leaf = key.rsplit(".", 1)
        mod = module.get_submodule(path)
        shape = tuple(v.shape)
        if isinstance(mod, torch.nn.Linear) and leaf == "weight":
            leaf, shape = "kernel", shape[::-1]
        elif isinstance(mod, torch.nn.Conv2d) and leaf == "weight":
            leaf, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
        elif isinstance(mod, torch.nn.LayerNorm) and leaf == "weight":
            leaf = "scale"
        elif isinstance(mod, torch.nn.Embedding):
            leaf = "embedding"
        node = tree
        for part in path.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.zeros(shape, np.float32)
    return tree


def random_params(shapes, seed):
    """Kernels N(0, 1/fan_in), biases N(0, 0.1²), norm scales near 1,
    embeddings N(0, 1), the relative-position tables N(0, 0.3²)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        elif name == "bias":
            n = 0.1 * n
        elif name != "embedding":
            n = 0.3 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def readable(params, v):
    """Make the seeded decode worth comparing: the pt head's EOS bias +
    0.25 ends the page's point sequence after 3 points (spotting) or 4
    triplets (VIE), before pt_seq_length; the rec head (kernel x4, the
    recog-pad class's bias - 10) then reads different classes on different
    rows, EOS among them, where it would emit recog-pad everywhere."""
    params["pt_decoder"]["head3"]["bias"][v.pt_eos_index] += 0.25
    rec = params["rec_decoder"]["head3"]
    rec["kernel"] *= 4
    rec["bias"][v.recog_pad_index] -= 10.0
    return params


def assert_close(got, want, rtol=1e-4, err_msg=""):
    """Within `rtol` relative, and `rtol` absolute of the values' RMS."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.sqrt(np.mean(np.square(want)))))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=err_msg)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_run():
    """One set of weights and one jitted JAX run, on the odd partial page,
    of the teacher-forced forward, `infer_spotting` and `infer_vie`, with
    the outputs of the backbone (stage maps and masks), the FPN and
    input_proj captured on the way."""
    jcfg, _ = configs()
    jm = jomni.OmniParser(jcfg, policy=J_FP32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    mask = np.zeros((1, H, W), np.float32)
    mask[:, :83, :61] = 1.0                     # a partial page
    nc = jcfg.vocab().num_classes
    seqs = {k: rng.integers(0, nc, (1, n)).astype(np.int32)
            for k, n in (("pt", 7), ("poly", 5), ("rec", 6))}
    port = omniparser.OmniParser(configs()[1], policy=FP32_POLICY,
                                 device="cpu")
    params = readable(random_params(flax_shapes(port), seed=5),
                      jcfg.vocab())

    def run(p, x, mask, seqs):
        def inner(m):
            return dict(logits=m(x, seqs, mask),
                        spot=m.infer_spotting(x, mask),
                        vie=m.infer_vie(x, mask))
        out, state = jm.apply(
            {"params": p}, method=inner, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name in (
                "backbone", "fpn", "input_proj"))
        inter = state["intermediates"]
        out["feats"], out["masks"] = inter["backbone"]["__call__"][0]
        out["fpn"] = inter["fpn"]["__call__"][0]
        out["src"] = inter["input_proj"]["__call__"][0]
        return out

    out = jax.tree.map(np.asarray, jax.jit(
        run, compiler_options=FAST_COMPILE)(params, x, mask, seqs))
    return dict(params=params, x=x, mask=mask, seqs=seqs, out=out,
                port=load_flax_params(port, params))


@pytest.fixture(scope="module")
def port(jax_run):
    return jax_run["port"]


# ---------------- the vocabulary ----------------


def test_vocab_and_class_tables_match_jax():
    for kw in ({}, dict(num_bins=20, chars="ab", vie_categories=3)):
        jv, tv = jcoords.CoordSeqVocab(**kw), coords.CoordSeqVocab(**kw)
        names = [n for n, v in vars(jcoords.CoordSeqVocab).items()
                 if isinstance(v, property)]
        assert len(names) == 12
        for n in names:
            assert getattr(tv, n) == getattr(jv, n), n
        for cw in (True, False):
            np.testing.assert_array_equal(tv.pt_prompt(cw), jv.pt_prompt(cw))
        ids = tv.encode_text("ab\u00e9b") + [tv.rec_eos_index, tv.num_bins]
        assert tv.decode_text(ids) == jv.decode_text(ids) == "abb"
    assert coords.CORD_CLASSES == jcoords.CORD_CLASSES
    assert coords.SROIE_CLASSES == jcoords.SROIE_CLASSES


# ---------------- the encoder ----------------


def test_window_helpers_and_shift_mask_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 8, 12, 3)).astype(
        np.float32)
    w = swin.window_partition(t(x), 4)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(swin.window_reverse(w, 4, 8, 12).numpy(), x)
    np.testing.assert_array_equal(swin.relative_position_index(4),
                                  jswin.relative_position_index(4))
    np.testing.assert_array_equal(swin.shift_attn_mask(28, 20, 4, 2),
                                  jswin.shift_attn_mask(28, 20, 4, 2))


def test_swin_stage_maps_and_masks_match_jax(jax_run, port):
    """Shifted windows on the padded 28x20 map of stage 0, and the shift
    turned off in stage 3 (4x3 pads to one 4x4 window); the nearest stage
    masks at 100→25/13/7/4 and 76→19/10/5/3, where torch's default
    "nearest" would pick other rows."""
    want = jax_run["out"]
    with torch.no_grad():
        feats, masks = port.backbone(t(jax_run["x"]), t(jax_run["mask"]))
    assert [tuple(f.shape[1:3]) for f in feats] == [
        (25, 19), (13, 10), (7, 5), (4, 3)]
    for s in range(4):
        np.testing.assert_array_equal(masks[s].numpy(), want["masks"][s])
        assert_close(feats[s].numpy(), want["feats"][s], err_msg=f"stage{s}")
    assert 0 < masks[1].mean() < 1           # the mask is partial there
    m = t(jax_run["mask"])[:, None]
    assert not torch.equal(
        torch.nn.functional.interpolate(m, (13, 10), mode="nearest"),
        torch.nn.functional.interpolate(m, (13, 10), mode="nearest-exact"))


def test_fpn_and_encode_match_jax(jax_run, port):
    """The FPN's nearest top-down path and its bilinear resizes to c3
    (13x10: p2 down from 25x19, p4 and p5 up), input_proj, the memory
    mask cropped from masks[1][:, ::2, ::2] and its sine embedding."""
    want = jax_run["out"]
    with torch.no_grad():
        fpn = port.fpn([t(f) for f in want["feats"]])
        memory, mem_pos, mem_valid = port.encode(t(jax_run["x"]),
                                                 t(jax_run["mask"]))
    assert fpn.shape == (1, 13, 10, 1024) and memory.shape == (1, 35, 32)
    assert_close(fpn.numpy(), want["fpn"])
    assert_close(memory.numpy(), want["src"].reshape(1, 35, 32))
    fmask = want["masks"][1][:, ::2, ::2]
    np.testing.assert_array_equal(mem_valid.numpy(), fmask.reshape(1, 35))
    pos = jax.jit(jomni.sine_position_embedding, static_argnums=1)(fmask, 32)
    assert_close(mem_pos.numpy(), np.asarray(pos).reshape(1, 35, 32),
                 rtol=1e-5)


def test_sine_position_embedding_matches_jax():
    """Two widths and a mask with a ragged valid corner."""
    mask = np.ones((2, 5, 7), np.float32)
    mask[1, 3:, :] = 0
    mask[1, :, 4:] = 0
    want = jax.jit(lambda m: [jomni.sine_position_embedding(m, d)
                              for d in (32, 20)])(mask)
    for d, w in zip((32, 20), want):
        got = omniparser.sine_position_embedding(t(mask), d)
        assert got.shape == (2, 5, 7, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# ---------------- the decoder ----------------


def test_teacher_forced_logits_match_jax(jax_run, port):
    with torch.no_grad():
        got = port(t(jax_run["x"]),
                   {k: t(v) for k, v in jax_run["seqs"].items()},
                   t(jax_run["mask"]))
    for task in ("pt", "poly", "rec"):
        assert got[task].dtype == torch.float32
        assert_close(got[task].numpy(), jax_run["out"]["logits"][task],
                     err_msg=task)


def test_prefill_and_steps_equal_the_causal_pass(jax_run, port):
    """A prefill of 4 tokens + 3 cached steps equals the teacher-forced
    causal pass, the port's and the JAX package's."""
    seq = t(jax_run["seqs"]["pt"])
    P = 4
    with torch.no_grad():
        memory, mem_pos, mem_valid = port.encode(t(jax_run["x"]),
                                                 t(jax_run["mask"]))
        dec = port.pt_decoder
        emb, qpos = port.embedding(seq, "pt")
        full = dec(emb, qpos, memory, mem_pos, mem_valid)
        mem_kvs = dec.mem_kvs(memory, mem_pos)
        bias = torch.where(mem_valid[:, None, None, :] > 0, 0.0, -1e9)
        emb, qpos = port.embedding(seq[:, :P], "pt")
        lp, caches = dec.prefill(emb, qpos, mem_kvs, bias, seq.shape[1])
        steps = [lp]
        for i in range(P, seq.shape[1]):
            e, q = port.embedding(seq[:, i:i + 1], "pt", pos_offset=i)
            lt, caches = dec.step(e, q, caches, i, mem_kvs, bias)
            steps.append(lt)
        cached = torch.cat(steps, 1)
    assert_close(cached.numpy(), full.numpy(), rtol=1e-5)
    assert_close(cached.numpy(), jax_run["out"]["logits"]["pt"])


def test_step_ragged_equals_per_row_steps(jax_run, port):
    """Two rows at positions 3 and 5 of one cache: one ragged step equals
    each row's scalar step."""
    rng = np.random.default_rng(6)
    with torch.no_grad():
        memory, mem_pos, mem_valid = port.encode(t(jax_run["x"]),
                                                 t(jax_run["mask"]))
        dec = port.rec_decoder
        mem_kvs = dec.mem_kvs(memory, mem_pos)
        bias = torch.where(mem_valid[:, None, None, :] > 0, 0.0, -1e9)
        ids = t(rng.integers(0, 30, (2, 6)).astype(np.int32))
        emb, qpos = port.embedding(ids, "rec")
        _, caches = dec.prefill(emb, qpos, mem_kvs, bias, 8)
        pos = torch.tensor([3, 5])
        tok = ids[:, :1]
        e, q = port.embedding.embed_at(tok, "rec", pos)
        clone = tuple((k.clone(), v.clone()) for k, v in caches)
        got, _ = dec.step_ragged(e, q, clone, pos, mem_kvs, bias)
        for r in range(2):
            one = tuple((k[r:r + 1].clone(), v[r:r + 1].clone())
                        for k, v in caches)
            e1, q1 = port.embedding(tok[r:r + 1], "rec",
                                    pos_offset=int(pos[r]))
            want, _ = dec.step(e1, q1, one, int(pos[r]), mem_kvs, bias)
            assert_close(got[r:r + 1].numpy(), want.numpy(), rtol=1e-5)


def test_positions_past_the_table_read_nan_as_flax(port):
    """A decode past max_position_embeddings (a 7-token prompt and
    pt_seq_length steps when they exceed it) reads NaN position rows, as
    flax's `Embed` (`jnp.take`, mode "fill") does, and no memory out of
    bounds."""
    table = port.embedding.pt_pos.weight.detach()
    n = table.shape[0]
    ids = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        emb, qpos = port.embedding(ids, "pt", pos_offset=n - 2)
        emb_t, qpos_t = port.embedding.embed_at(
            ids[:, :2].T, "pt", torch.tensor([n - 1, n]))
    want = np.asarray(jnp.take(jnp.asarray(table.numpy()),
                               jnp.arange(n - 2, n + 2), axis=0))
    np.testing.assert_array_equal(qpos[0].numpy(), want)
    assert torch.isnan(emb[0, 2:]).all() and not torch.isnan(emb[0, :2]).any()
    assert not torch.isnan(qpos_t[0]).any() and torch.isnan(qpos_t[1]).all()


def check_decode(got, want, keys):
    for k in keys:
        g = got[k].numpy()
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(g, want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, want[k], err_msg=k)


SPOT_KEYS = ("pt_tokens", "pt_valid", "points", "instance_valid", "polygons",
             "poly_probs", "rec_tokens", "rec_probs")


def test_infer_spotting_matches_jax(jax_run, port):
    """Equal tokens and validity, probs within 1e-5; EOS ends the point
    sequence after three points, so the later steps hold the while-loop's
    defaults (pad, finished, prob 0)."""
    want = jax_run["out"]["spot"]
    with torch.no_grad():
        got = port.infer_spotting(t(jax_run["x"]), t(jax_run["mask"]))
    check_decode(got, want, SPOT_KEYS)
    v = configs()[1].vocab()
    toks = want["pt_tokens"][0]
    assert int(want["instance_valid"].sum()) == 3
    assert toks[6] == v.pt_eos_index
    assert (toks[7:] == v.padding_index).all()
    # the port runs step 7 past the EOS and stops at its check before
    # step 8 of 12
    assert 6 < omniparser.EOS_CHECK_EVERY < OMNI_KW["pt_seq_length"]
    rec = want["rec_tokens"]
    assert len(np.unique(rec)) > 2 and (rec == v.rec_eos_index).any()


def test_infer_vie_matches_jax(jax_run, port):
    with torch.no_grad():
        got = port.infer_vie(t(jax_run["x"]), t(jax_run["mask"]))
    want = jax_run["out"]["vie"]
    check_decode(got, want, SPOT_KEYS + ("classes", "class_probs"))
    assert int(want["instance_valid"].sum()) >= 1
    no_vie = dataclasses.replace(configs()[1], vie_categories=0)
    with pytest.raises(ValueError, match="vie_categories"):
        omniparser.OmniParser(no_vie, device="cpu").infer_vie(
            t(jax_run["x"]))


def test_host_assembly_matches_jax(jax_run):
    v, jv = configs()[1].vocab(), configs()[0].vocab()
    spot, vie = jax_run["out"]["spot"], jax_run["out"]["vie"]
    want = jeval.decode_spotting_outputs(spot, jv, "p0", (H, W))
    got = spotting_eval.decode_spotting_outputs(
        {k: t(a) for k, a in spot.items()}, v, "p0", (H, W))
    assert got == want and len(got) == 3
    names = ("k0", "k1", "k2")
    want = jeval.decode_vie_outputs(vie, jv, names, (H, W))
    got = spotting_eval.decode_vie_outputs(vie, v, names, (H, W))
    assert got == want and len(got) >= 1


# ---------------- the importer and the golden ----------------


def golden_configs():
    kw = dict(d_model=OI.DM, nhead=OI.NHEAD, dec_layers=OI.LAYERS,
              dim_feedforward=OI.FFN, max_position_embeddings=OI.MAXPOS,
              num_bins=OI.NBINS, pt_seq_length=8, poly_length=4,
              rec_length=4, max_instances=4)
    sw = dict(embed_dim=OI.D0, depths=OI.DEPTHS, num_heads=OI.HEADS4,
              window_size=OI.WIN)
    # the JAX configs' dropout and drop-path rates (0 in the golden) act
    # in training only; the port's configs do not hold them
    return (jomni.OmniParserConfig(swin=jswin.SwinConfig(
                drop_path_rate=0.0, **sw), dropout=0.0, drop_path_rate=0.0,
                **kw),
            omniparser.OmniParserConfig(swin=swin.SwinConfig(**sw), **kw))


@pytest.fixture(scope="module")
def mirror():
    """The reference-layout state dict of tests/test_omniparser_import.py's
    torch mirror (laterals without bias, per-stage output norms)."""
    nc = golden_configs()[0].vocab().num_classes
    torch.manual_seed(0)
    return OI.TorchOmniParser(nc).eval().state_dict_reference_names()


def grow_by(params, n):
    """The tree of the same model with n more classes: the word embedding
    and every head3 grow."""
    params["embedding"]["word"]["embedding"] = np.pad(
        params["embedding"]["word"]["embedding"], ((0, n), (0, 0)))
    for d in ("pt", "poly", "rec"):
        head = params[f"{d}_decoder"]["head3"]
        head["kernel"] = np.pad(head["kernel"], ((0, 0), (0, n)))
        head["bias"] = np.pad(head["bias"], (0, n))
    return params


def test_import_omniparser_and_resize_equal_jax(mirror):
    """The port's importer equals the JAX importer + engine/convert on
    every tensor; then the VIE surgery (3 categories added: the word
    embedding and each head3 grow) equals the JAX `resize_embedding` on
    the same grown model."""
    jcfg, tcfg = golden_configs()
    port = omniparser.OmniParser(tcfg, policy=FP32_POLICY, device="cpu")
    jp = jck.import_omniparser(mirror, flax_shapes(port))
    want = flax_state_dict(port, jp)
    got = ck.import_omniparser({k: t(v) for k, v in mirror.items()}, port)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    assert not got["fpn.lat0.bias"].any()

    vt = dataclasses.replace(tcfg, vie_categories=3)
    grown = random_params(grow_by(jax.tree.map(np.copy, jp), 3), seed=9)
    paths = [("embedding", "word", "embedding")] + [
        (f"{d}_decoder", "head3", leaf) for d in ("pt", "poly", "rec")
        for leaf in ("kernel", "bias")]
    jres = jck.resize_embedding(grown, jp, paths, 3)
    vport = load_flax_params(omniparser.OmniParser(
        vt, policy=FP32_POLICY, device="cpu"), grown)
    keys = ["embedding.word.weight"] + [
        f"{d}_decoder.head3.{leaf}" for d in ("pt", "poly", "rec")
        for leaf in ("weight", "bias")]
    got = ck.resize_embedding(vport, got, keys, 3)
    for k, w in flax_state_dict(vport, jres).items():
        assert torch.equal(got[k], w), k
    with pytest.raises(ValueError, match="resize"):
        ck.resize_embedding(vport, got, ["embedding.pt_pos.weight"], 3)


def test_import_omniparser_errors(mirror):
    port = omniparser.OmniParser(golden_configs()[1], policy=FP32_POLICY,
                                 device="cpu")
    sd = {k: t(v) for k, v in mirror.items()}
    missing = {k: v for k, v in sd.items()
               if k != "transformer.rec_decoder.norm.bias"}
    with pytest.raises(KeyError, match="rec_decoder.norm.bias"):
        ck.import_omniparser(missing, port)
    bad = dict(sd)
    bad["backbone.0.layers.1.downsample.reduction.weight"] = torch.ones(3, 3)
    with pytest.raises(ValueError, match="merge1.reduction.weight"):
        ck.import_omniparser(bad, port)
    extra = dict(sd, **{"transformer.aux.weight": torch.ones(2),
                        "backbone.0.layers.0.blocks.0.attn.extra": torch.ones(
                            2)})
    with pytest.warns(UserWarning, match="transformer.aux"):
        with pytest.warns(UserWarning, match="attn.extra"):
            ck.import_omniparser(extra, port)


def test_golden_omniparser_replays():
    sd = ck.load_torch_state_dict(os.path.join(G.GOLDEN_DIR,
                                               "omniparser.pth"))
    data = np.load(os.path.join(G.GOLDEN_DIR, "omniparser.npz"))
    port = omniparser.OmniParser(golden_configs()[1], policy=FP32_POLICY,
                                 device="cpu")
    ck.import_omniparser(sd, port)
    with torch.no_grad():
        got = port(t(data["in_image"]),
                   {k: t(data[f"in_seq_{k}"]) for k in ("pt", "poly", "rec")})
    rtol, atol = G.TOLERANCES["omniparser"]
    for k in ("pt", "poly", "rec"):
        np.testing.assert_allclose(got[k].numpy(), data[f"out_{k}"],
                                   rtol=rtol, atol=atol, err_msg=k)


# ---------------- the vie, table-html and table-eval commands ----------------


CLI_SIZE = 64


@pytest.fixture(scope="module")
def cli_pages(tmp_path_factory):
    """A seeded 90 x 70 PNG page and a PubTabNet jsonl of 3 seeded
    records over PNG tables of odd sizes."""
    import json
    from PIL import Image

    from test_torch_pubtabnet import seeded_record

    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(9)
    Image.fromarray(rng.integers(0, 256, (90, 70, 3), np.uint8)).save(
        root / "page.png")
    recs = []
    for i in range(3):
        name = f"t{i}.png"
        Image.fromarray(rng.integers(0, 256, (41 + 13 * i, 97 - 11 * i, 3),
                                     np.uint8)).save(root / name)
        recs.append(seeded_record(20 + i, name))
    (root / "gt.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    return root


@pytest.fixture(scope="module")
def jax_infer(jax_run):
    """This file's JAX model, its carried weights and its `infer_vie` on a
    float page, jitted once for the module: the JAX CLI's table builder
    and `vie` command both run it."""
    jm = jomni.OmniParser(configs()[0], policy=J_FP32)
    infer = jax.jit(lambda vv, x: jm.apply(vv, x, method=jm.infer_vie),
                    compiler_options=FAST_COMPILE)
    return jm, {"params": jax_run["params"]}, infer


def both_clis(monkeypatch, capsys, port, jax_infer, argv, rc=0):
    """Run `argv` through the JAX CLI and the port's (`--device cpu`), each
    building this file's model with its weights, each to exit code `rc`;
    → (JAX JSON, port JSON). The JAX CLI's table builder and `vie`'s
    model run `jax_infer`'s jitted function (for `vie`, `jax.jit` is the
    identity, so that its one compiled graph serves both)."""
    import json

    from advancedliteratemachinery_tpu import cli as jcli
    from advancedliteratemachinery_tpu.ops.image import normalize_crops
    from advancedliteratemachinery_tpu_torch import cli as tcli

    jm, variables, infer = jax_infer
    jcfg = configs()[0]

    def run_page(page_u8):
        x = normalize_crops(jnp.asarray(page_u8[None]), dtype=jnp.float32)
        return {k: np.asarray(val) for k, val in infer(variables, x).items()}

    class Carried:
        """The JAX `vie` command's `OmniParser(cfg)`: this file's model,
        whose init gives the carried weights."""

        def __init__(self, cfg):
            self.infer_vie = jm.infer_vie

        def init(self, *_):
            return variables

        def apply(self, vv, x, method):
            return infer(vv, x)

    monkeypatch.setattr(jomni, "OmniParser", Carried)
    monkeypatch.setattr(jomni, "OmniParserConfig", lambda **kw: jcfg)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    monkeypatch.setattr(jcli, "_build_table_model", lambda args: (
        jm, jcfg.vocab(), variables, run_page))
    monkeypatch.setattr(tcli, "_omniparser", lambda args, n: port)
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(argv + extra) == rc
        outs.append(json.loads(capsys.readouterr().out))
    monkeypatch.undo()
    return outs


def assert_json_close(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-5, abs=1e-5), path
    else:
        assert got == want, path


def test_cli_vie_matches_jax(monkeypatch, capsys, port, jax_infer,
                             cli_pages):
    page = str(cli_pages / "page.png")
    want, got = both_clis(monkeypatch, capsys, port, jax_infer,
                          ["vie", page, "--image-size", str(CLI_SIZE)])
    assert_json_close(got, want)
    assert got["image"] == page and len(got["entities"]) >= 1


def test_cli_table_html_matches_jax(monkeypatch, capsys, port,
                                    jax_infer, cli_pages):
    argv = ["table-html", str(cli_pages / "t1.png"), "--image-size",
            str(CLI_SIZE)]
    want, got = both_clis(monkeypatch, capsys, port, jax_infer,
                          argv)
    assert_json_close(got, want)
    assert got["html"].startswith("<table>") and got["cells"]


def test_cli_table_eval_matches_jax(monkeypatch, capsys, port,
                                    jax_infer, cli_pages):
    argv = ["table-eval", str(cli_pages / "gt.jsonl"), "--img-root",
            str(cli_pages), "--per-sample", "--image-size", str(CLI_SIZE)]
    want, got = both_clis(monkeypatch, capsys, port, jax_infer,
                          argv)
    assert_json_close(got, want)
    assert got["samples"] == 3 and 0 < got["s_teds"] <= 1
    want, got = both_clis(monkeypatch, capsys, port, jax_infer,
                          argv + ["--split", "none"], rc=1)
    assert got == want and got["error"] == "no samples matched"
