"""DocXLayout port (models/dla DLASegV0, models/docxlayout, engine/convert,
engine/checkpoint import_docxlayout) against the JAX package on the CPU,
float32 on both sides.

One jitted JAX run at `tests/test_docxlayout.py`'s TINY (64x64 page) gives
the head maps (captured inside the run) and `infer`'s outputs for a
numpy-seeded tree whose up kernels are random, not bilinear (a symmetric
kernel hides a flipped transposed conv), with the same weights carried to
the port by engine/convert. The JAX `make_layout_predict_fn` runs its own
code on that compiled function (its `jax.jit` is pointed at it, so the
model compiles once)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import advancedliteratemachinery_tpu.models.docxlayout as jdocx
import golden_common as G
import test_dla_import as MIRROR_DLA
import test_docxlayout_import as MIRROR
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.engine.checkpoint import (
    import_docxlayout as j_import_docxlayout)
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine import checkpoint as ck
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict, load_flax_params)
from advancedliteratemachinery_tpu_torch.models.dla import DLAConfig
from advancedliteratemachinery_tpu_torch.models.docxlayout import (
    DocXLayout, DocXLayoutConfig, make_layout_predict_fn)
from test_docxlayout import TINY as J_TINY
from test_torch_lore import random_lore_tree
from test_torch_mgp_str import FAST_COMPILE, flax_zeros

torch.set_num_threads(2)

REL_TOL = 1e-4        # of each output's largest magnitude, float32


def port_config(j):
    return DocXLayoutConfig(
        dla=DLAConfig(**dataclasses.asdict(j.dla)),
        **{f.name: getattr(j, f.name) for f in dataclasses.fields(j)
           if f.name != "dla"})


def rel_close(got, want, tol=REL_TOL, msg=""):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, rtol=0, atol=tol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def docx_pair():
    """The JAX run (infer outputs, head maps, the predict fn's results at
    two thresholds) and the port model with the same weights."""
    rng = np.random.default_rng(3)
    page = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    jm = jdocx.DocXLayout(J_TINY, policy=J_FP32)
    tm = DocXLayout(port_config(J_TINY), policy=FP32_POLICY, device="cpu")
    shapes = flax_zeros(tm)          # the JAX model's tree, from the port's
    variables = random_lore_tree(shapes, seed=4)
    compiled = jax.jit(lambda v, x: jm.apply(
        v, x, method=jm.infer,
        capture_intermediates=lambda m, n: (m.name == "backbone"
                                            and n == "__call__")),
        compiler_options=FAST_COMPILE)
    calls = []

    def run(v, x):
        out, state = compiled(v, x)
        calls.append(jax.tree_util.tree_map(np.asarray, (
            out, state["intermediates"]["backbone"]["__call__"][0])))
        return out

    preds = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdocx.jax, "jit", lambda f: run)
        for thresh in (0.0, None):
            if thresh is None:      # a threshold inside the scores
                thresh = float(np.median(calls[0][0]["detections"][0, :, 8]))
            m = jdocx.DocXLayout(dataclasses.replace(
                J_TINY, score_threshold=thresh), policy=J_FP32)
            preds[thresh] = jdocx.make_layout_predict_fn(m, variables)(page)
    want, maps = calls[0]
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    return want, maps, preds, tm, page, shapes


def test_dlasegv0_head_maps_match(docx_pair):
    want, maps, _, tm, page, _ = docx_pair
    with torch.no_grad():
        got = tm(torch.from_numpy(page)[None].float() / 255.0)
    assert set(got) == set(maps) == {h for h, _ in
                                     port_config(J_TINY).seg_config().heads}
    for head, w in maps.items():
        assert got[head].shape == w.shape
        rel_close(got[head].numpy(), w, msg=head)


def test_infer_matches(docx_pair):
    want, _, _, tm, page, _ = docx_pair
    with torch.no_grad():
        got = tm.infer(torch.from_numpy(page)[None].float() / 255.0)
    assert set(got) == set(want)
    # the same centers in the same order, each side from its own maps
    np.testing.assert_array_equal(got["detections"][..., 9].numpy(),
                                  want["detections"][..., 9])
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        rel_close(got[k].numpy(), w, msg=k)


def test_layout_predict_fn_matches(docx_pair):
    _, _, preds, tm, page, _ = docx_pair
    config = tm.config
    kept = []
    try:
        for thresh, (jq, js, jc) in preds.items():
            tm.config = dataclasses.replace(config, score_threshold=thresh)
            q, s, c = make_layout_predict_fn(tm)(page)
            assert len(q) == len(jq) > 0, thresh
            np.testing.assert_array_equal(c, jc)
            rel_close(q, jq, msg="quads")
            rel_close(s, js, msg="scores")
            kept.append(len(q))
    finally:
        tm.config = config
    assert kept[0] == J_TINY.top_k > kept[1]     # the threshold cut some


TINY_HEADS = tuple(port_config(J_TINY).seg_config().heads)


def mirror_state(monkeypatch, seed=0):
    """The reference-layout state dict of the JAX import test's torch
    mirror of dlav0_subfield.py, built at TINY's widths, heads and depths
    (its module constants swapped), BatchNorm statistics drawn from a
    numpy seed."""
    for mod in (MIRROR, MIRROR_DLA):
        monkeypatch.setattr(mod, "CH", J_TINY.dla.channels)
    monkeypatch.setattr(MIRROR_DLA, "LEVELS", J_TINY.dla.levels)
    monkeypatch.setattr(MIRROR, "HEADS", TINY_HEADS)
    monkeypatch.setattr(MIRROR, "HEAD_CONV", J_TINY.head_conv)
    torch.manual_seed(seed)
    sd = dict(MIRROR.TDLASegV0().eval().state_dict())
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if k.endswith(("running_mean", "bias")) and v.dtype.is_floating_point:
            sd[k] = torch.from_numpy(rng.normal(0, 0.3, v.shape).astype(
                np.float32))
        elif k.endswith(("running_var", "weight")) and v.ndim == 1:
            sd[k] = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape).astype(
                np.float32))
    return sd


GOLDEN_CFG = DocXLayoutConfig(
    num_classes=3, num_secondary_classes=2, top_k=8, top_k_sub=4,
    dla=DLAConfig(levels=MIRROR.LEVELS, channels=MIRROR.CH),
    head_conv=MIRROR.HEAD_CONV)


def test_import_docxlayout_equals_jax_route(docx_pair, monkeypatch):
    """The port's importer against the JAX importer + engine/convert, on
    the mirror's state dict at TINY (the JAX tree from the fixture's
    shapes): the same tensors, bit for bit."""
    *_, tm, _, shapes = docx_pair
    sd = mirror_state(monkeypatch)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    jvars = j_import_docxlayout({k: v.numpy() for k, v in sd.items()},
                                zeros)
    port = DocXLayout(port_config(J_TINY), policy=FP32_POLICY, device="cpu")
    want = flax_state_dict(port, jvars["params"], jvars["batch_stats"])
    got = ck.import_docxlayout({f"model.{k}": v for k, v in sd.items()},
                               port, prefix="model.")
    assert set(got) == set(want) == set(tm.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert "backbone.dla_up.ida_0.up_1.kernel" in got


def test_golden_docxlayout_replays():
    sd = ck.load_torch_state_dict(f"{G.GOLDEN_DIR}/docxlayout.pth")
    data = np.load(f"{G.GOLDEN_DIR}/docxlayout.npz")
    port = DocXLayout(GOLDEN_CFG, policy=FP32_POLICY, device="cpu")
    ck.import_docxlayout(sd, port)
    with torch.no_grad():
        got = port(torch.from_numpy(data["in_image"]))
    rtol, atol = G.TOLERANCES["docxlayout"]
    for head, _ in MIRROR.HEADS:
        np.testing.assert_allclose(got[head].numpy(), data[f"out_{head}"],
                                   rtol=rtol, atol=atol, err_msg=head)
