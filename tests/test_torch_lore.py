"""LORE-TSR port (models/dla, ops/heatmap, models/lore, engine/convert)
against the JAX package on the CPU, at `tests/test_lore.py`'s TINY_LORE
(64x64 pages), with the same numpy-seeded weights carried across by
engine/convert (their tree shaped from the port's module, `flax_zeros`);
float32 on both sides.

On the JAX side the DLA's `DeformConv2d` is swapped, in this file only, for
a subclass whose `window_radius` defaults to None: the gather formulation,
which the JAX package states and `tests/test_deform_window.py` proves is the
same function as the windowed dispatch, and which compiles in seconds
instead of minutes; and in its im2col form (`deform_conv2d`'s
`per_tap=False`: one gather of all taps and one contraction, the same
function again), which compiles in a quarter of the per-tap form's time.
`tests/test_torch_deform_conv.py` holds the port against the windowed
dispatch itself, and against the per-tap form.
"""

import copy
import dataclasses
import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedliteratemachinery_tpu.models.dla as jdla
import advancedliteratemachinery_tpu.ops.deform_conv as jdcn
import golden_common as G
import test_dla_import as DLA_IMPORT
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.engine.checkpoint import (
    import_dla, load_torch_state_dict)
from advancedliteratemachinery_tpu.models.lore import LORE as JLORE
from advancedliteratemachinery_tpu.ops import heatmap as jheat
from advancedliteratemachinery_tpu.ops.deform_conv import (
    DeformConv2d as JDeformConv2d)
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine import checkpoint as port_ck
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict, load_flax_params)
from advancedliteratemachinery_tpu_torch.models.dla import (
    DLAConfig, DLASeg, DLASegConfig, UpsampleBilinear)
from advancedliteratemachinery_tpu_torch.models.lore import LORE, LoreConfig
from advancedliteratemachinery_tpu_torch.ops import heatmap as theat
from test_lore import TINY_LORE as J_TINY_LORE
from test_torch_mgp_str import FAST_COMPILE, flax_zeros

torch.set_num_threads(2)

MAP_TOL = dict(rtol=1e-5, atol=1e-5)   # of each map's max; f32 sum order


class GatherDeformConv2d(JDeformConv2d):
    window_radius: Optional[int] = None


def use_gather_dcn(mp):
    """Within MonkeyPatch `mp`, the JAX DLA's DCNs in the gather
    formulation, im2col form."""
    mp.setattr(jdla, "DeformConv2d", GatherDeformConv2d)
    mp.setattr(jdcn, "deform_conv2d",
               functools.partial(jdcn.deform_conv2d, per_tap=False))


def port_config(j):
    """The port's LoreConfig with the same fields as JAX config `j`."""
    bb = j.backbone
    seg = DLASegConfig(dla=DLAConfig(**dataclasses.asdict(bb.dla)),
                       **{f.name: getattr(bb, f.name)
                          for f in dataclasses.fields(bb) if f.name != "dla"})
    return LoreConfig(backbone=seg, **{
        f.name: getattr(j, f.name) for f in dataclasses.fields(j)
        if f.name != "backbone"})


def random_lore_tree(shapes, seed=0):
    """Fill a flax variable tree from a numpy seed: kernels N(0, 1/fan_in),
    biases N(0, 0.1), std-norm alphas and BatchNorm scales near 1,
    BatchNorm means N(0, 0.3) and variances in [0.5, 2], embeddings
    N(0, 0.3). The DCN offset/mask convs get a bias of N(0, 2) so that many
    offsets land beyond ±3 (the TPU window)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [p.key for p in path]
        name = keys[-1]
        n = rng.standard_normal(s.shape)
        if name == "kernel" and len(s.shape) == 3:       # bilinear up
            n = rng.uniform(0.0, 0.5, s.shape)
        elif name == "kernel":
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale",) or name.endswith("_alpha"):
            n = 1.0 + 0.1 * n
        elif name == "var":
            n = rng.uniform(0.5, 2.0, s.shape)
        elif name == "mean":
            n = 0.3 * n
        elif name == "bias" and "conv_offset_mask" in keys:
            n = 2.0 * n
        elif name == "embedding":
            n = 0.3 * n
        else:                                             # biases
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def lore_pair():
    """JAX LORE.infer outputs (with the backbone's head maps captured in
    the same compiled run), the port model with the same weights, and the
    page batch."""
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    tm = LORE(port_config(J_TINY_LORE), policy=FP32_POLICY, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        use_gather_dcn(mp)
        jm = JLORE(J_TINY_LORE, policy=J_FP32)
        variables = random_lore_tree(flax_zeros(tm))
        want, state = jax.jit(lambda v, x: jm.apply(
            v, x, method=JLORE.infer,
            capture_intermediates=lambda m, n: (m.name == "backbone"
                                                and n == "__call__")),
            compiler_options=FAST_COMPILE)(variables, jnp.asarray(x))
    want = jax.tree_util.tree_map(np.asarray, want)
    maps = jax.tree_util.tree_map(
        np.asarray, state["intermediates"]["backbone"]["__call__"][0])
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    return want, maps, tm, x, variables


def test_dlaseg_head_maps_match(lore_pair):
    want, maps, tm, x, _ = lore_pair
    offsets_beyond = []

    def hook(mod, inp, _):
        com = mod.conv_offset_mask
        om = torch.nn.functional.conv2d(inp[0].permute(0, 3, 1, 2),
                                        com.weight, com.bias, padding=1)
        offsets_beyond.append((om[:, :18].abs() > 3).float().mean().item())

    handles = [m.register_forward_hook(hook) for m in tm.modules()
               if type(m).__name__ == "DeformConv2d"]
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for h in handles:
        h.remove()
    assert len(offsets_beyond) == 16           # 2 + 4 + 6 neck, 4 final
    assert min(offsets_beyond) > 0.01, offsets_beyond
    assert set(got) == set(maps)
    for head, w in maps.items():
        assert got[head].shape == w.shape
        scale = np.abs(w).max()
        np.testing.assert_allclose(got[head].numpy() / scale, w / scale,
                                   **MAP_TOL, err_msg=head)


def test_infer_matches(lore_pair):
    want, maps, tm, x, _ = lore_pair
    with torch.no_grad():
        got = tm.infer(torch.from_numpy(x))
        t_maps = tm(torch.from_numpy(x))
    # both top-K stages pick the same cells and corners from each side's
    # own head maps
    cfg = tm.config
    for ch, k in ((0, cfg.top_k), (1, cfg.corner_k)):
        j_hm = jheat.sigmoid_clamped(jnp.asarray(maps["hm"][..., ch:ch + 1]))
        t_hm = theat.sigmoid_clamped(t_maps["hm"][..., ch:ch + 1])
        np.testing.assert_array_equal(
            theat.topk_peaks(theat.heatmap_peaks(t_hm), k)["inds"].numpy(),
            np.asarray(jheat.topk_peaks(jheat.heatmap_peaks(j_hm), k)[
                "inds"]))
    assert set(got) == set(want) == {"detections", "logic", "raw_logic",
                                     "scores", "corners", "corner_scores"}
    # the same cells in the same order: scores, then class and position
    np.testing.assert_array_equal(got["detections"][..., 9].numpy(),
                                  want["detections"][..., 9])
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g / scale, w / scale, **MAP_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_bilinear_matches(factor):
    """A random (not bilinear, so not symmetric) kernel through the JAX
    module's pixel-shuffle path and the port's transposed conv."""
    rng = np.random.default_rng(factor)
    C = 3
    x = rng.standard_normal((2, 5, 7, C)).astype(np.float32)
    kernel = rng.standard_normal((2 * factor, 2 * factor, C)).astype(
        np.float32)
    want = jdla.UpsampleBilinear(factor).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x))
    up = UpsampleBilinear(factor, C)
    up.load_state_dict({"kernel": torch.from_numpy(kernel)})
    with torch.no_grad():
        got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 5 * factor, 7 * factor, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _tie_maps(seed=0):
    """Heat logits with few peaks and wide plateaus that saturate the
    clamped sigmoid at 1e-4 and 1 - 1e-4, so that top-K (K above the number
    of peaks) must order exact ties; plus regression maps."""
    rng = np.random.default_rng(seed)
    B, H, W = 2, 12, 10
    logits = np.full((B, H, W, 2), -20.0, np.float32)
    logits[:, 2:4, 2:5] = 20.0                       # saturated plateau
    for b in range(B):
        for _ in range(3):                           # distinct peaks
            y, x = rng.integers(0, H), rng.integers(0, W)
            logits[b, y, x] = rng.uniform(-2, 2, 2)
    maps = {n: rng.standard_normal((B, H, W, c)).astype(np.float32)
            for n, c in (("wh", 8), ("ax", 6), ("cr", 6), ("reg", 2),
                         ("st", 8))}
    maps["wh"] *= 3.0
    return logits, maps


TIE_KS = (5, 24, 60)


@pytest.fixture(scope="module")
def tie_refs():
    """The JAX side of the tie tests for every K, built once: the heat
    maps' clamped sigmoid, the top-K peaks, the cell decode and the corner
    decode, each K one jitted call."""
    logits, m = _tie_maps()
    j = {n: jnp.asarray(v) for n, v in m.items()}

    def refs(logits, j, k):
        j_hm = jheat.sigmoid_clamped(logits)
        return (j_hm, jheat.topk_peaks(jheat.heatmap_peaks(j_hm), k),
                jheat.ctdet_4ps_decode(j_hm[..., :1], j["wh"], j["ax"],
                                       j["cr"], reg=j["reg"], k=k),
                jheat.corner_decode(j_hm[..., 1:], j["st"], j["reg"], k=k))

    run = jax.jit(refs, static_argnums=2, compiler_options=FAST_COMPILE)
    return {k: jax.tree_util.tree_map(np.asarray,
                                      run(jnp.asarray(logits), j, k))
            for k in TIE_KS}


@pytest.mark.parametrize("k", TIE_KS)
def test_decode_ties_give_the_same_inds(k, tie_refs):
    logits, m = _tie_maps()
    t = {n: torch.from_numpy(v) for n, v in m.items()}
    j_hm, want_peaks, want_cells, want_corners = tie_refs[k]
    t_hm = theat.sigmoid_clamped(torch.from_numpy(logits))
    np.testing.assert_array_equal(t_hm.numpy(), j_hm)

    got = theat.topk_peaks(theat.heatmap_peaks(t_hm), k)
    for key in ("inds", "clses", "scores", "ys", "xs"):
        np.testing.assert_array_equal(got[key].numpy(), want_peaks[key],
                                      err_msg=key)

    got = theat.ctdet_4ps_decode(t_hm[..., :1], t["wh"], t["ax"], t["cr"],
                                 reg=t["reg"], k=k)
    np.testing.assert_array_equal(got["inds"].numpy(), want_cells["inds"])
    for key in ("detections", "cr_feat", "ax_feat", "centers"):
        np.testing.assert_allclose(got[key].numpy(), want_cells[key],
                                   rtol=1e-6, atol=1e-6, err_msg=key)

    got = theat.corner_decode(t_hm[..., 1:], t["st"], t["reg"], k=k)
    np.testing.assert_array_equal(got["inds"].numpy(), want_corners["inds"])
    np.testing.assert_allclose(got["gboxes"].numpy(), want_corners["gboxes"],
                               rtol=1e-6, atol=1e-6)


def test_golden_replay_into_port_dlaseg(monkeypatch):
    """tests/golden/lore.pth (a torch DLASeg artifact) → the port's own
    `load_torch_state_dict` and `import_dla` → the port's DLASeg must give
    the committed outputs at the golden's own tolerance. The JAX route (the
    JAX loader and `import_dla` onto a zero-filled tree from
    `jax.eval_shape`, carried over by engine/convert) must give exactly the
    same state dict. (Tracing the windowed DCN only for its shapes takes
    seconds; the gather form has the same ones.)"""
    use_gather_dcn(monkeypatch)
    pth = os.path.join(G.GOLDEN_DIR, "lore.pth")
    data = np.load(os.path.join(G.GOLDEN_DIR, "lore.npz"))
    M = DLA_IMPORT
    cfg = DLASegConfig(dla=DLAConfig(levels=M.LEVELS, channels=M.CH),
                       head_conv=M.HEAD_CONV, heads=M.HEADS)
    tm = DLASeg(cfg, policy=FP32_POLICY, device="cpu")
    got_sd = port_ck.import_dla(port_ck.load_torch_state_dict(pth), tm)
    with torch.no_grad():
        got = tm(torch.from_numpy(data["in_image"]))
    rtol, atol = G.TOLERANCES["lore"]
    for head in ("hm", "reg"):
        np.testing.assert_allclose(got[head].numpy(), data[f"out_{head}"],
                                   rtol=rtol, atol=atol, err_msg=head)

    jcfg = jdla.DLASegConfig(dla=jdla.DLAConfig(levels=M.LEVELS,
                                                channels=M.CH),
                             head_conv=M.HEAD_CONV, heads=M.HEADS)
    jm = jdla.DLASeg(jcfg, policy=J_FP32)
    shapes = jax.eval_shape(
        lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    variables = import_dla(load_torch_state_dict(pth), dict(zeros))
    want_sd = flax_state_dict(tm, variables["params"],
                              variables["batch_stats"])
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


def test_convert_rejects_mismatched_lore_trees(lore_pair):
    *_, tm, _, variables = lore_pair
    params, stats = variables["params"], variables["batch_stats"]
    flax_state_dict(tm, params, stats)
    bad = copy.deepcopy(params)
    del bad["processor"]["x_pe"]
    with pytest.raises(KeyError, match="missing.*processor.x_pe.weight"):
        flax_state_dict(tm, bad, stats)
    bad = copy.deepcopy(params)
    bad["processor"]["extra"] = {"embedding": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unused.*processor.extra.weight"):
        flax_state_dict(tm, bad, stats)
    for path, key in (
            (("backbone", "ida_up", "up_1"), "backbone.ida_up.up_1.kernel"),
            (("backbone", "ida_up", "node_1", "dcn"),
             "backbone.ida_up.node_1.dcn.weight")):
        bad = copy.deepcopy(params)
        leaf = bad
        for p in path:
            leaf = leaf[p]
        leaf["kernel"] = leaf["kernel"][..., :-1]
        with pytest.raises(ValueError, match=key):
            flax_state_dict(tm, bad, stats)


def test_table_predict_fn_matches(lore_pair, monkeypatch):
    """`make_table_predict_fn` on a 96x80 page: the JAX function runs its
    own code (cv2 resize, post-processing) with its `jax.jit` pointed at
    the fixture's outputs for page 0, and the port's runs with a model
    that returns the same outputs. The port's model must receive the
    page resized as cv2 does (within one uint8 level over 255), and both
    sides must keep the same cells, map them back to the same polygons
    and round the same logical coordinates."""
    import cv2

    import advancedliteratemachinery_tpu.models.lore as jlore
    from advancedliteratemachinery_tpu_torch.models.lore import (
        make_table_predict_fn)

    want, *_ = lore_pair
    page = np.random.default_rng(7).integers(0, 256, (96, 80, 3),
                                             dtype=np.uint8)
    one = {k: v[:1] for k, v in want.items()}
    thresh = float(np.median(one["scores"]))
    monkeypatch.setattr(jlore.jax, "jit", lambda f: lambda v, x: one)
    jout = jlore.make_table_predict_fn(None, None, input_size=64,
                                       score_thresh=thresh)(page)

    class Stub(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))
            self.seen = []

        def infer(self, x):
            self.seen.append(x)
            return {k: torch.from_numpy(np.array(v)) for k, v in one.items()}

    stub = Stub()
    tout = make_table_predict_fn(stub, input_size=64,
                                 score_thresh=thresh)(page)
    resized = cv2.resize(page, (64, 64)).astype(np.float32) / 255.0
    assert stub.seen[0].shape == (1, 64, 64, 3)
    assert np.abs(stub.seen[0][0].numpy() - resized).max() <= 1.0 / 255 + 1e-6
    assert 0 < len(jout["polygons"]) < len(one["scores"][0])
    np.testing.assert_array_equal(tout["logi_coords"], jout["logi_coords"])
    assert tout["polygons"].dtype == jout["polygons"].dtype == np.float32
    np.testing.assert_allclose(tout["polygons"], jout["polygons"],
                               rtol=1e-6, atol=1e-5)
