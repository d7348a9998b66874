"""LORE-TSR training in the port (models/layers train-mode BatchNorm,
models/dla, ops/deform_conv's DeformConvFunction, models/lore's training
side, engine/batches, engine/recipes, engine/fit, the `train lore`
command) against the JAX package on the CPU, at `tests/test_lore.py`'s
TINY_LORE on 64x64 pages, with the same numpy-seeded weights carried
across by engine/convert.

The JAX recipe runs in float64 (`jax_float64`) and the port runs twice,
in float64 and in float32. The port's float64 run is held to the JAX one
at 1e-5 of each value's scale (TOL64): the same function, whatever either
side rounds. The port's float32 run is held to the same float64 truth,
within twice the distance of the JAX package's own float32 run of this
fixture from it (F32): the JAX float32 BatchNorm takes its variance as
E[x²] − E[x]², whose cancellation puts its maps 4.7e-4 of their scale
from the truth, and the port's 8.1e-5.

As in `tests/test_torch_lore.py`, the JAX DLA's `DeformConv2d` takes the
gather formulation (`window_radius=None`) for the train step, here in its
im2col form (`per_tap=False`, the same function), whose gradient is the
one the JAX `_dcn_dispatch` backward returns and which compiles fastest;
`test_dcn_gradients_match_jax_dispatch` holds the port's DCN gradients
against `jax.vjp` of `_dcn_dispatch` itself.
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree
import pytest
import torch
from PIL import Image

import advancedliteratemachinery_tpu.ops.deform_conv as jdcn
from advancedliteratemachinery_tpu.core.precision import Policy as JPolicy
from advancedliteratemachinery_tpu.engine import batches as JB
from advancedliteratemachinery_tpu.engine.train import (
    make_optimizer as j_make_optimizer)
from advancedliteratemachinery_tpu.models import lore as jlore
from advancedliteratemachinery_tpu.models.dla import (
    DLA as JDLA, DLAConfig as JDLAConfig)
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine import batches as TB
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict, load_flax_params)
from advancedliteratemachinery_tpu_torch.engine.fit import (
    latest_checkpoint_step)
from advancedliteratemachinery_tpu_torch.engine.train import (
    TrainState, make_optimizer)
from advancedliteratemachinery_tpu_torch.models import lore as tlore
from advancedliteratemachinery_tpu_torch.ops.deform_conv import (
    DeformConvFunction, deform_conv2d_plain)
from advancedliteratemachinery_tpu_torch.ops.image import (
    normalize_crops as t_normalize)
from test_lore import TINY_LORE as J_TINY_LORE
from test_torch_lore import port_config, random_lore_tree, use_gather_dcn
from test_torch_mgp_str import FAST_COMPILE, flax_zeros

torch.set_num_threads(2)

HW = (64, 64)
MAX_CELLS = 8
OPT = dict(lr=1e-3, total_steps=10, grad_clip=0.5)      # the clip acts
TOL64 = 1e-5            # the port in float64 against the JAX recipe in float64
# The port in float32 against the float64 truth, within twice the distance
# of the JAX package's own float32 run of this fixture from it (JAX_F32, in
# units of each value's scale; the port's own reading in brackets): the
# train-mode head maps and logic (8.1e-5), the running statistics after one
# forward (9.2e-7), the first step's gradients, in units of the largest one
# (4.4e-3), and the first loss (4.7e-7). After Adam updates, which move each
# weight by about ±lr whatever its gradient's size, so that a weight whose
# gradient is within the rounding of its sums moves either way: the second
# and third losses (8.6e-3), the running statistics after three steps
# (1.6e-2), and the share of weights farther than
# `tests/test_torch_train_steps.py`'s 0.05·lr·3 (0.56; its bound the JAX
# run's share + 0.1).
JAX_F32 = dict(maps=4.7e-4, stats=6.4e-6, grads=5.4e-2, loss=3.9e-6,
               later_loss=1.9e-2, later_stats=2.5e-2, share=0.68)


def float32_bounds(readings):
    return {k: v + 0.1 if k == "share" else 2 * v
            for k, v in readings.items()}


F32 = float32_bounds(JAX_F32)
# FAST_COMPILE, and LLVM's expensive passes off: the train step's
# backward through 16 gather DCNs compiles in seconds instead of a minute
TRAIN_COMPILE = {**FAST_COMPILE, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, *args):
    return fn.lower(*args).compile(TRAIN_COMPILE)


def _cells(rng, n, size):
    """n cells of a table grid on a page of `size` pixels: [n, 8] corner
    lists and their logical coordinates [n, 4]."""
    out, logic = [], []
    for k in range(n):
        r, c = divmod(k, 3)
        x0, y0 = 8 + 38 * c + rng.uniform(0, 4), 10 + 26 * r
        x1, y1 = x0 + rng.uniform(20, 34), y0 + rng.uniform(14, 22)
        out.append([x0, y0, x1, y0 + rng.uniform(-1, 1), x1, y1, x0, y1])
        logic.append([r, r, c, c + (k == 4)])
    return out, logic


@pytest.fixture(scope="module")
def table_json(tmp_path_factory):
    """Two 128x128 table pages written as PNG by PIL (random ink) with a
    COCO table json: 5 and 3 cells, so that 8-cell rows carry padding;
    a third image whose file is missing."""
    tmp = tmp_path_factory.mktemp("tables")
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i, n in enumerate((5, 3, 2)):
        name = f"t{i}.png"
        if i < 2:
            page = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
            Image.fromarray(page).save(tmp / name)
        images.append({"id": i + 1, "file_name": name, "height": 128,
                       "width": 128})
        cells, logic = _cells(rng, n, 128)
        anns += [{"id": len(anns) + k + 1, "image_id": i + 1,
                  "segmentation": c, "logic_axis": a}
                 for k, (c, a) in enumerate(zip(cells, logic))]
    path = tmp / "tables.json"
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return str(tmp), str(path)


def dcn_case():
    """`test_dcn_gradients_match_jax_dispatch`'s inputs: x, offsets (a share
    past the window radius, 3), mask (a zero row), weights, bias and the
    upstream gradient g."""
    rng = np.random.default_rng(7)
    B, H, W, CI, CO = 1, 9, 10, 3, 4
    x = rng.standard_normal((B, H, W, CI)).astype(np.float32)
    off = rng.uniform(-2.5, 2.5, (B, H, W, 9, 2))
    far = rng.random(off.shape[:-1]) < 0.15
    off[far] = rng.uniform(-7, 7, (int(far.sum()), 2))
    off = off.astype(np.float32)
    m = rng.uniform(0, 1, (B, H, W, 9)).astype(np.float32)
    m[0, 0] = 0.0
    w = rng.standard_normal((3, 3, CI, CO)).astype(np.float32)
    bias = rng.standard_normal((CO,)).astype(np.float32)
    g = rng.standard_normal((B, H, W, CO)).astype(np.float32)
    return x, off, m, w, bias, g


def j_dcn_grads(x, off, m, w, g):
    """The JAX `_dcn_dispatch` backward (`_dcn_dispatch_bwd`, what
    `jax.vjp` of the dispatch runs: the VJP of its gather form) at window
    radius 3; the bias is added after the dispatch, so its gradient is the
    sum of g."""
    return jdcn._dcn_dispatch_bwd(1, 1, True, 3, (x, off, m, w), g) + (
        g.sum((0, 1, 2)),)


TREE = dict(levels=(1, 1, 1, 2, 1, 1), channels=(4, 8, 8, 16, 16, 32))


def tree_case():
    """`test_tree_projection_stats_match_jax`'s port DLA trunk (two-level
    Trees, as DLA-34's levels 3 and 4), its seeded flax tree, loaded, and
    its input."""
    from advancedliteratemachinery_tpu_torch.models.dla import DLA, DLAConfig

    tm = DLA(DLAConfig(**TREE), policy=FP32_POLICY)
    variables = random_lore_tree(flax_zeros(tm), seed=2)
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    return tm, variables, x


@contextlib.contextmanager
def jax_float64():
    """The JAX package in float64: x64 on, and `jnp.float32` read as
    `jnp.float64` while a function is traced, so that the casts the package
    makes to float32 (its BatchNorm's `dtype`, under which flax sums the
    statistics; the heads' outputs; the losses) keep float64 too. Yields the
    float64 Policy. Call what it traces inside it: outside, x64 is off and
    float64 arrays become float32."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        yield JPolicy(param_dtype=jnp.float64, compute_dtype=jnp.float64,
                      output_dtype=jnp.float64)


def to_float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@contextlib.contextmanager
def compiling(**lowered):
    """Compiles the JAX `lowered` functions (TRAIN_COMPILE) in threads,
    which XLA runs without the GIL, while the block runs the port; yields
    the dict of compiled functions, filled at the block's end."""
    out = {}
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        jobs = {k: pool.submit(lo.compile, TRAIN_COMPILE)
                for k, lo in lowered.items()}
        yield out
        out.update((k, job.result()) for k, job in jobs.items())


def lore_forward(model, b, dtype):
    x = t_normalize(b["images"], dtype=dtype)
    heads, logic = model.train_logic(x, b["ct_inds"], b["ct_mask"],
                                     b["gt_boxes"].to(dtype))
    return {**heads, **logic}


def port_runs(model, batches, recipe, forward, opt):
    """The port's `model` in float32 and in float64 (`float64_port`), each
    from `model`'s weights: the train-mode `forward(model, batch, dtype)`
    of the first batch with the running statistics it leaves, then a step
    of `recipe` through TrainState (`make_optimizer(**opt)`) on each batch,
    with the first step's gradients, each step's loss and the final state
    dict → {dtype: (maps, stats, grads, losses, state_dict)}."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        with (float64_port(model) if dtype == torch.float64
              else contextlib.nullcontext(copy.deepcopy(model))) as m:
            start = copy.deepcopy(m.state_dict())
            b = _torch_batch(batches[0])
            m.train()
            with torch.no_grad():
                maps = forward(m, b, dtype)
            stats = _bn_stats(m)
            m.load_state_dict(start)
            loss_fn, _ = recipe(m)
            state = TrainState.create(m, make_optimizer(**opt))
            grads, losses = None, []
            for b in batches:
                m.train()
                state.optimizer.zero_grad(set_to_none=True)
                loss, _ = loss_fn(_torch_batch(b))
                loss.backward()
                if grads is None:
                    grads = {n: p.grad.clone()
                             for n, p in m.named_parameters()}
                state.apply_gradients()
                losses.append(loss.item())
            out[dtype] = (maps, stats, grads, losses, m.state_dict())
    return out


@pytest.fixture(scope="module")
def train_pair(table_json):
    """Three batches from both batch builders; three JAX train steps of
    the recipe (`lore_recipe_u8` under `jax.value_and_grad`, then the
    optax chain) in float64, compiled once, which give each step's loss,
    its train-mode forward (head maps and Processor logic, captured from
    the recipe's `apply`), its gradients and the running statistics it
    leaves (`trace`); the final parameters and statistics; the port model
    (float32) with the first step's weights; the port's runs
    (`port_runs`), made while the JAX functions compile; and the JAX
    results of the DCN and Tree tests (`j_dcn_grads` on `dcn_case`, in
    float32; the trunk of `tree_case` in float64), compiled beside the
    train step."""
    folder, anno = table_json
    jds = JB.TableDataset(folder, anno)
    tds = TB.TableDataset(folder, anno)
    jit = JB.lore_batches(jds, 2, image_hw=HW, max_cells=MAX_CELLS, seed=3)
    tit = TB.lore_batches(tds, 2, image_hw=HW, max_cells=MAX_CELLS, seed=3)
    jbatches = [next(jit) for _ in range(3)]
    tbatches = [next(tit) for _ in range(3)]
    tm = tlore.LORE(port_config(J_TINY_LORE), policy=FP32_POLICY,
                    device="cpu")
    variables = random_lore_tree(flax_zeros(tm), seed=5)
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    x, off, m, w, _, g = dcn_case()
    dcn_args = [jnp.asarray(a) for a in (x, off, m, w, g)]
    lowered = {"dcn": jax.jit(j_dcn_grads).lower(*dcn_args)}
    with pytest.MonkeyPatch.context() as mp, jax_float64() as policy:
        use_gather_dcn(mp)
        jm = jlore.LORE(J_TINY_LORE, policy=policy)
        captured = []
        apply = jm.apply

        def capturing_apply(*args, **kw):
            out = apply(*args, **kw)
            captured.append(out[0])
            return out

        object.__setattr__(jm, "apply", capturing_apply)
        loss_fn, _ = JB.lore_recipe_u8(jm)
        tx = j_make_optimizer(**OPT)

        def traced_loss(params, bs, batch):
            captured.clear()
            loss, (_, new_bs) = loss_fn(params, bs, batch,
                                        jax.random.PRNGKey(0))
            return loss, (new_bs, captured[0])

        def grads(params, bs, batch):
            return jax.value_and_grad(traced_loss, has_aux=True)(
                params, bs, batch)

        def update(flat_g, opt, flat_p):
            upd, opt = tx.update(flat_g, opt, flat_p)
            return flat_p + upd, opt

        params, bs = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        # the optax chain on the parameters raveled into one vector: the
        # same clip (one global norm) and Adam (elementwise), compiled in
        # a fraction of the time of the tree's
        flat, unravel = ravel_pytree(params)
        opt = tx.init(flat)
        lowered["grads"] = jax.jit(grads).lower(params, bs, jbatches[0])
        lowered["update"] = jax.jit(update).lower(flat, opt, flat)
        jdla = JDLA(JDLAConfig(**TREE), policy=policy)
        _, tree_vars, tree_x = tree_case()
        tree_args = (to_float64(tree_vars), tree_x)
        lowered["tree"] = jax.jit(lambda v, x: jdla.apply(
            v, x, train=True, mutable=["batch_stats"])).lower(*tree_args)
        with compiling(**lowered) as compiled:
            port = port_runs(tm, tbatches, TB.lore_recipe_u8, lore_forward,
                             OPT)
        trace = []
        for b in jbatches:
            (loss, (bs, fwd)), grad = compiled["grads"](unravel(flat), bs, b)
            flat, opt = compiled["update"](ravel_pytree(grad)[0], opt, flat)
            trace.append((float(loss), bs, fwd, grad))
        out = to_float64((trace, unravel(flat), bs))
        tree = to_float64(compiled["tree"](*tree_args))
    dcn = [np.asarray(a) for a in compiled["dcn"](*dcn_args)]
    return out, tm, jbatches, tbatches, port, dcn, tree


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}


@contextlib.contextmanager
def float64_port(model):
    """A float64 copy of the port's `model`, in which every cast to float32
    is a cast to float64."""
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if hasattr(mod, "policy"):
            mod.policy = dataclasses.replace(mod.policy,
                                             compute_dtype=torch.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        yield m


def near(got, truth, tol, name, scale=0.0):
    """`got` within `tol` of `truth` in units of the truth's largest
    magnitude (at least `scale`)."""
    got, truth = (np.asarray(a, np.float64) for a in (got, truth))
    unit = max(np.abs(truth).max(), scale)
    err = np.abs(got - truth).max() / unit
    assert err <= tol, (name, err, tol)


def params_near(got64, got32, truth, lr, steps, share):
    """Weights after `steps` Adam steps: the float64 port within
    `tests/test_torch_train_steps.py`'s 0.05·lr·steps of the truth; the
    float32 port no farther than Adam's 2·lr a step, and at most a `share`
    of its weights beyond 0.05·lr·steps."""
    err64, err32 = (np.concatenate([np.abs(np.asarray(g[k], np.float64)
                                           - truth[k]).ravel()
                                    for k in truth]) for g in (got64, got32))
    bound = 0.05 * lr * steps
    assert err64.max() <= bound, (err64.max(), bound)
    assert err32.max() <= 2 * lr * steps, (err32.max(), lr)
    assert (err32 > bound).mean() <= share, (err32 > bound).mean()


def _bn_stats(model):
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def test_batches_match_jax(train_pair):
    """TableDataset + lore_batches on PIL-written PNGs (and a missing
    file, left zeros): the same pages, resized bit for bit, and the same
    targets."""
    _, _, jbatches, tbatches = train_pair[:4]
    assert any(b["ct_mask"].sum() < b["ct_mask"].size for b in jbatches)
    for jb, tb in zip(jbatches, tbatches):
        assert set(jb) == set(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def check_forward(port, truth, stats, f32):
    """The port's train-mode maps and the running statistics they leave
    against the JAX truth: float64 at TOL64, float32 within `f32`."""
    for dtype, maps_tol, stats_tol in (
            (torch.float64, TOL64, TOL64),
            (torch.float32, f32["maps"], f32["stats"])):
        maps, got_stats = port[dtype][:2]
        assert set(maps) == set(truth)
        for name, want in truth.items():
            near(maps[name], want, maps_tol, name)
        assert got_stats
        for name, got in got_stats.items():
            near(got, stats[name], stats_tol, name)


def check_steps(port, trace, grads_want, final, f32, lr):
    """The first step's gradients, each step's loss, and the parameters
    and running statistics after the steps, against the JAX truth
    (`grads_want` and `final` as state dicts of the port's model)."""
    weights = {k: w.numpy() for k, w in final.items()
               if not k.endswith(("running_mean", "running_var",
                                  "num_batches_tracked"))}
    # a gradient's rounding follows the largest gradient of the model (a
    # bias before a train-mode BatchNorm has a gradient of exactly 0 and
    # only rounding in float32)
    top = max(float(grads_want[k].abs().max()) for k in weights)
    for dtype, exact in ((torch.float64, True), (torch.float32, False)):
        _, _, grads, losses, sd = port[dtype]
        assert set(grads) == set(weights)
        for name, g in grads.items():
            near(g, grads_want[name], TOL64 if exact else f32["grads"], name,
                 scale=top)
        for k, step in enumerate(trace):
            near(losses[k], step[0], TOL64 if exact else
                 f32["later_loss" if k else "loss"], f"loss {k}")
        for name, w in final.items():
            if name.endswith(("running_mean", "running_var")):
                near(sd[name], w, TOL64 if exact else f32["later_stats"],
                     name)
    params_near(port[torch.float64][4], port[torch.float32][4], weights, lr,
                len(trace), f32["share"])


def test_train_forward_and_running_stats_match(train_pair):
    """train_logic in train() mode: head maps, Processor logic over padded
    cells, and the BatchNorm running statistics it leaves, against the
    JAX apply with mutable=["batch_stats"] in the first step."""
    (trace, _, _), tm, _, tbatches, port = train_pair[:5]
    _, stats, (heads, logic), _ = trace[0]
    assert len(port[torch.float32][1]) == 2 * sum(
        isinstance(m, torch.nn.BatchNorm2d) for m in tm.modules())
    check_forward(port, {**heads, **logic},
                  flax_state_dict(tm, flax_zeros(tm)["params"], stats), F32)
    # eval mode reads the running statistics and leaves them
    before = copy.deepcopy(tm.state_dict())
    with torch.no_grad():
        tm(t_normalize(_torch_batch(tbatches[0])["images"],
                       dtype=torch.float32))
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())


def test_three_steps_match_jax(train_pair):
    """The recipe (lore_recipe_u8) through TrainState: the first step's
    gradients, each step's loss, and the parameters and running statistics
    after three steps."""
    (trace, params, stats), tm, _, _, port = train_pair[:5]
    check_steps(port, trace, flax_state_dict(tm, trace[0][3], stats),
                flax_state_dict(tm, params, stats), F32, OPT["lr"])


def test_dcn_gradients_match_jax_dispatch(train_pair):
    """DeformConvFunction's five gradients against the JAX `_dcn_dispatch`
    backward (`j_dcn_grads`) on `dcn_case`, with a share of the offsets
    past the window radius (3) and a zero mask row; and the Function's
    backward bit-equal to autograd of the plain version."""
    want = train_pair[5]
    x, off, m, w, bias, g = dcn_case()
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, off, m, w, bias)]
    DeformConvFunction.apply(*ts).backward(torch.from_numpy(g))
    names = ("x", "offsets", "mask", "weights", "bias")
    for name, t, wnt in zip(names, ts, want):
        np.testing.assert_allclose(t.grad.numpy(), wnt, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    plain = [torch.from_numpy(a).requires_grad_()
             for a in (x, off, m, w, bias)]
    deform_conv2d_plain(*plain).backward(torch.from_numpy(g))
    for name, t, p in zip(names, ts, plain):
        assert torch.equal(t.grad, p.grad), name


def test_heatmap_gradients_flow():
    """gather_feat and sigmoid_clamped pass gradients as
    jnp.take_along_axis and jnp.clip do (zero where the clamp holds)."""
    from advancedliteratemachinery_tpu.ops import heatmap as jheat
    from advancedliteratemachinery_tpu_torch.ops import heatmap as theat

    rng = np.random.default_rng(2)
    fmap = rng.standard_normal((2, 4, 5, 3)).astype(np.float32) * 6
    inds = rng.integers(0, 20, (2, 6)).astype(np.int32)
    wts = rng.standard_normal((2, 6, 3)).astype(np.float32)

    def j_loss(f):
        return jnp.sum(jheat.gather_feat(jheat.sigmoid_clamped(f),
                                         jnp.asarray(inds)) * wts)

    want = fast_jit(jax.jit(jax.grad(j_loss)), jnp.asarray(fmap))(
        jnp.asarray(fmap))
    f = torch.from_numpy(fmap).requires_grad_()
    (theat.gather_feat(theat.sigmoid_clamped(f), torch.from_numpy(inds))
     * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert (f.grad == 0).any() and (f.grad != 0).any()


def test_encoder_mask_ignores_padded_cells():
    """Padded cells (mask 0) change no valid cell's logic, with or without
    the stacker (`test_train_forward_and_running_stats_match` holds the
    masked Processor against the JAX one on padded batches)."""
    tm = tlore.LORE(port_config(J_TINY_LORE), policy=FP32_POLICY,
                    device="cpu")
    variables = random_lore_tree(flax_zeros(tm), seed=9)
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((2, 6, 16)).astype(np.float32)
    boxes = rng.uniform(0, 15, (2, 6, 8)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]], np.float32)
    noisy = feat.copy()
    noisy[mask == 0] += 5.0
    keep = torch.from_numpy(mask > 0)
    t = torch.from_numpy
    with torch.no_grad():
        got = tm.processor(t(feat), t(boxes), t(mask))
        moved = tm.processor(t(noisy), t(boxes), t(mask))
        unmasked = tm.processor(t(noisy), t(boxes))
    assert set(got) == {"logic", "stacked_logic"}
    for k in got:
        assert torch.allclose(got[k][keep], moved[k][keep], atol=1e-6), k
        assert not torch.allclose(got[k][~keep], moved[k][~keep])
        assert not torch.allclose(got[k][keep], unmasked[k][keep])


@pytest.mark.parametrize("seed", [0, 1])
def test_lore_targets_bit_equal(seed):
    """lore_targets on seeded cells: on and off the map, thin and
    degenerate (zero-size, a point), overlapping, and more than
    max_cells."""
    rng = np.random.default_rng(seed)
    n = 12
    ct = rng.uniform(-20, 150, (n, 2))
    half = rng.uniform(0, 18, (n, 2))
    half[0] = 0.0                                      # a point
    half[1, 1] = 0.0                                   # a flat cell
    cells = np.stack([ct - half, ct + half * [1, -1], ct + half,
                      ct + half * [-1, 1]], 1).astype(np.float32)
    logic = rng.integers(0, 9, (n, 4)).astype(np.float32)
    for max_cells in (8, 16):
        want = jlore.lore_targets(cells, logic, (128, 128),
                                  max_cells=max_cells)
        got = tlore.lore_targets(cells, logic, (128, 128),
                                 max_cells=max_cells)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for hw in ((40, 52), (10, 12)):
        r = float(rng.uniform(1, 30))
        assert tlore.gaussian_radius(hw) == jlore.gaussian_radius(hw)
        assert tlore.gaussian_radius((r, 2 * r)) == jlore.gaussian_radius(
            (r, 2 * r))


TINY_CLI = dict(input_size=16, hidden_size=16, tsfm_layers=1,
                stacking_layers=1, num_heads=2, max_fmp_size=64, top_k=8,
                corner_k=8)


def test_train_command_saves_and_resumes(monkeypatch, tmp_path, table_json):
    """`train lore` on the CPU with a tiny LoreConfig (as the JAX
    `test_fit_*` tests patch theirs): 2 steps with a checkpoint after
    each, then the second removed and a resume from the first equal to
    it, BatchNorm running statistics and Adam moments included. A resumed
    run draws its batches from the seed again, as the JAX `fit` does; a
    one-page table makes every batch the same."""
    from advancedliteratemachinery_tpu_torch import cli

    folder, anno = table_json
    with open(anno) as f:
        one = json.load(f)
    one["images"] = one["images"][:1]
    one["annotations"] = [a for a in one["annotations"]
                          if a["image_id"] == 1]
    anno = str(tmp_path / "one.json")
    with open(anno, "w") as f:
        json.dump(one, f)
    tiny = port_config(J_TINY_LORE)
    monkeypatch.setattr(tlore, "LoreConfig", lambda: tiny)
    argv = ["train", "lore", "--train-data", anno, "--img-root", folder,
            "--image-size", "64", "--batch-size", "2", "--lr", "1e-3",
            "--log-interval", "1", "--save-interval", "1", "--device",
            "cpu"]

    def run(steps, ckpt, *extra):
        out = io.StringIO()
        monkeypatch.setattr(sys, "stdout", out)
        rc = cli.main(argv + ["--steps", str(steps), "--ckpt-dir", ckpt]
                      + list(extra))
        monkeypatch.setattr(sys, "stdout", sys.__stdout__)
        assert rc == 0
        return json.loads(out.getvalue().strip().splitlines()[-1])

    ckpt = str(tmp_path / "run")
    assert run(2, ckpt)["steps_run"] == 2
    assert latest_checkpoint_step(ckpt) == 2
    want = torch.load(f"{ckpt}/step_2/state.pt", weights_only=True)
    shutil.rmtree(f"{ckpt}/step_2")
    assert run(2, ckpt, "--resume")["steps_run"] == 1      # from step_1
    got = torch.load(f"{ckpt}/step_2/state.pt", weights_only=True)
    assert got["step"] == want["step"] == 2
    assert set(got["params"]) == set(want["params"])
    assert any(k.endswith("running_var") for k in got["params"])
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    for s, t in zip(got["opt_state"]["state"].values(),
                    want["opt_state"]["state"].values()):
        assert all(torch.equal(s[k], t[k]) for k in t)


def test_tree_projection_stats_match_jax(train_pair):
    """A DLA trunk with two-level Trees (DLA-34's levels 3 and 4) in train
    mode: flax runs each Tree's projection at every level and reads it
    only at a leaf, so the unread projections' BatchNorm running
    statistics move too. Outputs and every running statistic against the
    JAX DLA's mutable apply in float64."""
    from advancedliteratemachinery_tpu_torch.models.dla import Tree

    want, nv = train_pair[6]
    tm, variables, x = tree_case()
    assert any(isinstance(m, Tree) and m.levels == 2 and m.project
               for m in tm.modules())
    assert len(tm.unread_parameters()) == 3         # conv, bn scale, bias

    def forward(model, dtype):
        before = copy.deepcopy(model.state_dict())
        model.train()
        with torch.no_grad():
            out = model(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
        model.eval()
        stats = _bn_stats(model)
        model.load_state_dict(before)
        return [o.permute(0, 2, 3, 1) for o in out], stats

    got32, stats32 = forward(tm, torch.float32)
    with float64_port(tm) as m64:
        got64, stats64 = forward(m64, torch.float64)
    # float32 bounds as F32's, from this trunk's JAX float32 run: its last
    # level's statistics come from 2 values a channel (the port 5.1e-3 of
    # the level's scale from the truth, each running statistic 4.3e-4)
    f32 = float32_bounds(dict(maps=4.3e-2, stats=1.5e-3))
    for k, w in enumerate(want):
        near(got64[k], w, TOL64, f"level {k}")
        near(got32[k], w, f32["maps"], f"level {k}")
    sd = flax_state_dict(tm, variables["params"], nv["batch_stats"])
    for name, got in stats32.items():
        near(stats64[name], sd[name], TOL64, name)
        near(got, sd[name], f32["stats"], name)
    # the unread projection's statistics moved from the loaded values
    for leaf in ("running_mean", "running_var"):
        name = f"level3.project.bn.{leaf}"
        assert not torch.equal(stats32[name], tm.state_dict()[name])
