"""DB detector training in the port (models/db's threshold head and
binarization in train mode, `db_targets` with ops/contours' polylines and
distance transform, data/coco_spotting, engine/batches, engine/recipes,
engine/train_extras, the `train db` command) against the JAX package and
cv2 on the CPU, at `tests/test_fit_db.py`'s small config on 64x64 pages,
with the same numpy-seeded weights carried across by engine/convert. As in
`tests/test_torch_train_lore.py`, the JAX recipe runs in float64, the
port's float64 run is held to it at 1e-5 of each value's scale, and the
port's float32 run within twice the JAX package's own float32 distance
from it.

cv2 runs its distance transform through IPP by default, in float32 sums
whose order along a row is IPP's own; `cv2.ipp.setUseIPP(False)` gives
OpenCV's own 16.16 fixed-point code, which `ops/contours.py` reproduces.
The JAX `db_targets` is held bit-equal under that setting, and within
1e-5 of the IPP default.
"""

import io
import json
import shutil
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree
from PIL import Image

from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.data import coco_spotting as jcoco
from advancedliteratemachinery_tpu.engine import batches as JB
from advancedliteratemachinery_tpu.engine import train_extras as jextras
from advancedliteratemachinery_tpu.engine.train import (
    make_optimizer as j_make_optimizer)
from advancedliteratemachinery_tpu.models import db as jdb
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.data import coco_spotting as tcoco
from advancedliteratemachinery_tpu_torch.engine import batches as TB
from advancedliteratemachinery_tpu_torch.engine import train_extras as textras
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict, load_flax_params)
from advancedliteratemachinery_tpu_torch.engine.fit import (
    latest_checkpoint_step)
from advancedliteratemachinery_tpu_torch.engine.train import (
    TrainState, make_optimizer)
from advancedliteratemachinery_tpu_torch.models import db as tdb
from advancedliteratemachinery_tpu_torch.ops.contours import (
    distance_transform)
from test_torch_mgp_str import flax_zeros, random_flax_tree
from test_torch_train_lore import (
    _torch_batch, check_forward, check_steps, compiling, float32_bounds,
    jax_float64, port_runs, to_float64)

torch.set_num_threads(2)

HW = (64, 64)
SMALL = dict(width=8, fpn_dim=16, head_dim=8)      # tests/test_fit_db.py:66
OPT = dict(lr=1e-3, total_steps=10, grad_clip=0.5)
# The JAX package's own float32 run of this fixture against the float64
# truth, as `test_torch_train_lore.JAX_F32` (the port's readings in
# brackets): the train-mode maps (binary 1.2e-4, prob 9.3e-6, thresh 8.3e-6;
# the port 6.3e-5, 4.6e-6, 8.9e-6), the running statistics after one forward
# (9.1e-7), the first gradients (1.35e-2), the first loss (3.3e-4); after
# Adam updates, the later losses (2.35e-3), the running statistics (2.74e-2)
# and the share of weights beyond 0.05·lr·3 (0.37).
F32 = float32_bounds(dict(maps=1.2e-4, stats=1.44e-6, grads=1.35e-2,
                          loss=3.3e-4, later_loss=2.35e-3,
                          later_stats=2.73e-2, share=0.39))


@pytest.fixture
def no_ipp():
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(True)


def _bezier(rng, w, h):
    """A word's 16 Bezier numbers on a page of w x h: a top curve left to
    right, a bottom curve right to left, bent a little."""
    x0, y0 = rng.uniform(2, w * 0.6), rng.uniform(2, h * 0.8)
    ww, hh = rng.uniform(12, w * 0.4), rng.uniform(6, 16)
    bend = rng.uniform(-3, 3)
    top = [[x0 + ww * t, y0 + bend * (t in (1 / 3, 2 / 3))]
           for t in (0, 1 / 3, 2 / 3, 1)]
    bottom = [[x0 + ww * t, y0 + hh + bend * (t in (1 / 3, 2 / 3))]
              for t in (1, 2 / 3, 1 / 3, 0)]
    return np.asarray(top + bottom, np.float64).reshape(-1).tolist()


@pytest.fixture(scope="module")
def coco_json(tmp_path_factory):
    """Two 100x80 pages written as PNG by PIL and a third whose file is
    missing, with 1-4 Bezier words each."""
    tmp = tmp_path_factory.mktemp("spotting")
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(3):
        name = f"p{i}.png"
        if i < 2:
            Image.fromarray(rng.integers(0, 256, (80, 100, 3),
                                         dtype=np.uint8)).save(tmp / name)
        images.append({"id": i + 1, "file_name": name, "height": 80,
                       "width": 100})
        for k in range(int(rng.integers(1, 5))):
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "bezier_pts": _bezier(rng, 100, 80),
                         "rec": [1, 2] + [96] * 23,
                         "iscrowd": int(k == 3)})
    path = tmp / "anno.json"
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return str(tmp), str(path)


def db_forward(model, b, dtype):
    return model(b["images"].to(dtype) * (2.0 / 255.0) - 1.0)


@pytest.fixture(scope="module")
def train_pair(coco_json):
    """Three batches from both builders (cv2 without IPP); three JAX train
    steps of `db_recipe_u8` in float64 compiled once, giving each step's
    loss, its train-mode maps (captured from the recipe's `apply`), the
    running statistics it leaves and its gradients; the port model
    (float32) with the same weights; and the port's runs (`port_runs`),
    made while the JAX step compiles."""
    folder, anno = coco_json
    cv2.ipp.setUseIPP(False)
    try:
        jit = JB.db_batches(jcoco.CocoSpottingDataset(folder, anno), 2,
                            image_hw=HW, seed=1)
        jbatches = [next(jit) for _ in range(3)]
    finally:
        cv2.ipp.setUseIPP(True)
    tit = TB.db_batches(tcoco.CocoSpottingDataset(folder, anno), 2,
                        image_hw=HW, seed=1)
    tbatches = [next(tit) for _ in range(3)]
    tm = tdb.DBDetector(tdb.DBConfig(**SMALL), policy=FP32_POLICY,
                        device="cpu")
    variables = random_flax_tree(None, like=tm, seed=3)
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    with jax_float64() as policy:
        jm = jdb.DBDetector(jdb.DBConfig(**SMALL), policy=policy)
        captured = []
        apply = jm.apply

        def capturing_apply(*args, **kw):
            out = apply(*args, **kw)
            captured.append(out[0])
            return out

        object.__setattr__(jm, "apply", capturing_apply)
        loss_fn, _ = JB.db_recipe_u8(jm)
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
        flat, unravel = ravel_pytree(params)
        opt = tx.init(flat)
        with compiling(grads=jax.jit(grads).lower(params, bs, jbatches[0]),
                       update=jax.jit(update).lower(flat, opt, flat)
                       ) as compiled:
            port = port_runs(tm, tbatches, TB.db_recipe_u8, db_forward, OPT)
        trace = []
        for b in jbatches:
            (loss, (bs, out)), g = compiled["grads"](unravel(flat), bs, b)
            flat, opt = compiled["update"](ravel_pytree(g)[0], opt, flat)
            trace.append((float(loss), bs, g, out))
        out = to_float64((trace, unravel(flat), bs))
    return out, tm, jbatches, tbatches, port


def test_batches_match_jax(train_pair):
    """CocoSpottingDataset + db_batches on PIL-written PNGs (and a missing
    file, left zeros): the same pages and the same DB maps, bit for bit."""
    _, _, jbatches, tbatches, _ = train_pair
    assert any(b["gt_prob"].max() == 1.0 for b in jbatches)
    for jb, tb in zip(jbatches, tbatches):
        assert set(jb) == set(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_dataset_matches_jax(coco_json):
    folder, anno = coco_json
    jds = jcoco.CocoSpottingDataset(folder, anno)
    tds = tcoco.CocoSpottingDataset(folder, anno)
    assert len(jds) == len(tds) == 3
    for i in range(3):
        a, b = jds[i], tds[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=k)
    bp = jds[0]["bezier_pts"][0]
    np.testing.assert_array_equal(tcoco.bezier_polygon(bp, 5),
                                  jcoco.bezier_polygon(bp, 5))


def test_train_forward_and_running_stats_match(train_pair):
    """The train-mode forward (prob, thresh, binary) and the running
    statistics it leaves, against the JAX apply with train=True and
    mutable=["batch_stats"]; eval mode gives prob alone, as before."""
    (trace, _, _), tm, _, tbatches, port = train_pair
    _, stats, _, want = trace[0]
    assert set(want) == {"prob", "thresh", "binary"}
    check_forward(port, want,
                  flax_state_dict(tm, flax_zeros(tm)["params"], stats), F32)
    with torch.no_grad():
        x = _torch_batch(tbatches[0])["images"].float() / 255.0
        assert set(tm(x)) == {"prob"}


def test_three_steps_match_jax(train_pair):
    """db_recipe_u8 through TrainState: the first step's gradients, each
    step's loss, and the parameters and running statistics after three
    steps."""
    (trace, params, stats), tm, _, _, port = train_pair
    check_steps(port, trace, flax_state_dict(tm, trace[0][2], stats),
                flax_state_dict(tm, params, stats), F32, OPT["lr"])


def test_init_trees_map(train_pair):
    """The JAX DB's own init trees map onto the port's module: the one made
    under train=True (threshold head and every running statistic) and the
    inference one (no threshold head: those parameters keep the module's
    values)."""
    _, tm, _, _, _ = train_pair
    jm = jdb.DBDetector(jdb.DBConfig(**SMALL), policy=J_FP32)
    x = jnp.zeros((1, 64, 64, 3))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    for train in (True, False):
        tree = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                                train=train), x)
        tree = jax.tree_util.tree_map(lambda a: np.ones(a.shape, a.dtype),
                                      tree)
        assert ("thresh_c" in tree["params"]) == train
        sd = flax_state_dict(tm, tree["params"], tree["batch_stats"])
        for k, v in sd.items():
            if k.startswith("thresh_") and not train:
                assert torch.equal(v, before[k]), k
            elif not k.endswith("num_batches_tracked"):
                assert torch.equal(v, torch.ones_like(v)), k


def _polys(rng, H, W):
    polys = []
    for _ in range(int(rng.integers(1, 6))):
        n = int(rng.choice([3, 4, 8, 16]))
        c = rng.uniform(-10, [W + 10, H + 10])
        polys.append((c + rng.normal(0, 1, (n, 2))
                      * rng.uniform(1, 30, 2)).astype(np.float32))
    return polys


@pytest.mark.parametrize("seed", range(4))
def test_db_targets_bit_equal(seed, no_ipp):
    """db_targets on seeded polygons (some off the page), with degenerate
    ones among them (two points, three on a line, a sliver), bit-equal to
    the JAX function's through cv2."""
    rng = np.random.default_rng(seed)
    H, W = 72, 96
    polys = _polys(rng, H, W) + [
        np.array([[1, 1], [2, 2]], np.float32),
        np.array([[5, 5], [5, 6], [5, 7]], np.float32),
        np.array([[10, 10], [40, 10.5], [40, 11], [10, 10.6]], np.float32)]
    want = jdb.db_targets(polys, (H, W))
    got = tdb.db_targets(polys, (H, W))
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_db_targets_near_ipp():
    """The same maps within 1e-5 of the JAX function's under cv2's default
    (IPP) distance transform."""
    rng = np.random.default_rng(9)
    polys = _polys(rng, 72, 96)
    want = jdb.db_targets(polys, (72, 96))
    got = tdb.db_targets(polys, (72, 96))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 1), (1, 40), (37, 1), (23, 41),
                                   (64, 64)])
def test_distance_transform_bit_equal(shape, no_ipp):
    """cv2.distanceTransform(DIST_L2, 3) on seeded masks: sparse and dense
    zeros, an image without zeros (everything far), and a polygon's
    outline."""
    rng = np.random.default_rng(sum(shape))
    for p in (0.99, 0.6, 1.0):
        src = (rng.random(shape) < p).astype(np.uint8)
        np.testing.assert_array_equal(
            distance_transform(src), cv2.distanceTransform(src, cv2.DIST_L2,
                                                           3))


def test_accumulation_and_schedules_match_optax():
    """with_accumulation (optax MultiSteps: a running mean, one update
    every k steps, the inner count advancing on updates only) and the two
    schedules against optax, on a quadratic in six steps."""
    for lr, warm, total in ((1e-2, 3, 20), (5e-3, 0, 7)):
        for fn in ("warmup_linear", "warmup_cosine"):
            counts = np.arange(total + 3)
            want = jax.jit(jax.vmap(getattr(jextras, fn)(lr, warm, total)))(
                counts)
            got = getattr(textras, fn)(lr, warm, total)
            for n in counts:
                np.testing.assert_allclose(got(int(n)), float(want[n]),
                                           rtol=1e-6, atol=1e-9)
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((5,)).astype(np.float32)
    targets = rng.standard_normal((6, 5)).astype(np.float32)
    opt = dict(lr=0.1, total_steps=10, grad_clip=0.8)
    jtx = jextras.with_accumulation(j_make_optimizer(**opt), 3)

    @jax.jit
    def jstep(p, st, t):
        g = jax.grad(lambda w: jnp.sum((w - t) ** 2))(p)
        upd, st = jtx.update(g, st, p)
        return optax.apply_updates(p, upd), st

    p = jnp.asarray(w0)
    st = jtx.init(p)
    for t in targets:
        p, st = jstep(p, st, t)
    model = torch.nn.Linear(5, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0)[None])
    state = TrainState.create(model, textras.with_accumulation(
        make_optimizer(**opt), 3))
    for t in targets:
        state.optimizer.zero_grad(set_to_none=True)
        ((model.weight[0] - torch.from_numpy(t)) ** 2).sum().backward()
        state.apply_gradients()
    assert state.step == 6
    # torch's Adam and optax's order their float32 operations otherwise
    np.testing.assert_allclose(model.weight[0].detach().numpy(),
                               np.asarray(p), rtol=0, atol=1e-4 * opt["lr"])


def test_train_command_saves_and_resumes(monkeypatch, tmp_path, coco_json):
    """`train db` on the CPU with the small DBConfig (as the JAX
    `test_fit_*` tests patch theirs), with --grad-accum 2: 4 steps saved
    at 2 and 4, then step_4 removed and a resume from step_2 equal to it,
    BatchNorm running statistics, Adam moments and the accumulated
    gradients included. One page makes every batch the same, since a
    resumed run draws its batches from the seed again."""
    from advancedliteratemachinery_tpu_torch import cli

    folder, anno = coco_json
    with open(anno) as f:
        one = json.load(f)
    one["images"] = one["images"][:1]
    one["annotations"] = [a for a in one["annotations"]
                          if a["image_id"] == 1]
    anno = str(tmp_path / "one.json")
    with open(anno, "w") as f:
        json.dump(one, f)
    config = tdb.DBConfig(**SMALL)
    monkeypatch.setattr(tdb, "DBConfig", lambda: config)
    ckpt = str(tmp_path / "run")
    argv = ["train", "db", "--train-data", anno, "--img-root", folder,
            "--image-size", "64", "--batch-size", "2", "--lr", "1e-3",
            "--grad-accum", "2", "--steps", "4", "--log-interval", "1",
            "--save-interval", "2", "--device", "cpu", "--ckpt-dir", ckpt]

    def run(*extra):
        out = io.StringIO()
        monkeypatch.setattr(sys, "stdout", out)
        rc = cli.main(argv + list(extra))
        monkeypatch.setattr(sys, "stdout", sys.__stdout__)
        assert rc == 0
        return json.loads(out.getvalue().strip().splitlines()[-1])

    assert run()["steps_run"] == 4
    assert latest_checkpoint_step(ckpt) == 4
    want = torch.load(f"{ckpt}/step_4/state.pt", weights_only=True)
    shutil.rmtree(f"{ckpt}/step_4")
    assert run("--resume")["steps_run"] == 2
    got = torch.load(f"{ckpt}/step_4/state.pt", weights_only=True)
    assert got["step"] == want["step"] == 4
    assert any(k.endswith("running_var") for k in got["params"])
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert len(got["accum"]) == len(want["accum"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(got["accum"],
                                                 want["accum"]))
    with pytest.raises(SystemExit, match="queue 1"):
        cli.main(["train", "lister", "--train-data", anno, "--ckpt-dir",
                  ckpt, "--device", "cpu"])
