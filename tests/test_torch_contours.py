"""The host box extraction without cv2 (`ops/contours.py`, `models/db.py`
`extract_boxes` and `make_db_detect_fn`) against cv2 5.0 and the JAX
package:

- `find_contours`, `min_area_rect`, `box_points` and `fill_poly_window`
  against the cv2 calls they replace, point for point and in cv2's order
  (holes, one-pixel runs and single pixels among the contours);
- `extract_boxes` against the JAX `models/db.py` `extract_boxes` on
  seeded maps holding holes, one-pixel lines, rotated bars, touching
  blobs, tied scores and boxes at the page edge: the same count, quads
  within QUAD_TOL px in the same vertex and list order, scores within
  SCORE_TOL (they come out equal bit for bit);
- the detect function against the JAX CLI's (`cli._db_detect_fn`: the JAX
  DB, `cv2.resize`, the JAX `extract_boxes`) on one 640² page, with the
  same weights carried across by `engine/convert.py`: the same boxes."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.models.db import (
    DBConfig as JDBConfig, DBDetector as JDBDetector,
    extract_boxes as j_extract_boxes)
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.convert import (
    _flatten, _param_leaf, load_flax_params)
from advancedliteratemachinery_tpu_torch.models.db import (
    DBConfig, DBDetector, extract_boxes, make_db_detect_fn)
from advancedliteratemachinery_tpu_torch.ops import contours as C
from test_torch_mgp_str import random_flax_tree

torch.set_num_threads(2)

QUAD_TOL = 1e-3          # px
SCORE_TOL = 1e-5


def seeded_binaries(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = rng.integers(1, 40, 2)
        img = (rng.random((h, w)) < rng.uniform(0.2, 0.8)).astype(np.uint8)
        yield img


def test_find_contours_matches_cv2():
    holes = np.zeros((40, 50), np.uint8)
    holes[5:35, 5:45] = 1
    holes[10:24, 15:35] = 0                   # a 20x14 hole
    holes[28:31, 30:33] = 0                   # and a small one
    holes[2, 10:20] = 1                       # a one-pixel run
    holes[38, 47] = 1                         # a single pixel
    for img in [holes, *seeded_binaries(120, 0)]:
        want, _ = cv2.findContours(img.copy(), cv2.RETR_LIST,
                                   cv2.CHAIN_APPROX_SIMPLE)
        got = C.find_contours(img)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = C.find_contours(holes)
    # a single pixel, the run, the outer border and the two holes
    assert sorted(len(c) for c in got) == [1, 2, 4, 8, 8]


def test_min_area_rect_and_box_points_match_cv2():
    """Bit for bit on every contour of the seeded images (the rectangles
    at exactly -45°, whose calipers tie, among them), and on a point, a
    segment and an axis-aligned rectangle."""
    n45 = 0
    for img in seeded_binaries(80, 1):
        for c in C.find_contours(img):
            want, got = cv2.minAreaRect(c), C.min_area_rect(c)
            assert (tuple(want[0]), tuple(want[1]), want[2]) == got
            n45 += want[2] == -45.0
            box = C.box_points(got)
            assert box.dtype == np.float32
            np.testing.assert_array_equal(box, cv2.boxPoints(want))
    assert n45 >= 20
    for pts in ([[3, 4]], [[14, 6], [21, 6]], [[0, 0], [10, 0], [10, 5],
                                                [0, 5]]):
        c = np.asarray(pts, np.int32).reshape(-1, 1, 2)
        want = cv2.minAreaRect(c)
        assert (tuple(want[0]), tuple(want[1]), want[2]) == \
            C.min_area_rect(c)


def edge_bars(rng, H, W, n):
    """A binary page of `n` rotated bars, most of them centred on or past
    the page's edges."""
    yy, xx = np.mgrid[:H, :W]
    m = np.zeros((H, W), np.uint8)
    for _ in range(n):
        cx = rng.choice([rng.uniform(-5, 5), rng.uniform(W - 5, W + 5),
                         rng.uniform(0, W)])
        cy = rng.choice([rng.uniform(-5, 5), rng.uniform(H - 5, H + 5),
                         rng.uniform(0, H)])
        L, T, ang = rng.uniform(6, 50), rng.uniform(2, 12), rng.uniform(0,
                                                                       np.pi)
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        m[(np.abs(u) < L / 2) & (np.abs(v) < T / 2)] = 1
    return m


def test_fill_poly_matches_cv2():
    """The truncated min-area boxes of components that touch the page's
    edges (many reach past them, as extraction's boxes do) and arbitrary
    quads inside the page. (cv2 5.0 also draws some rows of a polygon
    that lie wholly off the page on the border column, which this does
    not; no box of a component on the page has such rows.)"""
    rng = np.random.default_rng(2)
    outside = 0
    for t in range(40):
        H, W = (int(v) for v in rng.integers(20, 80, 2))
        quads = [cv2.boxPoints(cv2.minAreaRect(c)).astype(np.int32)
                 for c in C.find_contours(edge_bars(rng, H, W, 6))
                 if len(c) >= 4]
        quads += [rng.integers(0, [W, H], (4, 2)) for _ in range(4)]
        for pts in quads:
            outside += bool((pts < 0).any() or (pts[:, 0] >= W).any()
                            or (pts[:, 1] >= H).any())
            want = np.zeros((H, W), np.uint8)
            cv2.fillPoly(want, [pts.astype(np.int32)], 1)
            np.testing.assert_array_equal(
                C.fill_poly_window(pts, (H, W), (0, H, 0, W)), want)
            box = pts.astype(np.float32) + 0.25
            assert C.contour_area(box) == cv2.contourArea(box)
            assert C.arc_length(box) == cv2.arcLength(box, True)
    assert outside >= 40


def seeded_prob_map(seed, H=160, W=200, n=25):
    """Low noise under `n` rotated bars of random probability (every
    fourth with a hole), a one-pixel line, blocks at the corners and
    edges, two touching blobs and four blocks of one dyadic value, whose
    scores tie exactly."""
    rng = np.random.default_rng(seed)
    m = (rng.random((H, W)) * 0.2).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    for i in range(n):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        L, T = rng.uniform(4, 40), rng.uniform(1, 8)
        ang = rng.uniform(0, np.pi)
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        bar = (np.abs(u) < L / 2) & (np.abs(v) < T / 2)
        m[bar] = np.maximum(m[bar], np.float32(rng.uniform(0.35, 1.0)))
        if i % 4 == 3:
            m[(np.abs(u) < L / 4) & (np.abs(v) < T / 4)] = 0.05
    m[5, 10:60] = 0.9                                   # one-pixel line
    m[0:12, 0:30] = 0.8                                 # page corner
    m[H - 8:H, W - 40:W] = 0.7                          # bottom edge
    m[60:70, 0:20] = m[60:70, 20:45] = 0.95             # touching blobs
    m[64:66, 20] = 0.1
    m[136:150, 56:174] = 0.1                            # exact ties on
    for x in (60, 90, 120, 150):                        # a clear band
        m[140:146, x:x + 20] = 0.75
    return m


@pytest.mark.parametrize("seed", range(8))
def test_extract_boxes_matches_jax(seed):
    m = seeded_prob_map(seed)
    counts = []
    for box_thresh in (0.3, 0.6):
        want_q, want_s = j_extract_boxes(m, box_thresh=box_thresh)
        got_q, got_s = extract_boxes(m, box_thresh=box_thresh)
        assert got_q.shape == want_q.shape and got_s.shape == want_s.shape
        assert got_q.dtype == np.float32 and got_s.dtype == np.float32
        assert np.abs(got_q - want_q).max(initial=0) <= QUAD_TOL
        assert np.abs(got_s - want_s).max(initial=0) <= SCORE_TOL
        counts.append((len(want_s), int((want_s == np.float32(0.75)).sum())))
    assert counts[0][0] >= 10 and min(c[1] for c in counts) >= 2


def flax_from_torch(model, shapes):
    """The flax tree (`params`, `batch_stats`) of a port module's state:
    `engine/convert.py`'s leaf mapping run backwards."""
    sd = model.state_dict()

    def back(collection):
        out = {}
        for name, leaf in _flatten(shapes[collection]).items():
            if collection == "params":
                key, _ = _param_leaf(name, np.zeros(leaf.shape, np.float32))
                t = sd[key]
                t = (t.permute(2, 3, 1, 0) if t.ndim == 4 else
                     t.t() if t.ndim == 2 else t)
            else:
                path, stat = name.rsplit(".", 1)
                t = sd[f"{path}.running_{stat}"]
            node = out
            *parents, last = name.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = jnp.asarray(t.numpy())
        return out

    return {"params": back("params"), "batch_stats": back("batch_stats")}


def test_detect_fn_matches_the_jax_cli():
    """`make_db_detect_fn` against the JAX CLI's detect function on one
    640² page, both in f32 with the smoke's readable weights (a small
    DBConfig): the same boxes in the same order."""
    cfg = dict(width=8, fpn_dim=16, head_dim=8)
    page = cs.document_pages(1, (640, 640), seed=5)[0]
    jm = JDBDetector(JDBConfig(**cfg), policy=J_FP32)
    tm = DBDetector(DBConfig(**cfg), policy=FP32_POLICY, device="cpu")
    variables = random_flax_tree(jm, like=tm)
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    cs.readable_db(tm)
    variables = flax_from_torch(tm, variables)

    # the JAX CLI's detect function (advancedliteratemachinery_tpu/cli.py
    # `_db_detect_fn`) on these weights
    fn = jax.jit(lambda v, x: jm.apply(v, x)["prob"])
    x = cv2.resize(page, (640, 640)).astype(np.float32) / 255.0
    prob = np.asarray(fn(variables, jnp.asarray(x[None])))[0, :, :, 0]
    want_q, want_s = j_extract_boxes(prob, box_thresh=0.3)
    got_q, got_s = make_db_detect_fn(tm, box_thresh=0.3)(page)
    assert 20 <= len(want_q) and got_q.shape == want_q.shape
    assert np.abs(got_q - want_q).max() <= QUAD_TOL
    assert np.abs(got_s - want_s).max() <= SCORE_TOL
