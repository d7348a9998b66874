"""Device box extraction and crop front end (ops/cc_extract.py,
ops/image.py) against the JAX package's device path on synthetic prob maps:
axis-aligned rectangles, a rotated bar, diagonal-touching blobs, and a page
with more components than `max_boxes` (the overflow regime, where the
smallest flat indices are dropped)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu.ops.cc_extract import (
    _seg_run_max_scan as j_scan, connected_components as j_cc,
    extract_boxes_device as j_extract)
from advancedliteratemachinery_tpu.ops.image import (
    crop_rects as j_crop, normalize_crops as j_normalize)
from advancedliteratemachinery_tpu_torch.ops.cc_extract import (
    _seg_run_max_scan, connected_components, extract_boxes_device)
from advancedliteratemachinery_tpu_torch.ops.image import (
    crop_rects, normalize_crops)

torch.set_num_threads(2)

H, W = 64, 96


def _pages():
    rng = np.random.default_rng(0)
    prob = rng.uniform(0.0, 0.1, (3, H, W)).astype(np.float32)
    # page 0: axis-aligned rectangles of distinct sizes, one dimmer (scores
    # below box_thresh), plus a rotated bar
    prob[0, 4:12, 5:40] = 0.9
    prob[0, 20:26, 50:90] = 0.8
    prob[0, 40:44, 8:20] = 0.5
    for t in range(24):
        prob[0, 50 - t // 2: 56 - t // 2, 40 + t] = 0.95
    # page 1: blobs touching only at a diagonal merge into one component
    prob[1, 10:20, 10:20] = 0.9
    prob[1, 20:30, 20:30] = 0.9
    prob[1, 40:50, 60:80] = 0.85
    # page 2: 40 components, more than max_boxes, with well separated
    # scores so that the order does not hang on f32 summation order
    for i in range(5):
        for j in range(8):
            prob[2, 4 + 12 * i: 10 + 12 * i, 4 + 11 * j: 12 + 11 * j] = \
                0.62 + 0.007 * (8 * i + j)
    return prob


def test_connected_components_match():
    mask = _pages() > 0.3
    got = connected_components(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_cc(jnp.asarray(mask))))
    assert len(np.unique(got[1])) == 3          # background + 2 components


@pytest.mark.parametrize("dim", [1, 2])
def test_scan_fallback_matches(dim):
    """The tuple-scan path (maps past ~720²) on a small map, both ways."""
    mask = _pages()[0] > 0.3
    lab = np.where(mask, np.arange(H * W).reshape(H, W), -1).astype(np.int32)
    got = _seg_run_max_scan(torch.from_numpy(lab), torch.from_numpy(mask),
                            dim - 2).numpy()
    want = np.asarray(jax.jit(j_scan, static_argnums=2)(
        jnp.asarray(lab), jnp.asarray(mask), dim - 2))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_boxes", [16, 64])
def test_extract_boxes_match(max_boxes):
    prob = _pages()
    q, s, v = extract_boxes_device(torch.from_numpy(prob),
                                   max_boxes=max_boxes)
    jq, js, jv = j_extract(jnp.asarray(prob), max_boxes=max_boxes)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # f32 trigonometry and sums in another order: corners to 1e-3 px
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    n_valid = v.numpy().sum(1)
    # page 1: the diagonal pair is one component whose filled rect is half
    # background, so it scores under box_thresh; the third blob stays
    assert n_valid[0] == 3 and n_valid[1] == 1
    # overflow: the components with the largest flat indices (the last
    # rows of squares, which also score highest) fill the max_boxes slots
    assert n_valid[2] == min(max_boxes, 40)
    want_scores = 0.62 + 0.007 * np.arange(39, 39 - n_valid[2], -1)
    np.testing.assert_allclose(s.numpy()[2, :n_valid[2]], want_scores,
                               atol=2e-3)


def test_extract_boxes_uncapped_keeps_every_component():
    """`max_boxes=None` (the document pipelines' detect function): a page
    of 150 components, more than two 64-slot batches, gives a box for each,
    the top rows too, and the slots of an explicit K of the same size."""
    prob = np.full((2, 72, 112), 0.05, np.float32)
    for i in range(10):
        for j in range(15):
            prob[0, 2 + 7 * i:6 + 7 * i, 2 + 7 * j:6 + 7 * j] = \
                0.7 + 0.001 * (15 * i + j)
    prob[1, 10:20, 10:40] = 0.9
    q, s, v = extract_boxes_device(torch.from_numpy(prob), max_boxes=None)
    assert q.shape[1] == 192 and v.numpy().sum(1).tolist() == [150, 1]
    tops = np.sort(q.numpy()[0][v.numpy()[0]][:, :, 1].min(1))
    assert tops[0] < 2.0                 # the first row of squares is in
    for got, want in zip((q, s, v), extract_boxes_device(
            torch.from_numpy(prob), max_boxes=192)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_crop_rects_and_normalize_match():
    rng = np.random.default_rng(1)
    pages = rng.integers(0, 256, (2, 80, 300, 3), dtype=np.uint8)
    quads = np.zeros((2, 4, 4, 2), np.float32)
    boxes = [[(3.2, 5.5, 60.7, 25.1), (250.0, 60.0, 299.0, 79.0),
              (10.0, 10.0, 290.0, 70.0),        # larger than the patch
              (0.0, 0.0, 4.0, 3.0)],
             [(100.5, 40.2, 180.9, 62.0), (1.0, 1.0, 30.0, 12.0),
              (5.0, 50.0, 70.0, 78.5), (200.0, 2.0, 296.0, 40.0)]]
    for p, page in enumerate(boxes):
        for k, (x0, y0, x1, y1) in enumerate(page):
            quads[p, k] = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    got = crop_rects(torch.from_numpy(pages), torch.from_numpy(quads),
                     dtype=torch.float32).numpy()
    want = np.asarray(j_crop(jnp.asarray(pages), jnp.asarray(quads),
                             dtype=jnp.float32))
    assert got.shape == (2, 4, 32, 128, 3)
    # f32 resampling sums of pixel values up to 255 in another order: a few
    # ulps of 255 (1.5e-5 each), times 2/255
    np.testing.assert_allclose(got, want, atol=1e-4)

    got = normalize_crops(torch.from_numpy(pages[:, :32, :128]),
                          torch.float32).numpy()
    want = np.asarray(j_normalize(jnp.asarray(pages[:, :32, :128]),
                                  jnp.float32))
    np.testing.assert_array_equal(got, want)
