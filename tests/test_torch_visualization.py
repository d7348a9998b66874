"""The port's overlays (`utils/visualization.py`) against cv2 5.0 and the
JAX module, on the CPU:

- polylines equal `cv2.polylines(img, [pts], True, color, t)` bit for bit
  at thickness 1, 2 and 3 on seeded polygons: on the page, off it
  (negative and far coordinates), fractional points truncated as the
  JAX `_poly_pts` truncates them, and degenerate ones (all points equal,
  two points);
- labels equal `cv2.putText(..., FONT_HERSHEY_SIMPLEX, scale, color, t,
  LINE_AA)` at the two styles the overlays use on seeded backgrounds,
  strings and origins (partly off the page too): the stated bound on the
  share of differing pixels inside a label's box, LABEL_DIFF_SHARE, is 0,
  and no pixel outside the box changes; the committed glyph atlas is the
  one the installed cv2 renders (`render_atlas` rebuilds it: `python
  tests/test_torch_visualization.py` writes it);
- `draw_quads`, `draw_reading`, `draw_structurization` and `draw_table`
  against the JAX functions on the same seeded pages and results: equal
  outside the label boxes, and inside them within LABEL_DIFF_SHARE;
- `save_image` writes a PNG that decodes (PIL, and the port's own PNG
  decoder) to what the JAX `save_image` file decodes to; another
  extension raises a `ValueError` naming it."""

import io
import pathlib
import string

import cv2
import numpy as np
import pytest
from PIL import Image

import advancedliteratemachinery_tpu.utils.visualization as jvis
from advancedliteratemachinery_tpu_torch.pipelines import file_loading
from advancedliteratemachinery_tpu_torch.utils import visualization as tvis

FONT = cv2.FONT_HERSHEY_SIMPLEX
# the largest share of pixels inside a label's box that may differ from
# cv2's (measured: none on this corpus)
LABEL_DIFF_SHARE = 0.0
ATLAS_ORG, ATLAS_CANVAS = (40, 60), (100, 200)


def render_text(text, scale, th, org=ATLAS_ORG, canvas=ATLAS_CANVAS):
    img = np.zeros(canvas, np.uint8)
    cv2.putText(img, text, org, FONT, scale, 255, th, cv2.LINE_AA)
    return img


def glyph_advance(c, scale, th):
    """The pen's advance over character c at the style: where an 'H'
    after it starts, less where an 'H' alone starts."""
    def left_of_h(prefix):
        a = render_text(prefix + "H", scale, th, (20, 60), (100, 400))
        b = render_text(prefix, scale, th, (20, 60), (100, 400))
        return np.nonzero(a != b)[1].min()
    return left_of_h(chr(c)) - left_of_h("")


def render_atlas():
    """The glyph atlas from the installed cv2: for each label style and
    ASCII 32-127, the glyph's coverage (rendered alone in 255 on 0), its
    offset from the pen position and the baseline, and its advance."""
    out = {}
    for scale, th in tvis.LABEL_STYLES:
        key = f"s{int(round(scale * 10))}t{th}"
        index = np.zeros((96, 5), np.int32)
        chunks, at = [], 0
        for c in range(32, 128):
            full = render_text(chr(c), scale, th)
            ink = np.argwhere(full > 0)
            if not len(ink):
                index[c - 32] = (at, 0, 0, 0, 0)
                continue
            (y0, x0), (y1, x1) = ink.min(0), ink.max(0) + 1
            assert y0 > 0 and x0 > 0 and y1 < ATLAS_CANVAS[0] \
                and x1 < ATLAS_CANVAS[1]
            index[c - 32] = (at, y1 - y0, x1 - x0, x0 - ATLAS_ORG[0],
                             y0 - ATLAS_ORG[1])
            chunks.append(full[y0:y1, x0:x1].reshape(-1))
            at += chunks[-1].size
        out[f"{key}_alpha"] = np.concatenate(chunks).astype(np.uint8)
        out[f"{key}_index"] = index
        out[f"{key}_advance"] = np.asarray(
            [glyph_advance(c, scale, th) for c in range(32, 128)], np.int32)
    return out


def test_committed_atlas_is_the_installed_cv2s():
    want = render_atlas()
    with np.load(tvis.ATLAS) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def seeded_polys(rng, n, h, w):
    """Seeded polygons of 1-6 points: on the page, around it, far off it,
    fractional, and degenerate (one point repeated)."""
    out = []
    for i in range(n):
        k = int(rng.integers(1, 7))
        kind = i % 4
        if kind == 0:
            p = rng.uniform(0, min(h, w), (k, 2))
        elif kind == 1:
            p = rng.uniform(-25, max(h, w) + 25, (k, 2))
        elif kind == 2:
            p = np.repeat(rng.uniform(-5, max(h, w), (1, 2)), k, 0)
        else:
            p = rng.uniform(-1e4, 1e4, (k, 2))
        out.append(p.astype(np.float32))
    return out


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_polylines_equal_cv2(thickness):
    rng = np.random.default_rng(thickness)
    cases = 0
    for poly in seeded_polys(rng, 400, 48, 56):
        h, w = int(rng.integers(1, 48)), int(rng.integers(1, 56))
        pts = jvis._poly_pts(poly)
        np.testing.assert_array_equal(tvis._poly_pts(poly), pts)
        bg = rng.integers(0, 256, (h, w, 3), np.uint8)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = bg.copy()
        cv2.polylines(want, [pts], True, color, thickness)
        got = bg.copy()
        tvis.polylines(got, pts, color, thickness)
        np.testing.assert_array_equal(got, want, err_msg=str(
            (h, w, pts.reshape(-1).tolist())))
        cases += 1
    assert cases == 400


def in_box(shape, box):
    x0, y0, x1, y1 = box
    m = np.zeros(shape[:2], bool)
    m[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
    return m


@pytest.mark.parametrize("style", tvis.LABEL_STYLES)
def test_labels_equal_cv2_inside_their_boxes(style):
    scale, th = style
    rng = np.random.default_rng(int(scale * 10))
    chars = list(string.ascii_letters + string.digits + string.punctuation
                 + " \x7f")
    inside = differ = 0
    for i in range(150):
        h, w = 60, 240
        bg = (rng.integers(0, 256, (h, w, 3), np.uint8) if i % 2 else
              np.full((h, w, 3), int(rng.integers(0, 256)), np.uint8))
        text = "".join(rng.choice(chars, int(rng.integers(1, 30))))
        org = (int(rng.integers(-60, 260)), int(rng.integers(-5, 70)))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = bg.copy()
        cv2.putText(want, text, org, FONT, scale, color, th, cv2.LINE_AA)
        got = bg.copy()
        tvis.put_text(got, text, org, scale, color, th)
        box = in_box(bg.shape, tvis.label_box(text, org, scale, th))
        diff = (got != want).any(-1)
        assert not (diff & ~box).any() and not (
            (want != bg).any(-1) & ~box).any(), (text, org)
        inside += box.sum()
        differ += (diff & box).sum()
    assert differ <= LABEL_DIFF_SHARE * inside, differ / inside


def seeded_page(rng, h=120, w=160):
    page = rng.integers(0, 256, (h, w, 3), np.uint8)
    page[30:60, 20:100] = 255
    return page


def quad_at(x, y, w, h, tilt=0.0):
    return [x, y, x + w, y + tilt, x + w, y + h + tilt, x, y + h]


def label_boxes_of(page, labels):
    m = np.zeros(page.shape[:2], bool)
    for text, org, scale, th in labels:
        m |= in_box(page.shape, tvis.label_box(text, org, scale, th))
    return m


def assert_overlay_equal(got, want, page, labels):
    """Equal outside the label boxes; inside them within
    LABEL_DIFF_SHARE."""
    box = label_boxes_of(page, labels)
    diff = (got != want).any(-1)
    assert not (diff & ~box).any()
    assert (diff & box).sum() <= LABEL_DIFF_SHARE * max(box.sum(), 1)


def reading_result(rng):
    """A `read` result: quads on the page, across its edges, fractional,
    one degenerate; texts of ASCII, an empty one and one long."""
    quads = [quad_at(10.5, 12.25, 60, 14), quad_at(90, 3, 50, 10, 3.7),
             quad_at(-8, 40, 30, 12), quad_at(140, 100, 40, 30),
             [50, 80, 50, 80, 50, 80, 50, 80],
             list(rng.uniform(0, 150, 8))]
    texts = ["hello", "W0rld!", "", "edge", "x", "a long line of words"]
    return {"instances": [{"poly": q, "text": t, "confidence": 0.5}
                          for q, t in zip(quads, texts)]}


def test_draw_reading_and_quads_match_jax():
    rng = np.random.default_rng(0)
    page = seeded_page(rng)
    out = reading_result(rng)
    labels = []
    for inst in out["instances"]:
        pts = jvis._poly_pts(inst["poly"])
        if inst["text"]:
            x, y = int(pts[:, 0, 0].min()), int(pts[:, 0, 1].min())
            labels.append((inst["text"], (x, max(y - 4, 10)), 0.5, 1))
    got, want = tvis.draw_reading(page, out), jvis.draw_reading(page, out)
    assert got.dtype == np.uint8 and got.shape == page.shape
    assert_overlay_equal(got, want, page, labels)
    assert (got != page).any()
    quads = [i["poly"] for i in out["instances"]]
    for th in (1, 3):
        np.testing.assert_array_equal(
            tvis.draw_quads(page, quads, color=(9, 200, 30), thickness=th),
            jvis.draw_quads(page, quads, color=(9, 200, 30), thickness=th))


def test_draw_structurization_matches_jax():
    rng = np.random.default_rng(1)
    page = seeded_page(rng)
    regions = []
    for i, (q, name) in enumerate((
            (quad_at(5, 5, 100, 40), "title"),
            (quad_at(20, 50, 120, 60, 2.5), "plain text"),
            (quad_at(-10, 100, 60, 40), None),
            (quad_at(130, 2, 40, 20), "equation"))):
        region = {"category_index": i * 3, "region_poly": q,
                  "text_list": [{"poly": quad_at(q[0] + 3, q[1] + 4, 30, 8),
                                 "content": "t"}]}
        if name is not None:
            region["category_name"] = name
        regions.append(region)
    labels = []
    for r in regions:
        pts = jvis._poly_pts(r["region_poly"])
        x, y = int(pts[:, 0, 0].min()), int(pts[:, 0, 1].min())
        labels.append((str(r.get("category_name", r["category_index"])),
                       (x, max(y - 6, 12)), 0.6, 2))
    got = tvis.draw_structurization(page, regions)
    assert_overlay_equal(got, jvis.draw_structurization(page, regions),
                         page, labels)


def test_draw_table_matches_jax():
    rng = np.random.default_rng(2)
    page = seeded_page(rng)
    cells = [{"cell_poly": quad_at(10 + 30 * c, 10 + 20 * r, 28, 18)}
             for r in range(4) for c in range(5)]
    cells += [{"cell_poly": [-1, -1, 5, 5, 5, 5, -1, 5]},       # dummy
              {"poly": quad_at(150, 100, 40, 40)}, {"texts": []}]
    out = {"cells": cells}
    np.testing.assert_array_equal(tvis.draw_table(page, out),
                                  jvis.draw_table(page, out))


def test_save_image_decodes_like_the_jax_file(tmp_path):
    page = seeded_page(np.random.default_rng(3))
    tvis.save_image(page, str(tmp_path / "t.png"))
    jvis.save_image(page, str(tmp_path / "j.png"))
    with Image.open(tmp_path / "t.png") as t, \
            Image.open(tmp_path / "j.png") as j:
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    np.testing.assert_array_equal(
        file_loading.load_image(str(tmp_path / "t.png")), page)
    for name in ("o.jpg", "o.bmp", "o"):
        with pytest.raises(ValueError, match="PNG only"):
            tvis.save_image(page, str(tmp_path / name))


if __name__ == "__main__":          # writes the glyph atlas
    buf = io.BytesIO()
    np.savez_compressed(buf, **render_atlas())
    pathlib.Path(tvis.ATLAS).write_bytes(buf.getvalue())
