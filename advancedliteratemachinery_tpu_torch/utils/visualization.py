"""Overlays of the pipelines' results on their pages (port of
`advancedliteratemachinery_tpu/utils/visualization.py`; reference
Applications/DocXChain/utilities/visualization.py), drawn on the host in
NumPy on RGB uint8 arrays, without cv2 or PIL.

- Polylines equal cv2 5.0's `cv2.polylines(img, [pts], True, color,
  thickness)` (`LINE_8`) bit for bit: thickness 1 is the clipped
  8-connected line iterator (`drawing.cpp` `Line`); a thicker line is
  `ThickLine`'s convex quad a segment, filled in `XY_SHIFT` fixed point
  (`FillConvexPoly`, its outline drawn by `Line2`), with a filled
  `Circle` cap at each segment's end. One colour overwrites, so a
  polyline is the union of those pixel sets.
- Labels: cv2's `putText` `FONT_HERSHEY_SIMPLEX` with `LINE_AA`, at the
  JAX module's origins (the baseline, y clamped) and scales. cv2 5.0 sets
  each glyph at a whole-pixel pen position, advances the pen by the
  glyph's width at that style, and blends the glyph's coverage into the
  image. So each glyph comes from an atlas rendered once with the
  installed cv2 (`hershey_atlas.npz`: coverage, offset and advance of
  ASCII 32-127 at scale 0.5 thickness 1 and scale 0.6 thickness 2),
  blended as (pixel·(255 - a) + colour·a + 127) // 255. On the tests'
  corpus that equals cv2 5.0 bit for bit; every pixel a label may change
  lies in its `label_box`. Other characters are drawn as '?' (cv2 5.0
  has glyphs of its own for many of them, so such a label differs from
  cv2's inside and around its box).
- The colours are the JAX module's tuples, applied to the RGB array
  channel for channel as that module applies them.
- `save_image` writes PNG with `zlib` (cv2 writes the BGR-flipped array,
  so the file decodes to the same RGB).
"""

from __future__ import annotations

import functools
import math
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# BGR-ish palette matching the reference's color choices; cycled per
# layout category
_QUAD_COLOR = (49, 125, 237)
_CELL_COLOR = (0, 225, 0)
_PALETTE = [
    (237, 125, 49), (49, 125, 237), (0, 180, 0), (200, 0, 200),
    (0, 180, 180), (180, 180, 0), (120, 60, 200), (60, 200, 120),
]

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
ATLAS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "hershey_atlas.npz")
# the label styles the overlays use: (scale, thickness)
LABEL_STYLES = ((0.5, 1), (0.6, 2))


def _poly_pts(poly) -> np.ndarray:
    p = np.asarray(poly, np.float32).reshape(-1, 2)
    return p.astype(np.int32).reshape(-1, 1, 2)


# ---------------- cv2 drawing.cpp, LINE_8 ----------------


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """`clipLine` on an image of w × h (any fixed-point scale) → the
    clipped end points, or None when the line misses the image."""
    if w <= 0 or h <= 0:
        return None
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _line(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """`Line` (8-connected `LineIterator`, left to right) into a bool
    mask [H, W]."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1)
    m = (2 * minor * k + major - 1) // (2 * major) if major else k
    if dy > dx:
        mask[y1 + sy * k, x1 + m] = True
    else:
        mask[y1 + sy * m, x1 + k] = True


def _line2(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """`Line2`: a line between XY_SHIFT fixed-point end points."""
    h, w = mask.shape
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    half = XY_ONE >> 1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        step = _cdiv(dy << XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> XY_SHIFT
        xs = ((x1 + half) >> XY_SHIFT) + np.arange(count + 1)
        ys = (y1 + half + step * np.arange(count + 1)) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        step = _cdiv(dx << XY_SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> XY_SHIFT
        ys = ((y1 + half) >> XY_SHIFT) + np.arange(count + 1)
        xs = (x1 + half + step * np.arange(count + 1)) >> XY_SHIFT
    xs = np.append(xs, (x2 + half) >> XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    mask[ys[keep], xs[keep]] = True


def _cdiv(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _fill_convex(mask: np.ndarray, pts: Sequence[Tuple[int, int]]) -> None:
    """`FillConvexPoly` with `LINE_8` on XY_SHIFT fixed-point vertices."""
    h, w = mask.shape
    n = len(pts)
    shift, delta = XY_SHIFT, XY_ONE >> 1
    p0 = pts[-1]
    for p in pts:
        _line2(mask, p0[0], p0[1], p[0], p[1])
        p0 = p
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    imin = int(np.argmin(ys))
    xmin, xmax = (min(xs) + delta) >> shift, (max(xs) + delta) >> shift
    ymin, ymax = (min(ys) + delta) >> shift, (max(ys) + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    # per edge: [index, direction, x, dx, y end]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0 = e[0]
                idx = (idx0 + e[1]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (pts[idx][1] + delta) >> shift
                    if ty > y:
                        xs_, xe = pts[idx0][0], pts[idx][0]
                        e[4] = ty
                        e[3] = _cdiv((xe - xs_) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs_
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + e[1]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted((edge[0][2], edge[1][2]))
            x1 = (left + delta) >> shift
            x2 = (right + delta) >> shift
            if x2 >= 0 and x1 < w:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = True
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _disc(mask: np.ndarray, cx: int, cy: int, r: int) -> None:
    """`Circle` filled: the spans of its midpoint loop, clipped."""
    h, w = mask.shape
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx),
                          (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy),
                          (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and x2 >= 0 and x1 < w:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = True
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _thick_line(mask: np.ndarray, p0, p1, thickness: int) -> None:
    """`ThickLine` with `LINE_8` from integer end points, thickness > 1:
    cv2 5.0 first clips the segment to the image grown by `thickness` on
    every side, then fills its quad and draws the end cap (a closed
    polyline draws no start cap)."""
    h, w = mask.shape
    g = thickness
    clipped = _clip_line(w + 2 * g, h + 2 * g, p0[0] + g, p0[1] + g,
                         p1[0] + g, p1[1] + g)
    if clipped is None:
        return
    x0, y0, x1, y1 = ((v - g) << XY_SHIFT for v in clipped)
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        ex, ey = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(mask, [(x0 + ex, y0 + ey), (x0 - ex, y0 - ey),
                            (x1 - ex, y1 - ey), (x1 + ex, y1 + ey)])
    _disc(mask, (x1 + (XY_ONE >> 1)) >> XY_SHIFT,
          (y1 + (XY_ONE >> 1)) >> XY_SHIFT, (half + (XY_ONE >> 1)) >> XY_SHIFT)


def polyline_mask(shape: Tuple[int, int], pts,
                  thickness: int) -> np.ndarray:
    """The pixels cv2's closed `polylines` with `LINE_8` paints on an
    image of `shape` (H, W) for int32 points [N, 1, 2] → bool [H, W]."""
    mask = np.zeros(shape, bool)
    pts = np.asarray(pts, np.int64).reshape(-1, 2).tolist()
    if not pts:
        return mask
    p0 = pts[-1]
    for p in pts:
        if thickness <= 1:
            _line(mask, p0[0], p0[1], p[0], p[1])
        else:
            _thick_line(mask, p0, p, thickness)
        p0 = p
    return mask


def polylines(image: np.ndarray, pts, color, thickness: int) -> None:
    """`cv2.polylines(image, [pts], True, color, thickness)` in place."""
    mask = polyline_mask(image.shape[:2], pts, thickness)
    image[mask] = np.asarray(color, np.uint8)[:image.shape[-1]]


# ---------------- cv2 putText (FONT_HERSHEY_SIMPLEX, LINE_AA) ----------


@functools.lru_cache(maxsize=1)
def _atlas() -> Dict[str, np.ndarray]:
    with np.load(ATLAS) as f:
        return {k: f[k] for k in f.files}


def _style(scale: float, thickness: int) -> str:
    if (scale, thickness) not in LABEL_STYLES:
        raise ValueError(f"no glyph atlas for scale {scale} thickness "
                         f"{thickness}; the atlas holds {LABEL_STYLES}")
    return f"s{int(round(scale * 10))}t{thickness}"


def _glyphs(text: str, org: Tuple[int, int], scale: float, thickness: int):
    """(glyph index into the style's table, x, y of its crop's top left)
    for each character: cv2 5.0 sets glyphs at whole-pixel pen
    positions, each advancing the pen by its width at the style."""
    a = _atlas()
    key = _style(scale, thickness)
    table, advance = a[f"{key}_index"], a[f"{key}_advance"]
    codes = [c if 32 <= c <= 127 else ord("?")
             for c in str(text).encode("ascii", "replace")]
    pen, out = org[0], []
    for c in codes:
        row = table[c - 32]
        out.append((c - 32, pen + int(row[3]), org[1] + int(row[4])))
        pen += int(advance[c - 32])
    return out


def label_box(text: str, org: Tuple[int, int], scale: float,
              thickness: int) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1), exclusive, around every pixel the label may
    change: the union of its glyphs' atlas crops (which include the
    parts below the baseline)."""
    table = _atlas()[f"{_style(scale, thickness)}_index"]
    boxes = [(x, y, x + int(table[g][2]), y + int(table[g][1]))
             for g, x, y in _glyphs(text, org, scale, thickness)]
    if not boxes:
        return (org[0], org[1], org[0], org[1])
    b = np.asarray(boxes)
    return (int(b[:, 0].min()), int(b[:, 1].min()), int(b[:, 2].max()),
            int(b[:, 3].max()))


def put_text(image: np.ndarray, text: str, org: Tuple[int, int],
             scale: float, color, thickness: int) -> None:
    """`cv2.putText(image, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness, LINE_AA)` in place, from the glyph atlas: each glyph's
    coverage blends the colour in, glyph after glyph."""
    a = _atlas()
    key = _style(scale, thickness)
    table, alpha = a[f"{key}_index"], a[f"{key}_alpha"]
    col = np.asarray(color, np.int32)[:image.shape[-1]]
    H, W = image.shape[:2]
    for g, x, y in _glyphs(text, org, scale, thickness):
        at, h, w = (int(v) for v in table[g][:3])
        cov = alpha[at:at + h * w].reshape(h, w).astype(np.int32)
        y0, x0 = max(y, 0), max(x, 0)
        y1, x1 = min(y + h, H), min(x + w, W)
        if y1 <= y0 or x1 <= x0:
            continue
        v = cov[y0 - y:y1 - y, x0 - x:x1 - x, None]
        px = image[y0:y1, x0:x1].astype(np.int32)
        image[y0:y1, x0:x1] = ((px * (255 - v) + col * v + 127)
                               // 255).astype(np.uint8)


# ---------------- the overlays ----------------


def draw_quads(image: np.ndarray, quads: Sequence,
               texts: Optional[Sequence[str]] = None,
               color=_QUAD_COLOR, thickness: int = 2) -> np.ndarray:
    """Reference general_text_reading_visualization: closed polylines per
    quad, optional recognized text above the top-left corner."""
    out = np.ascontiguousarray(np.asarray(image).copy())
    for i, q in enumerate(quads):
        pts = _poly_pts(q)
        polylines(out, pts, color, thickness)
        if texts is not None and i < len(texts) and texts[i]:
            x, y = int(pts[:, 0, 0].min()), int(pts[:, 0, 1].min())
            put_text(out, str(texts[i]), (x, max(y - 4, 10)), 0.5, color, 1)
    return out


def draw_reading(image: np.ndarray, reading_result: Dict) -> np.ndarray:
    """`read` CLI / GeneralTextReading output ({"instances": [{"poly",
    "text", ...}]}) → overlay."""
    inst = reading_result.get("instances", [])
    return draw_quads(image, [i["poly"] for i in inst],
                      [i.get("text", "") for i in inst])


def draw_structurization(image: np.ndarray,
                         regions: List[Dict]) -> np.ndarray:
    """DocumentStructurization output → layout regions (thick, per-category
    color + label) with their text lines (thin)."""
    out = np.ascontiguousarray(np.asarray(image).copy())
    for region in regions:
        cat = int(region.get("category_index", 0))
        color = _PALETTE[cat % len(_PALETTE)]
        pts = _poly_pts(region["region_poly"])
        polylines(out, pts, color, 3)
        label = str(region.get("category_name", cat))
        x, y = int(pts[:, 0, 0].min()), int(pts[:, 0, 1].min())
        put_text(out, label, (x, max(y - 6, 12)), 0.6, color, 2)
        for line in region.get("text_list", []):
            polylines(out, _poly_pts(line["poly"]), color, 1)
    return out


def draw_table(image: np.ndarray, table_result: Dict) -> np.ndarray:
    """TableParsing output ({"cells": [{"cell_poly", "texts"...}]}) →
    reference table_parsing_visualization: green cell polys + text quads."""
    out = np.ascontiguousarray(np.asarray(image).copy())
    for cell in table_result.get("cells", []):
        poly = cell.get("cell_poly") or cell.get("poly")
        if poly is None:
            continue
        p = np.asarray(poly, np.float32).reshape(-1)
        if p[0] < 0 or p[1] < 0:       # dummy cell (reference skip)
            continue
        polylines(out, _poly_pts(p), _CELL_COLOR, 2)
    return out


def png_bytes(image: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → an 8-bit RGB PNG (filter None, zlib level
    6)."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          image.reshape(h, -1)], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_image(image: np.ndarray, path: str) -> None:
    """RGB uint8 [H, W, 3] → a PNG file that decodes to the same RGB (the
    JAX module's `cv2.imwrite` of the BGR-flipped array gives the same).
    Only PNG is written."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".png":
        raise ValueError(f"save_image writes PNG only; {path!r} asks for "
                         f"{ext or 'no extension'}")
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"save_image takes uint8 [H, W, 3]; got "
                         f"{image.dtype} {image.shape}")
    with open(path, "wb") as f:
        f.write(png_bytes(image))
