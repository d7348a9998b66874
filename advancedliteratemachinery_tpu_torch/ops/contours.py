"""cv2's contour geometry on the host, in Python and NumPy, for the DB
detector's host box extraction (`models/db.py` `extract_boxes`, the JAX
package's `extract_boxes` without cv2, which the card's machine lacks).
Each function gives what the named cv2 5.0 call gives, point for point
and in the same order, since the extraction's boxes, scores and order
follow from them:

- `find_contours`: `cv2.findContours(binary, RETR_LIST,
  CHAIN_APPROX_SIMPLE)[0]`: Suzuki–Abe border following (foreground
  8-connected, background 4-connected) over the image padded by one zero
  pixel, as OpenCV's scanner runs it: outer borders and the borders of
  holes, each compressed to the points where its chain code turns, listed
  in the reverse of the order the raster scan finds them;
- `min_area_rect`: `cv2.minAreaRect`: OpenCV's Sklansky convex hull of the
  points, then its rotating calipers in float32 (a later caliper only if
  its cosine is more than FLT_EPSILON larger; area ties to the last
  edge), the side whose direction lies in [-90°, 0) reported as the
  width;
- `box_points`: `cv2.boxPoints`;
- `fill_poly_window`: `cv2.fillPoly(mask, [pts], 1)` for integer points
  (LINE_8, no shift) over a window of the mask: the polygon's outline by
  OpenCV's 8-connected line iterator plus its scanline fill in 16.16 fixed
  point;
- `contour_area`, `arc_length`: `cv2.contourArea`, `cv2.arcLength(...,
  True)`;
- `polyline_window`: `cv2.polylines(mask, [pts], True, 1)` (thickness 1,
  LINE_8) over a window of the mask, by `utils/visualization.py`'s
  raster of cv2's line iterator;
- `distance_transform`: `cv2.distanceTransform(src, DIST_L2, 3)` as
  OpenCV's own code computes it: the 3x3 chamfer distance to the nearest
  zero pixel, in 16.16 fixed point (steps 0.955 and 1.3693), by its two
  raster passes. Pixels outside the image count as far, not as zero.

`db_targets` (`models/db.py`) fills, outlines and measures each polygon
with them for the DB training maps.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from advancedliteratemachinery_tpu_torch.utils.visualization import (
    polyline_mask)

# chain code s → (dx, dy): east, then counterclockwise (y grows down)
_CODES = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1),
          (1, 1))
# labels of the padded image while tracing: background, foreground not yet
# on a traced border, on a border, on a border with background east of it
# (OpenCV's 1, nbd and nbd | -128)
_BG, _FG, _SEEN, _EAST = 0, 1, 2, 3


def _trace(lab: bytearray, i0: int, hole: bool, step: int,
           origin: Tuple[int, int]) -> List[Tuple[int, int]]:
    """OpenCV's `icvFetchContour` with CHAIN_APPROX_SIMPLE: follow the
    border that starts at flat index `i0` (an outer border entered from the
    west, a hole's from the east), labelling it in `lab`; → its points
    (x, y) in image coordinates, `origin` being i0's."""
    deltas = [dx + dy * step for dx, dy in _CODES] * 2
    s = s_end = 0 if hole else 4
    while True:                      # clockwise for the first neighbour
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if lab[i1] != _BG or s == s_end:
            break
    x, y = origin
    if lab[i1] == _BG:                              # a single pixel
        lab[i0] = _EAST
        return [(x, y)]
    points = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:                # counterclockwise for the next pixel
            s += 1
            i4 = i3 + deltas[s]
            if lab[i4] != _BG:
                break
        s &= 7
        if 0 < s <= s_end:          # the search passed the east neighbour
            lab[i3] = _EAST
        elif lab[i3] == _FG:
            lab[i3] = _SEEN
        if s != prev_s:
            points.append((x, y))
            prev_s = s
        x += _CODES[s][0]
        y += _CODES[s][1]
        if i4 == i0 and i3 == i1:
            return points
        i3 = i4
        s = (s + 4) & 7


def find_contours(binary: np.ndarray) -> List[np.ndarray]:
    """uint8 [H, W] (nonzero = foreground) → the contours of
    `cv2.findContours(binary, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)`,
    each int32 [n, 1, 2] of (x, y), in cv2's order."""
    H, W = binary.shape
    pad = np.zeros((H + 2, W + 2), np.uint8)
    pad[1:-1, 1:-1] = binary != 0
    step = W + 2
    # the scanner's stops: an outer border starts where foreground follows
    # background, a hole's border (at the pixel before) where background
    # follows foreground; whether each one starts a border depends on the
    # labels the borders traced before it have left
    fg = pad[1:-1, 1:-1].astype(bool)
    left = pad[1:-1, :-2].astype(bool)
    stops = np.flatnonzero((fg != left).reshape(-1))
    ys, xs = np.divmod(stops, W)
    lab = bytearray(pad.tobytes())
    found = []
    for y, x in zip(ys.tolist(), xs.tolist()):
        i = (y + 1) * step + x + 1
        if lab[i] == _FG and lab[i - 1] == _BG:
            found.append(_trace(lab, i, False, step, (x, y)))
        elif lab[i] == _BG and lab[i - 1] in (_FG, _SEEN):
            found.append(_trace(lab, i - 1, True, step, (x - 1, y)))
    return [np.asarray(c, np.int32).reshape(-1, 1, 2) for c in found[::-1]]


def _sklansky(pts, start: int, end: int, nsign: int, sign2: int):
    """OpenCV's `Sklansky_` over x-sorted points: the indices of one hull
    chain from `start` to `end`."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or pts[start] == pts[end]:
        return [start]
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = pts[pcur][1], pts[pnext][1]
        by = nexty - cury
        if (by > 0) - (by < 0) != nsign:
            ax = pts[pcur][0] - pts[pprev][0]
            bx = pts[pnext][0] - pts[pcur][0]
            ay = cury - pts[pprev][1]
            convexity = ay * bx - ax * by
            if (convexity > 0) - (convexity < 0) == sign2 and (ax or ay):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(points) -> List[int]:
    """Integer points [(x, y)] → the indices of `cv2.convexHull(points,
    clockwise=False)`'s points, in its order: OpenCV's Sklansky chains
    over the points sorted by (x, y), then cyclically shifted, where it
    can be, so that the indices ascend or descend."""
    order = sorted(range(len(points)), key=lambda i: tuple(points[i]))
    pts = [tuple(points[i]) for i in order]
    total = len(pts)
    miny = maxy = 0
    for i in range(1, total):
        y = pts[i][1]
        if pts[miny][1] > y:
            miny = i
        if pts[maxy][1] < y:
            maxy = i
    if pts[0] == pts[-1]:
        return [order[0]]
    tr = _sklansky(pts, 0, maxy, -1, 1)        # counterclockwise: the
    tl = _sklansky(pts, total - 1, maxy, -1, -1)    # chains swapped
    hull = tl[:-1] + tr[:0:-1]
    stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
    bl = _sklansky(pts, 0, miny, 1, -1)
    br = _sklansky(pts, total - 1, miny, 1, 1)
    if stop >= 0:
        check = (bl[1] if len(bl) > 2 else
                 br[2 - len(bl)] if len(bl) + len(br) > 2 else -1)
        if check == stop or (check >= 0 and pts[check] == pts[stop]):
            # collinear points: the lower chain mirrors the upper one
            bl, br = bl[:2], br[:2]
    hull = [order[i] for i in hull + bl[:-1] + br[:0:-1]]
    n = len(hull)
    for ascending in (True, False):
        i0 = hull.index(min(hull) if ascending else max(hull))
        shifted = hull[i0:] + hull[:i0]
        if n >= 3 and all((a < b) == ascending
                          for a, b in zip(shifted, shifted[1:])):
            return shifted
    return hull


_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def _calipers(pts: List[Tuple[float, float]]):
    """OpenCV's `rotatingCalipers(CALIPERS_MINAREARECT)` in float32 → the
    rectangle's corner and two side vectors (out[0..2])."""
    f = np.float32
    n = len(pts)
    P = [(f(x), f(y)) for x, y in pts]
    vect, length, inv_len = [], [], []
    left = bottom = right = top = 0
    left_x = right_x = P[0][0]
    top_y = bottom_y = P[0][1]
    for i in range(n):
        x0, y0 = P[i]
        if x0 < left_x:
            left_x, left = x0, i
        if x0 > right_x:
            right_x, right = x0, i
        if y0 > top_y:
            top_y, top = y0, i
        if y0 < bottom_y:
            bottom_y, bottom = y0, i
        x1, y1 = P[(i + 1) % n]
        dx, dy = float(x1) - float(x0), float(y1) - float(y0)
        vect.append((f(dx), f(dy)))
        length.append(f(math.sqrt(dx * dx + dy * dy)))
        inv_len.append(f(1.0 / math.sqrt(dx * dx + dy * dy)))
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    orientation = f(0)
    for i in range(n):
        bx, by = float(vect[i][0]), float(vect[i][1])
        convexity = ax * by - ay * bx
        if convexity != 0:
            orientation = f(1) if convexity > 0 else f(-1)
            break
        ax, ay = bx, by
    if orientation == 0:
        raise ValueError("minAreaRect: degenerate hull")
    base_a, base_b = orientation, f(0)
    seq = [bottom, right, top, left]
    minarea = f(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        dp = (base_a * vect[seq[0]][0] + base_b * vect[seq[0]][1],
              -base_b * vect[seq[1]][0] + base_a * vect[seq[1]][1],
              -base_a * vect[seq[2]][0] - base_b * vect[seq[2]][1],
              base_b * vect[seq[3]][0] - base_a * vect[seq[3]][1])
        # the cosines divide by the edges' lengths (the base vectors below
        # multiply by their inverses); a later caliper only if clearly
        # closer
        main, maxcos = 0, dp[0] / length[seq[0]]
        for i in range(1, 4):
            cosalpha = dp[i] / length[seq[i]]
            if cosalpha > maxcos + _FLT_EPSILON:
                main, maxcos = i, cosalpha
        p = seq[main]
        lead_x, lead_y = vect[p][0] * inv_len[p], vect[p][1] * inv_len[p]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx = P[seq[1]][0] - P[seq[3]][0]
        dy = P[seq[1]][1] - P[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx = P[seq[2]][0] - P[seq[0]][0]
        dy = P[seq[2]][1] - P[seq[0]][1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    left_i, a1, width, b1, height, bottom_i = best
    a2, b2 = -b1, a1
    c1 = a1 * P[left_i][0] + P[left_i][1] * b1
    c2 = a2 * P[bottom_i][0] + P[bottom_i][1] * b2
    idet = f(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return (px, py), (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(points) -> Tuple[Tuple[float, float],
                                   Tuple[float, float], float]:
    """Integer points [n, 1, 2] or [n, 2] → `cv2.minAreaRect(points)`:
    ((cx, cy), (w, h), angle), float32 values. The side vector's angle is
    taken in double and brought into cv2 5.0's range [-90, 0) by quarter
    turns, each swapping width and height."""
    f = np.float32
    pts = np.asarray(points).reshape(-1, 2).tolist()
    hull = [(float(pts[i][0]), float(pts[i][1])) for i in convex_hull(pts)]
    if len(hull) > 2:
        o, (vx, vy), s2 = _calipers(hull)
        cx = o[0] + (vx + s2[0]) * f(0.5)
        cy = o[1] + (vy + s2[1]) * f(0.5)
        w = float(f(math.sqrt(float(vx) ** 2 + float(vy) ** 2)))
        h = float(f(math.sqrt(float(s2[0]) ** 2 + float(s2[1]) ** 2)))
        angle = math.atan2(float(vy), float(vx)) * 180 / math.pi
    elif len(hull) == 2:
        (x0, y0), (x1, y1) = hull
        cx, cy = (f(x0) + f(x1)) * f(0.5), (f(y0) + f(y1)) * f(0.5)
        dx, dy = float(f(x1) - f(x0)), float(f(y1) - f(y0))
        w, h = float(f(math.sqrt(dx * dx + dy * dy))), 0.0
        angle = math.atan2(dy, dx) * 180 / math.pi
    else:
        (cx, cy), w, h, angle = hull[0], 0.0, 0.0, 0.0
    while angle >= 0.0:
        angle, w, h = angle - 90.0, h, w
    while angle < -90.0:
        angle, w, h = angle + 90.0, h, w
    return (float(cx), float(cy)), (w, h), float(f(angle))


def box_points(rect) -> np.ndarray:
    """`cv2.boxPoints(rect)` → float32 [4, 2]."""
    f = np.float32
    (cx, cy), (w, h), angle = rect
    cx, cy, w, h = f(cx), f(cy), f(w), f(h)
    rad = float(angle) * math.pi / 180.0
    b = f(math.cos(rad)) * f(0.5)
    a = f(math.sin(rad)) * f(0.5)
    return np.array([(cx - a * h - b * w, cy + b * h - a * w),
                     (cx + a * h - b * w, cy - b * h - a * w),
                     (cx + a * h + b * w, cy - b * h + a * w),
                     (cx - a * h + b * w, cy + b * h + a * w)], np.float32)


def contour_area(pts) -> np.ndarray:
    """`cv2.contourArea(p)` (unoriented) of each float32 polygon p of
    [..., n, 2]: the shoelace terms in double, summed in order → float64
    [...]."""
    p = np.asarray(pts, np.float32).astype(np.float64)
    q = np.roll(p, 1, axis=-2)                      # each point's previous
    terms = q[..., 0] * p[..., 1] - q[..., 1] * p[..., 0]
    a = np.zeros(terms.shape[:-1])
    for j in range(terms.shape[-1] if terms.shape[-1] >= 3 else 0):
        a += terms[..., j]
    return np.abs(a * 0.5)


def arc_length(pts) -> np.ndarray:
    """`cv2.arcLength(p, True)` of each float32 polygon p of [..., n, 2]:
    float32 side lengths summed in order in double → float64 [...]."""
    p = np.asarray(pts, np.float32)
    d = p - np.roll(p, 1, axis=-2)
    sides = np.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    out = np.zeros(sides.shape[:-1])
    for j in range(sides.shape[-1] if sides.shape[-1] >= 2 else 0):
        out += sides[..., j]
    return out


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's `clipLine` on an image of w x h → (inside, p1, p2)."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2

    def code(x, y, vertical=True):
        return ((x < 0) + (x > right) * 2
                + ((y < 0) * 4 + (y > bottom) * 8 if vertical else 0))

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line_pixels(w: int, h: int, p1, p2, xs: List[int], ys: List[int]):
    """Append to `xs`, `ys` the pixels of OpenCV's 8-connected
    `LineIterator(img, p1, p2, 8, leftToRight=true)`."""
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        xs.append(x)
        ys.append(y)
        if err < 0:
            err += 2 * dx - 2 * dy
            x, y = x + 1, y + sy
        else:
            err -= 2 * dy
            if vert:
                y += sy
            else:
                x += 1


def fill_poly_window(pts, shape: Tuple[int, int],
                     window: Tuple[int, int, int, int]) -> np.ndarray:
    """`cv2.fillPoly(zeros(shape), [pts], 1)` (int points [n, 2], LINE_8,
    no shift) restricted to `window` (y0, y1, x0, x1) → uint8 [y1 - y0,
    x1 - x0]."""
    H, W = shape
    wy0, wy1, wx0, wx1 = window
    mask = np.zeros((wy1 - wy0, wx1 - wx0), np.uint8)
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges, xs, ys = [], [], []
    pt0 = v[-1]
    for pt1 in v:
        _line_pixels(W, H, pt0, pt1, xs, ys)
        c0 = (pt0[0] << 16, pt0[1])
        c1 = (pt1[0] << 16, pt1[1])
        if not (0 <= pt0[0] < W and 0 <= pt1[0] < W and 0 <= pt0[1] < H
                and 0 <= pt1[1] < H):
            _, t0, t1 = _clip_line(W, H, pt0, pt1)
            if t0[1] != t1[1]:
                c0, c1 = (t0[0] << 16, t0[1]), (t1[0] << 16, t1[1])
        if pt0[1] != pt1[1]:
            dx = _tdiv(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append([pt0[1], pt1[1],
                              c0[0] + (pt0[1] - c0[1]) * dx, dx])
            else:
                edges.append([pt1[1], pt0[1],
                              c1[0] + (pt1[1] - c1[1]) * dx, dx])
        pt0 = pt1
    if xs:
        mask[np.array(ys) - wy0, np.array(xs) - wx0] = 1
    if len(edges) < 2:
        return mask
    # nothing is drawn unless some edge reaches into the image on a row
    # where it is active (rows y0 .. y1 - 1)
    reach = []
    for y0, y1, x0, dx in edges:
        r0, r1 = max(y0, 0), min(y1, H) - 1
        if r0 <= r1:
            reach += [x0 + (r0 - y0) * dx, x0 + (r1 - y0) * dx]
    if not reach or max(reach) < 0 or min(reach) >= W << 16:
        return mask
    # OpenCV walks an active edge list a row at a time, adding dx to each
    # edge's x after the row; on a row it pairs the edges in their order
    # of x. The same spans in closed form: an edge's x on row y is
    # x0 + (y - y0) * dx, the row's active edges sorted, taken in pairs.
    e = np.asarray(edges, np.int64)
    rows = np.arange(max(int(e[:, 0].min()), 0, wy0),
                     min(int(e[:, 1].max()), H, wy1))[:, None]
    active = (e[:, 0] <= rows) & (rows < e[:, 1])
    xs = np.sort(np.where(active, e[:, 2] + (rows - e[:, 0]) * e[:, 3],
                          np.iinfo(np.int64).max), axis=1)
    cols = np.arange(wx0, wx1)
    for j in range(0, len(edges) - 1, 2):
        ok = active.sum(1, keepdims=True) > j + 1
        x1 = (xs[:, j:j + 1] + 0xFFFF) >> 16          # rounded inward
        x2 = xs[:, j + 1:j + 2] >> 16
        ok &= (x1 < W) & (x2 >= 0)
        mask[rows[:, 0] - wy0] |= (ok & (cols >= np.maximum(x1, 0))
                                   & (cols <= np.minimum(x2, W - 1)))
    return mask


def polyline_window(pts, shape: Tuple[int, int],
                    window: Tuple[int, int, int, int]) -> np.ndarray:
    """`cv2.polylines(zeros(shape, uint8), [pts], True, 1)` (int points
    [n, 2], thickness 1, LINE_8) restricted to `window` (y0, y1, x0, x1)
    → uint8 [y1 - y0, x1 - x0]."""
    y0, y1, x0, x1 = window
    mask = polyline_mask(shape, np.asarray(pts).reshape(-1, 1, 2), 1)
    return mask[y0:y1, x0:x1].astype(np.uint8)


# cv2.distanceTransform's 3x3 L2 mask (getDistanceTransformMask, code 32):
# the horizontal/vertical and the diagonal step in 16.16 fixed point,
# cvRound(x · 2^16)
_DIST_SHIFT = 16
_HV = round(0.955 * (1 << _DIST_SHIFT))
_DIAG = round(1.3693 * (1 << _DIST_SHIFT))
_FAR = 2 ** 32 - 1 - _DIAG      # off the image, and the largest distance


def _row_min(r: np.ndarray, step: np.ndarray) -> np.ndarray:
    """t[j] = min(r[j], t[j − 1] + HV) from left to right, in closed form
    (exact in integers): min over k ≤ j of r[k] + (j − k)·HV."""
    return np.minimum.accumulate(r - step) + step


def distance_transform(src: np.ndarray) -> np.ndarray:
    """`cv2.distanceTransform(src, cv2.DIST_L2, 3)` for a uint8 [H, W]
    image → float32 [H, W], as OpenCV's own `distanceTransform_3x3` computes
    it: each nonzero pixel's 3x3 chamfer distance to the nearest zero
    pixel, in unsigned 16.16 fixed point, by a forward raster pass (from
    the row above and the pixel to the left) and a backward one (from the
    row below and the pixel to the right), capped at UINT_MAX − DIAG (the
    frame around the image, and the value of an image without a zero
    pixel) and scaled by 2^-16 in float32. (A cv2 built with IPP takes
    IPP's float32 transform by default, whose sums along a row round
    otherwise: `cv2.ipp.setUseIPP(False)` gives OpenCV's.)"""
    zero = np.asarray(src) == 0
    H, W = zero.shape
    t = np.full((H + 2, W + 2), _FAR, np.int64)
    step = np.arange(W, dtype=np.int64) * _HV
    for i in range(1, H + 1):
        up = t[i - 1]
        r = np.minimum(np.minimum(up[:-2] + _DIAG, up[1:-1] + _HV),
                       up[2:] + _DIAG)
        r[zero[i - 1]] = 0
        t[i, 1:-1] = _row_min(r, step)
    for i in range(H, 0, -1):
        down = t[i + 1]
        r = np.minimum(np.minimum(t[i, 1:-1], down[2:] + _DIAG),
                       np.minimum(down[1:-1] + _HV, down[:-2] + _DIAG))
        t[i, 1:-1] = _row_min(r[::-1], step)[::-1]      # right to left
    out = np.minimum(t[1:-1, 1:-1], _FAR).astype(np.float32)
    return out * np.float32(1.0 / (1 << _DIST_SHIFT))
