"""NMS for 4-point (quadrilateral) and axis-aligned boxes, on the tensors'
device (port of `advancedliteratemachinery_tpu/ops/nms.py`).

Replaces the reference's Cython/shapely NMS
(LORE-TSR/src/lib/external/nms.pyx — greedy/soft NMS;
LORE-TSR/src/lib/utils/shapelyNMS.py `pnms` — polygon IoU via shapely;
DocXLayout/external/nms.pyx).

Polygon IoU is computed exactly with a masked Sutherland–Hodgman clip, as
the JAX module does it: slots that emit nothing repeat the previous emitted
vertex (leading ones the last), which leaves the shoelace area unchanged,
so every clip keeps a fixed number of slots. The greedy loops run one step
per box on the device and read nothing back.
"""

from __future__ import annotations

import torch

EPS = 1e-9


def shoelace_area(pts: torch.Tensor) -> torch.Tensor:
    """Signed area of a (cyclic, possibly duplicate-padded) polygon
    [..., V, 2]."""
    x, y = pts[..., 0], pts[..., 1]
    xn = torch.roll(x, -1, dims=-1)
    yn = torch.roll(y, -1, dims=-1)
    return 0.5 * torch.sum(x * yn - xn * y, dim=-1)


def _clip_by_edge(pts: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """One Sutherland–Hodgman pass: clip polygon `pts` [..., V, 2] by the
    half-plane left of directed edge a→b (each [..., 2]). Returns
    [..., 2V, 2] with fillers repeating the previous emitted vertex."""
    V = pts.shape[-2]
    prev = torch.roll(pts, 1, dims=-2)

    def side(p):
        return ((b[..., None, 0] - a[..., None, 0])
                * (p[..., 1] - a[..., None, 1])
                - (b[..., None, 1] - a[..., None, 1])
                * (p[..., 0] - a[..., None, 0]))

    d1, d2 = side(prev), side(pts)
    c_in, p_in = d2 >= 0, d1 >= 0
    # intersection of segment prev→pts with the edge line
    den = d1 - d2
    t = d1 / torch.where(torch.abs(den) < EPS, torch.full_like(den, EPS),
                         den)
    inter = prev + t[..., None] * (pts - prev)
    # interleave [inter_0, cur_0, inter_1, cur_1, ...]
    cand = torch.stack([inter, pts], dim=-2).reshape(*pts.shape[:-2],
                                                     2 * V, 2)
    valid = torch.stack([c_in ^ p_in, c_in], dim=-1).reshape(
        *pts.shape[:-2], 2 * V)
    # each slot takes the last valid slot at or before it; the polygon is
    # cyclic, so leading invalid slots take the last valid one of all
    slot = torch.arange(2 * V, device=pts.device)
    last = torch.cummax(torch.where(valid, slot, -1), dim=-1).values
    src = torch.where(last >= 0, last, last[..., -1:])
    filled = torch.gather(cand, -2, src.clamp(min=0)[..., None].expand(
        *src.shape, 2))
    # a row with no valid slot at all is the empty polygon
    return torch.where(valid.any(dim=-1)[..., None, None], filled,
                       torch.zeros_like(filled))


def quad_intersection_area(q1: torch.Tensor, q2: torch.Tensor
                           ) -> torch.Tensor:
    """Exact |q1 ∩ q2| for convex quads [..., 4, 2] (counter-clockwise)."""
    # 8 slots: the 4 real vertices + the last vertex repeated (duplicate
    # vertices are harmless for clipping and shoelace)
    poly = torch.cat([q1, q1[..., -1:, :].expand(*q1.shape[:-2], 4, 2)],
                     dim=-2)
    for i in range(4):
        poly = _clip_by_edge(poly, q2[..., i, :], q2[..., (i + 1) % 4, :])
    return torch.abs(shoelace_area(poly))


def _ccw(quad: torch.Tensor) -> torch.Tensor:
    """Orient quads counter-clockwise (positive shoelace)."""
    area = shoelace_area(quad)
    return torch.where(area[..., None, None] < 0, quad.flip(-2), quad)


def quad_iou(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """IoU of convex quads [..., 4, 2] (any vertex order; batch dims
    broadcast)."""
    q1, q2 = torch.broadcast_tensors(q1, q2)
    q1, q2 = _ccw(q1), _ccw(q2)
    inter = quad_intersection_area(q1, q2)
    a1 = torch.abs(shoelace_area(q1))
    a2 = torch.abs(shoelace_area(q2))
    return inter / torch.clamp(a1 + a2 - inter, min=EPS)


def poly_nms(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.3) -> torch.Tensor:
    """Greedy NMS over 4-point boxes (reference shapelyNMS.pnms / nms.pyx
    greedy path). boxes [K, 8] (x1..y4, score-descending), scores [K] →
    keep mask [K] bool."""
    K = boxes.shape[0]
    quads = boxes.reshape(K, 4, 2)
    iou = quad_iou(quads[:, None], quads[None, :])          # [K, K]
    idx = torch.arange(K, device=boxes.device)
    keep = torch.ones(K, dtype=torch.bool, device=boxes.device)
    for i in range(K):
        keep = keep & ~(keep[i] & (idx > i) & (iou[i] > iou_threshold))
    return keep


def soft_nms_scores(boxes: torch.Tensor, scores: torch.Tensor,
                    sigma: float = 0.5, method: str = "gaussian"
                    ) -> torch.Tensor:
    """Soft-NMS (nms.pyx soft path): decay scores of overlapping
    lower-ranked boxes instead of removing them. Returns decayed scores."""
    K = boxes.shape[0]
    quads = boxes.reshape(K, 4, 2)
    iou = quad_iou(quads[:, None], quads[None, :])
    idx = torch.arange(K, device=boxes.device)
    s = scores
    for i in range(K):
        if method == "gaussian":
            decay = torch.exp(-(iou[i] ** 2) / sigma)
        else:
            decay = torch.where(iou[i] > sigma, 1.0 - iou[i],
                                torch.ones_like(iou[i]))
        s = torch.where(idx > i, s * decay, s)
    return s


def box_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU matrix [N, N] for boxes [N, 4] (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, None] + area[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def box_nms(boxes: torch.Tensor, scores: torch.Tensor,
            iou_thr: float = 0.5) -> torch.Tensor:
    """Greedy axis-aligned NMS with a fixed shape: returns a bool keep mask
    [N] (torchvision.ops.nms semantics — iterate by descending score, ties
    in index order, suppress IoU > thr). Padding rows should carry score
    -inf."""
    N = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = box_iou_matrix(boxes[order])
    idx = torch.arange(N, device=boxes.device)
    keep_sorted = torch.ones(N, dtype=torch.bool, device=boxes.device)
    for i in range(N):
        keep_sorted = keep_sorted & ~((iou[i] > iou_thr) & (idx > i)
                                      & keep_sorted[i])
    keep = torch.zeros(N, dtype=torch.bool, device=boxes.device)
    keep[order] = keep_sorted
    return keep
