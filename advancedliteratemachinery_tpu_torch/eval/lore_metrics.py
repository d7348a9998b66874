"""LORE-TSR evaluation: cell detection P/R/F1 + logical-location accuracy.

Parity target: LORE-TSR/src/lib/utils/eval_utils.py — pairTab :58 (greedy
GT→pred matching at axis-aligned IoU ≥ 0.5 over the cells' bounding
rectangles), evalBbox :79, evalAxis :116 (a matched cell counts only if all
four logical coordinates match exactly).

The port's copy of `advancedliteratemachinery_tpu/eval/lore_metrics.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _rect_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU of axis-aligned rects (x1, y1, x2, y2) — eval_utils.py:97."""
    lx = max(a[0], b[0])
    rx = min(a[2], b[2])
    uy = max(a[1], b[1])
    dy = min(a[3], b[3])
    if lx >= rx or dy <= uy:
        return 0.0
    s1 = (a[2] - a[0]) * (a[3] - a[1])
    s2 = (b[2] - b[0]) * (b[3] - b[1])
    inter = (dy - uy) * (rx - lx)
    return inter / (s1 + s2 - inter)


def quad_to_rect(quad: Sequence[float]) -> Tuple[float, float, float, float]:
    """8-dof box → bounding rect (the reference compares point1/point3)."""
    xs = quad[0::2]
    ys = quad[1::2]
    return min(xs), min(ys), max(xs), max(ys)


def match_cells(pred_rects: List, gt_rects: List, iou_thr: float = 0.5
                ) -> List[Optional[int]]:
    """Greedy first-match per GT (eval_utils.py:66 matching)."""
    matches: List[Optional[int]] = []
    for g in gt_rects:
        found = None
        for i, p in enumerate(pred_rects):
            if _rect_iou(g, p) >= iou_thr:
                found = i
                break
        matches.append(found)
    return matches


def bbox_prf(pred_rects: List, gt_rects: List, iou_thr: float = 0.5
             ) -> Dict[str, float]:
    matches = match_cells(pred_rects, gt_rects, iou_thr)
    tp = sum(1 for m in matches if m is not None)
    p = tp / max(len(pred_rects), 1)
    r = tp / max(len(gt_rects), 1)
    f = 2 * p * r / max(p + r, 1e-9)
    return {"precision": p, "recall": r, "f1": f, "tp": tp}


def logical_accuracy(pred_rects: List, pred_axes: List, gt_rects: List,
                     gt_axes: List, iou_thr: float = 0.5) -> float:
    """Fraction of matched cells whose 4 logical coords are exactly right
    (eval_utils.py:116 evalAxis)."""
    matches = match_cells(pred_rects, gt_rects, iou_thr)
    tp, correct = 0, 0
    for gi, m in enumerate(matches):
        if m is None:
            continue
        tp += 1
        if all(int(pred_axes[m][j]) == int(gt_axes[gi][j]) for j in range(4)):
            correct += 1
    return correct / max(tp, 1)
