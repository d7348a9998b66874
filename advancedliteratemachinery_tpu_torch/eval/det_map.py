"""COCO-protocol detection mAP (AP@[.50:.95], 101-point interpolation).

The reference scores VGT through detectron2's COCOEvaluator
(DocumentUnderstanding/VGT/ditod/VGTTrainer.py:668 build_evaluator → COCO
mAP on PubLayNet/DocLayNet) and OmniParser's spotting JSON feeds the same
protocol. This is a dependency-free reimplementation of the COCOeval
bbox pipeline (greedy score-ordered matching with crowd/ignore handling,
precision envelope over 101 recall points, mean over 10 IoU thresholds).

Inputs use COCO-JSON shapes so detectron2/COCOEvaluator artifacts drop in:
  detections:   {"image_id", "category_id", "bbox" [x,y,w,h], "score"}
  ground truth: {"image_id", "category_id", "bbox" [x,y,w,h], "iscrowd"?}

The port's copy of `advancedliteratemachinery_tpu/eval/det_map.py`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)      # .50:.05:.95
RECALL_POINTS = np.linspace(0.0, 1.0, 101)                   # 101-pt interp


def _xywh_iou(det: np.ndarray, gt: np.ndarray, crowd: np.ndarray
              ) -> np.ndarray:
    """[D, 4] x [G, 4] → [D, G] IoU; crowd GT uses intersection/det-area
    (pycocotools maskUtils.iou iscrowd semantics)."""
    D, G = len(det), len(gt)
    out = np.zeros((D, G))
    if D == 0 or G == 0:
        return out
    dx0, dy0 = det[:, 0], det[:, 1]
    dx1, dy1 = det[:, 0] + det[:, 2], det[:, 1] + det[:, 3]
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1, gy1 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.maximum(0.0, np.minimum(dx1[:, None], gx1[None]) -
                    np.maximum(dx0[:, None], gx0[None]))
    ih = np.maximum(0.0, np.minimum(dy1[:, None], gy1[None]) -
                    np.maximum(dy0[:, None], gy0[None]))
    inter = iw * ih
    da = (det[:, 2] * det[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(crowd[None], da, da + ga - inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / union, 0.0)
    return out


def _match_image(ious: np.ndarray, gt_ignore: np.ndarray, thr: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """COCOeval evaluateImg matching for one (image, category, threshold).

    ious: [D, G] with detections already score-sorted and GTs sorted
    ignore-last. Returns (dt_matched [D] bool, dt_ignore [D] bool).
    """
    D, G = ious.shape
    gt_taken = np.zeros(G, bool)
    dt_matched = np.zeros(D, bool)
    dt_ignore = np.zeros(D, bool)
    for d in range(D):
        best = thr - 1e-10
        m = -1
        for g in range(G):
            if gt_taken[g] and not gt_ignore[g]:
                continue
            # once matched to a real GT, never downgrade to an ignore GT
            if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                break
            if ious[d, g] < best:
                continue
            best = ious[d, g]
            m = g
        if m == -1:
            continue
        dt_matched[d] = True
        dt_ignore[d] = bool(gt_ignore[m])
        if not gt_ignore[m]:
            gt_taken[m] = True
    return dt_matched, dt_ignore


def _ap_from_matches(scores: np.ndarray, matched: np.ndarray,
                     ignored: np.ndarray, n_gt: int) -> float:
    """Accumulate one (category, IoU-threshold) PR curve → interpolated AP."""
    if n_gt == 0:
        return float("nan")
    keep = ~ignored
    scores, matched = scores[keep], matched[keep]
    order = np.argsort(-scores, kind="mergesort")
    tp = np.cumsum(matched[order])
    fp = np.cumsum(~matched[order])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-12)
    # precision envelope (monotone non-increasing from the right)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    # value at each recall point: first precision with recall >= r
    # (COCOeval accumulate: searchsorted into rc, zeros past max recall)
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    q = np.zeros(len(RECALL_POINTS))
    inside = idx < len(precision)
    q[inside] = precision[idx[inside]]
    return float(np.mean(q))


def coco_map(
    detections: Sequence[Dict],
    ground_truths: Sequence[Dict],
    iou_thresholds: Optional[Sequence[float]] = None,
    max_dets: int = 100,
    categories: Optional[Sequence[int]] = None,
) -> Dict[str, float]:
    """→ {"mAP", "AP50", "AP75", "AP@{cat}" per category}.

    mAP is the mean over categories (that have GT) of the mean over IoU
    thresholds of the 101-point-interpolated AP — the COCO headline
    metric detectron2 reports for VGT (VGTTrainer.py:679 test)."""
    thrs = np.asarray(iou_thresholds if iou_thresholds is not None
                      else IOU_THRESHOLDS, np.float64)
    cats = sorted(categories if categories is not None else
                  {g["category_id"] for g in ground_truths})

    gt_by = defaultdict(list)
    for g in ground_truths:
        gt_by[(g["image_id"], g["category_id"])].append(g)
    dt_by = defaultdict(list)
    for d in detections:
        dt_by[(d["image_id"], d["category_id"])].append(d)
    images = sorted({k[0] for k in list(gt_by) + list(dt_by)},
                    key=lambda x: str(x))

    ap_per_cat_thr: Dict[int, np.ndarray] = {}
    for cat in cats:
        scores_all: List[np.ndarray] = []
        matched_all: List[List[np.ndarray]] = [[] for _ in thrs]
        ignored_all: List[List[np.ndarray]] = [[] for _ in thrs]
        n_gt = 0
        for img in images:
            gts = gt_by.get((img, cat), [])
            dts = sorted(dt_by.get((img, cat), []),
                         key=lambda d: -d["score"])[:max_dets]
            gt_ign = np.asarray([bool(g.get("iscrowd", 0)) for g in gts],
                                bool)
            # ignore GTs sort last (COCOeval gtind order)
            order = np.argsort(gt_ign, kind="mergesort")
            gts = [gts[i] for i in order]
            gt_ign = gt_ign[order]
            n_gt += int((~gt_ign).sum())
            dbox = np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
            gbox = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
            ious = _xywh_iou(dbox, gbox, gt_ign)
            scores_all.append(np.asarray([d["score"] for d in dts]))
            for ti, t in enumerate(thrs):
                m, ig = _match_image(ious, gt_ign, float(t))
                matched_all[ti].append(m)
                ignored_all[ti].append(ig)
        scores = (np.concatenate(scores_all) if scores_all
                  else np.zeros(0))
        aps = np.asarray([
            _ap_from_matches(scores, np.concatenate(matched_all[ti])
                             if matched_all[ti] else np.zeros(0, bool),
                             np.concatenate(ignored_all[ti])
                             if ignored_all[ti] else np.zeros(0, bool), n_gt)
            for ti in range(len(thrs))])
        ap_per_cat_thr[cat] = aps

    valid = [c for c in cats if not np.all(np.isnan(ap_per_cat_thr[c]))]
    out: Dict[str, float] = {}
    if valid:
        stack = np.stack([ap_per_cat_thr[c] for c in valid])   # [C, T]
        out["mAP"] = float(np.nanmean(stack))
        for name, t in (("AP50", 0.5), ("AP75", 0.75)):
            ti = np.where(np.isclose(thrs, t))[0]
            if len(ti):
                out[name] = float(np.nanmean(stack[:, ti[0]]))
        for c in valid:
            out[f"AP@{c}"] = float(np.nanmean(ap_per_cat_thr[c]))
    else:
        out["mAP"] = float("nan")
    return out


def cascade_to_coco(outputs: Dict, image_id, category_offset: int = 1
                    ) -> List[Dict]:
    """VGT Cascade R-CNN inference outputs (models/rcnn.py __call__:
    boxes xyxy / scores / classes / valid) → coco_map detection dicts.
    category_offset maps 0-based class ids to COCO 1-based categories."""
    boxes = np.asarray(outputs["boxes"], np.float64)
    scores = np.asarray(outputs["scores"], np.float64)
    classes = np.asarray(outputs["classes"])
    valid = np.asarray(outputs["valid"], bool)
    out = []
    for i in np.where(valid)[0]:
        x0, y0, x1, y1 = boxes[i]
        out.append({"image_id": image_id,
                    "category_id": int(classes[i]) + category_offset,
                    "bbox": [float(x0), float(y0),
                             float(x1 - x0), float(y1 - y0)],
                    "score": float(scores[i])})
    return out


def spotting_json_to_coco(results: Sequence[Dict]) -> List[Dict]:
    """OmniParser spotting JSON entries ({"image_id", "polys" | "bbox",
    "score"}) → coco_map detection dicts (category 1 = text)."""
    out = []
    for r in results:
        if "bbox" in r:
            x, y, w, h = r["bbox"]
        else:
            p = np.asarray(r["polys"], np.float64).reshape(-1, 2)
            x, y = p[:, 0].min(), p[:, 1].min()
            w, h = p[:, 0].max() - x, p[:, 1].max() - y
        out.append({"image_id": r["image_id"], "category_id": 1,
                    "bbox": [float(x), float(y), float(w), float(h)],
                    "score": float(r.get("score", 1.0))})
    return out
