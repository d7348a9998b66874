"""Spotting and VIE output assembly and scoring on the host (port of
`advancedliteratemachinery_tpu/eval/spotting_eval.py`; reference OmniParser
engine/val.py:70 `decode_pred_seq` and transformer.py:143-215
`decode_vie_pt_poly_rec_seq`): bins to pixels, strings and confidences, in
numpy, from the fixed-shape dicts of `OmniParser.infer_spotting` and
`infer_vie`, as tensors or arrays; the ICDAR-style spotting F-score on
`ops/nms.py`'s quad IoU; and LISTER's multi-run confidence ensemble
(multi_size_ensemble.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.codecs.coords import CoordSeqVocab
from advancedliteratemachinery_tpu_torch.ops.nms import quad_iou


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)


def decode_spotting_outputs(outputs: Dict, vocab: CoordSeqVocab,
                            image_id: str, orig_size) -> List[Dict]:
    """outputs: the fixed-shape dict from OmniParser.infer_spotting
    (points [1,N,2] bin tokens, instance_valid [1,N], polygons [1,N,L],
    rec_tokens [1,N,Lr], rec_probs [1,N,Lr]) → list of result dicts
    {image_id, pts, score, polys, rec}: the point in pixels, the geometric
    mean of the first len(text) character probabilities, the polygon in
    pixels and the string."""
    h, w = orig_size
    nb = vocab.num_bins
    results = []
    valid = _host(outputs["instance_valid"][0])
    points = _host(outputs["points"][0]).astype(np.float64)
    polys = _host(outputs["polygons"][0]).astype(np.float64)
    recs = _host(outputs["rec_tokens"][0])
    probs = _host(outputs["rec_probs"][0]).astype(np.float64)
    for i in range(len(valid)):
        if not valid[i]:
            continue
        px = points[i, 0] / nb * w
        py = points[i, 1] / nb * h
        poly = polys[i].reshape(-1, 2) / nb * [w, h]
        text = vocab.decode_text(recs[i])
        n_chars = max(len(text), 1)
        conf = float(np.prod(probs[i][:n_chars]) ** (1.0 / n_chars))
        results.append({
            "image_id": image_id,
            "pts": [[float(px), float(py)]],
            "score": conf,
            "polys": poly.tolist(),
            "rec": text,
        })
    return results


def confidence_ensemble(predictions: Sequence[Sequence[str]],
                        confidences: Sequence[Sequence[float]]) -> List[str]:
    """Per sample, pick the prediction from the run with the highest
    confidence (LISTER multi_size_ensemble.py; the first run on ties).
    predictions[r][i] = run r, sample i."""
    n_runs = len(predictions)
    return [predictions[max(range(n_runs), key=lambda r: confidences[r][i])][i]
            for i in range(len(predictions[0]))]


def _quads(items) -> np.ndarray:
    if not items:
        return np.zeros((0, 4, 2), np.float32)
    return np.stack([np.asarray(it["polys"], np.float32).reshape(4, 2)
                     for it in items])


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[A, 4, 2] x [B, 4, 2] quads → [A, B] IoU (float32, on the CPU)."""
    return quad_iou(torch.from_numpy(a)[:, None],
                    torch.from_numpy(b)[None]).numpy()


def spotting_fscore(predictions, ground_truths, iou_thr: float = 0.5,
                    e2e: bool = False, case_sensitive: bool = False):
    """ICDAR/Total-Text-style spotting evaluation: greedy one-to-one
    quad-IoU matching at `iou_thr`; with `e2e` a match additionally
    requires transcription equality (the protocol behind OmniParser's
    Total-Text numbers — engine/val.py writes the prediction JSON this
    consumes).

    predictions / ground_truths: per-image dicts keyed by image id →
    list of {"polys": [4, 2] or flat [8] quad, "text"?: str}. GT entries
    with "ignore": True (ICDAR '###' don't-care regions) neither count as
    recall targets nor penalize matched detections. Pairs are taken best
    IoU first in NumPy's `argsort(-iou, axis=None)` order, as the JAX
    function takes them.

    → {"precision", "recall", "hmean", "matched", "num_det", "num_gt"}.
    """
    def norm(s):
        s = s or ""
        return s if case_sensitive else s.lower()

    matched = num_det = num_gt = 0
    for img_id, gts in ground_truths.items():
        preds = predictions.get(img_id, [])
        care = [g for g in gts if not g.get("ignore", False)]
        ignore = [g for g in gts if g.get("ignore", False)]
        num_gt += len(care)
        pq = _quads(preds)
        if len(pq) == 0:
            continue
        # drop detections inside don't-care regions before counting
        if ignore:
            keep = _iou(pq, _quads(ignore)).max(axis=1) < iou_thr
            preds = [p for p, k in zip(preds, keep) if k]
            pq = pq[keep]
        num_det += len(pq)
        if not care or len(pq) == 0:
            continue
        iou = _iou(pq, _quads(care))
        order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None),
                                           iou.shape))[0]
        used_pred, taken = set(), set()
        for pi, gi in order:
            if iou[pi, gi] < iou_thr:
                break
            if pi in used_pred or gi in taken:
                continue
            if e2e and norm(preds[pi].get("text")) != norm(
                    care[gi].get("text")):
                continue
            used_pred.add(int(pi))
            taken.add(int(gi))
            matched += 1
    precision = matched / num_det if num_det else 0.0
    recall = matched / num_gt if num_gt else 0.0
    hmean = (2 * precision * recall / (precision + recall)
             if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "hmean": hmean,
            "matched": matched, "num_det": num_det, "num_gt": num_gt}


def decode_vie_outputs(outputs: Dict, vocab: CoordSeqVocab,
                       class_names: Sequence[str], orig_size) -> List[Dict]:
    """outputs: the fixed-shape dict from OmniParser.infer_vie → list of
    entity dicts: per class token, the text of its point, the class name,
    the class-token confidence and the axis-aligned box from the polygon's
    extremes. The period-3 pt masking makes every entity single-point; the
    text is joined with ' ' as the reference joins several crops."""
    h, w = orig_size
    nb = vocab.num_bins
    base = vocab.vie_class_base
    valid = _host(outputs["instance_valid"][0])
    polys = _host(outputs["polygons"][0]).astype(np.float64)
    recs = _host(outputs["rec_tokens"][0])
    classes = _host(outputs["classes"][0])
    class_probs = _host(outputs["class_probs"][0]).astype(np.float64)

    results = []
    for i in range(len(valid)):
        if not valid[i]:
            continue
        poly = polys[i].reshape(-1, 2)
        rect = [float(poly[:, 0].min() / nb * w),
                float(poly[:, 1].min() / nb * h),
                float(poly[:, 0].max() / nb * w),
                float(poly[:, 1].max() / nb * h)]
        ci = int(classes[i]) - base
        name = class_names[ci] if 0 <= ci < len(class_names) else str(ci)
        results.append({
            "text": " ".join([vocab.decode_text(recs[i])]),
            "class": name,
            "score": float(class_probs[i]),
            "rects": [rect],
        })
    return results
