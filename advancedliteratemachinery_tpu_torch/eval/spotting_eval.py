"""Spotting and VIE output assembly on the host (port of
`decode_spotting_outputs` and `decode_vie_outputs` from
`advancedliteratemachinery_tpu/eval/spotting_eval.py`; reference OmniParser
engine/val.py:70 `decode_pred_seq` and transformer.py:143-215
`decode_vie_pt_poly_rec_seq`): bins to pixels, strings and confidences, in
numpy. Takes the fixed-shape dicts of `OmniParser.infer_spotting` and
`infer_vie`, as tensors or arrays.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from advancedliteratemachinery_tpu_torch.codecs.coords import CoordSeqVocab


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
