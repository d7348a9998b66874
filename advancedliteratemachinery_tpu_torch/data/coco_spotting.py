"""COCO-format text-spotting annotations with Bezier outlines (port of
`advancedliteratemachinery_tpu/data/coco_spotting.py`, its dataset and
Bezier helpers; reference OCR/OmniParser/dataset/text_spotting.py:11).

Each annotation carries `bezier_pts`: 16 floats, two cubic Beziers of 4
control points, the top curve left to right and the bottom curve right to
left, and `rec`, the tokenized content. The point prompt of an instance is
the midpoint of the two curves' midpoints (text_spotting.py:20
`sample_pts`). The DB detector's batches (`engine/batches.py`
`db_batches`) take each instance's polygon from its curves. OmniParser's
sequence builders come with OmniParser training.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np


def sample_bezier_curve(ctrl: np.ndarray, n: int = 10,
                        mid_point: bool = False) -> np.ndarray:
    """A cubic Bezier of control points ctrl [4, 2] sampled at n points
    evenly spaced in t → [n, 2] float64, or its t = 0.5 point → [2]."""
    t = np.asarray([0.5]) if mid_point else np.linspace(0, 1, n)
    c = np.asarray(ctrl, np.float64)
    pts = ((1 - t) ** 3)[:, None] * c[0] \
        + (3 * (1 - t) ** 2 * t)[:, None] * c[1] \
        + (3 * (1 - t) * t ** 2)[:, None] * c[2] \
        + (t ** 3)[:, None] * c[3]
    return pts[0] if mid_point else pts


def bezier_center_points(bezier_pts: np.ndarray) -> np.ndarray:
    """[N, 16] → [N, 2] centre points: the mean of the two curves'
    midpoints (text_spotting.py:20)."""
    out = []
    for bp in np.asarray(bezier_pts, np.float64).reshape(-1, 16):
        b = bp.reshape(8, 2)
        m1 = sample_bezier_curve(b[:4], mid_point=True)
        m2 = sample_bezier_curve(b[4:], mid_point=True)
        out.append((m1 + m2) / 2.0)
    return np.asarray(out) if out else np.zeros((0, 2))


def bezier_polygon(bezier_pts: np.ndarray,
                   pts_per_side: int = 8) -> np.ndarray:
    """[16] → polygon [2·pts_per_side, 2]: the top curve's samples, then
    the bottom curve's (which runs right to left)."""
    b = np.asarray(bezier_pts, np.float64).reshape(8, 2)
    top = sample_bezier_curve(b[:4], n=pts_per_side)
    bottom = sample_bezier_curve(b[4:], n=pts_per_side)
    return np.concatenate([top, bottom], axis=0)


class CocoSpottingDataset:
    """A COCO json of text-spotting annotations (no pycocotools): images
    by id, their annotations without `iscrowd`. Item i → the image's
    file name, folder and (height, width), its `bezier_pts` [N, 16]
    float32, centre points [N, 2] and `rec` token rows [N, rec_length]
    int64, cut to `rec_length`."""

    def __init__(self, image_folder: str, anno_file: str,
                 rec_length: int = 25):
        self.image_folder = image_folder
        self.rec_length = rec_length
        with open(anno_file) as f:
            coco = json.load(f)
        self.images = {img["id"]: img for img in coco["images"]}
        self.anns_by_image: Dict[int, List[dict]] = {}
        for ann in coco["annotations"]:
            if ann.get("iscrowd", 0):
                continue
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(self.images)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict:
        img_id = self.ids[idx]
        info = self.images[img_id]
        anns = self.anns_by_image.get(img_id, [])
        bezier = np.asarray([a["bezier_pts"] for a in anns],
                            np.float32).reshape(-1, 16)
        recs = np.asarray([a["rec"][: self.rec_length] for a in anns],
                          np.int64).reshape(-1, self.rec_length) \
            if anns else np.zeros((0, self.rec_length), np.int64)
        return {
            "image_id": img_id,
            "file_name": info["file_name"],
            "image_folder": self.image_folder,
            "orig_size": (info["height"], info["width"]),
            "bezier_pts": bezier,
            "center_pts": bezier_center_points(bezier),
            "recog": recs,
        }
