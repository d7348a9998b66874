"""Pipeline modules: callables over page images, composable into pipelines
(port of `advancedliteratemachinery_tpu/pipelines/modules.py`; reference
Applications/DocXChain/modules/).

Each module's `__call__(image)` (or `__call__(image, detections)`) returns
the JAX module's plain result dict, with NumPy arrays in it. Pages come in
as uint8 [H, W, 3] NumPy arrays (or tensors). The injected callables are
the port's device functions (`models/db.py` `make_db_detect_fn`,
`models/docxlayout.py` `make_layout_predict_fn`, `models/lore.py`
`make_table_predict_fn`, an engine's `recognize`) or any callable of the
same shape. `TextRecognition` crops on the device: the page goes up once,
every quad is rectified and resized there in one batch (`ops/image.py`
`crop_quads_u8`, cv2's arithmetic to within one uint8 level), and the
recognizer receives uint8 tensors on that device, zero-padded to its
batch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.registry import PIPELINE_MODULES
from advancedliteratemachinery_tpu_torch.ops.image import (
    as_device_tensor, crop_quads_u8, perspective_maps, warp_perspective_u8)


def order_point(coor: Sequence[float]) -> np.ndarray:
    """Sort 4 points clockwise from top-left (text_recognition.py:84)."""
    arr = np.asarray(coor, np.float32).reshape(4, 2)
    centroid = arr.mean(axis=0)
    theta = np.arctan2(arr[:, 1] - centroid[1], arr[:, 0] - centroid[0])
    arr = arr[np.argsort(theta)]
    # rotate so the first point is the top-left-most
    start = int(np.argmin(arr[:, 0] + arr[:, 1]))
    return np.roll(arr, -start, axis=0)


def crop_image(image, position,
               device: Union[str, torch.device, None] = None):
    """Perspective-rectify a quad region to its own size
    (text_recognition.py:100): `cv2.getPerspectiveTransform` +
    `cv2.warpPerspective`, on `device` (the GPU unless `device="cpu"`; a
    tensor's own device when `image` is one). A NumPy page gives a NumPy
    crop, a tensor a tensor."""
    dev = image.device if isinstance(image, torch.Tensor) else \
        resolve_device(device)
    sizes, maps = perspective_maps(np.asarray(position, np.float32)[None])
    w, h = (int(v) for v in sizes[0])
    crop = warp_perspective_u8(as_device_tensor(image, dev),
                               torch.from_numpy(maps), (h, w))[0]
    return crop if isinstance(image, torch.Tensor) else crop.cpu().numpy()


@PIPELINE_MODULES.register("text_detection")
class TextDetection:
    """Wraps a detector: image → {'polygons': [N, 8], 'scores': [N]}.

    detect_fn: uint8 [H, W, 3] → (quads [N, 8], scores [N]) in page
    pixels; `models/db.py` `make_db_detect_fn` or any custom fn."""

    def __init__(self, detect_fn: Callable[[np.ndarray], tuple]):
        self.detect_fn = detect_fn

    def __call__(self, image) -> Dict[str, np.ndarray]:
        quads, scores = self.detect_fn(image)
        return {"polygons": np.asarray(quads, np.float32),
                "scores": np.asarray(scores, np.float32)}


@PIPELINE_MODULES.register("text_recognition")
class TextRecognition:
    """Crop each detected quad, batch-recognize on the device
    (text_recognition.py:35).

    recognize_fn: uint8 crops [batch_size, 32, 128, 3] (a tensor on
    `device`, zero rows padding the last batch) → list of (text, conf,
    head); an engine's `recognize` (`engine/infer.py`) takes it as it
    is."""

    def __init__(self, recognize_fn: Callable, crop_hw=(32, 128),
                 batch_size: int = 64,
                 device: Union[str, torch.device, None] = None):
        self.recognize_fn = recognize_fn
        self.crop_hw = tuple(crop_hw)
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def __call__(self, image, detections: Dict) -> Dict:
        polys = detections["polygons"]
        quads = np.asarray([order_point(poly) for poly in polys],
                           np.float32).reshape(-1, 4, 2)
        page = as_device_tensor(image, self.device)
        crops = crop_quads_u8(page, quads, self.crop_hw)
        texts: List[str] = []
        confs: List[float] = []
        for i in range(0, len(crops), self.batch_size):
            chunk = crops[i:i + self.batch_size]
            batch = torch.zeros((self.batch_size, *self.crop_hw,
                                 crops.shape[-1]), dtype=torch.uint8,
                                device=self.device)
            batch[:len(chunk)] = chunk
            results = self.recognize_fn(batch)
            for text, conf, _head in results[:len(chunk)]:
                texts.append(text)
                confs.append(conf)
        return {"texts": texts, "confidences": confs, "polygons": polys}


@PIPELINE_MODULES.register("layout_analysis")
class LayoutAnalysis:
    """Layout regions: image → {'layout_dets': [{'category_id', 'poly',
    'score'}]} (layout_analysis.py:49; DocXLayout main.py:85 output
    shape).

    predict_fn: image → (quads [N, 8], scores [N], category_ids [N]);
    `models/docxlayout.py` `make_layout_predict_fn` or any custom fn."""

    # DocXLayout's 13 coarse categories (DocXLayout/main.py mapping)
    CATEGORIES = ["title", "figure", "plain text", "header", "page number",
                  "footnote", "footer", "table", "table caption",
                  "figure caption", "equation", "full column", "sub column"]

    def __init__(self, predict_fn: Callable[[np.ndarray], tuple]):
        self.predict_fn = predict_fn

    def mapping(self, category_index: int) -> str:
        if 0 <= category_index < len(self.CATEGORIES):
            return self.CATEGORIES[category_index]
        return f"category_{category_index}"

    def __call__(self, image) -> Dict:
        quads, scores, cats = self.predict_fn(image)
        dets = [{"category_id": int(c), "poly": np.asarray(q).tolist(),
                 "score": float(s)}
                for q, s, c in zip(quads, scores, cats)]
        return {"layout_dets": dets}


@PIPELINE_MODULES.register("table_structure_recognition")
class TableStructureRecognition:
    """Table cells + logical coordinates: image → {'polygons': [N, 8],
    'logi_coords': [N, 4]} (table_structure_recognition.py; LORE output;
    `models/lore.py` `make_table_predict_fn`)."""

    def __init__(self, predict_fn: Callable[[np.ndarray], Dict]):
        self.predict_fn = predict_fn

    def __call__(self, image) -> Dict:
        out = self.predict_fn(image)
        return {"polygons": np.asarray(out["polygons"], np.float32),
                "logi_coords": np.asarray(out["logi_coords"], np.int32)}


class FormulaRecognition:
    """Math formula → LaTeX on formula regions (reference
    modules/formula_recognition.py:11), from a callable `latex_fn(crop_u8)
    -> str`: `FormulaRecognition.from_onnx(model_dir)` loads a
    LaTeX-OCR-format ONNX trio through `pipelines/latex_ocr.py` (needs
    onnxruntime; the JAX module's error without it), or inject any
    callable (for example an image-to-sequence model). The region crops
    are rectified on `device`. `__call__(image)` returns {'latex': str};
    `on_regions(image, polygons)` maps each region's crop."""

    def __init__(self, latex_fn: Callable[[np.ndarray], str],
                 device: Union[str, torch.device, None] = None):
        self.latex_fn = latex_fn
        self.device = device

    @classmethod
    def from_onnx(cls, model_dir: str,
                  device: Union[str, torch.device, None] = None,
                  **kw) -> "FormulaRecognition":
        from advancedliteratemachinery_tpu_torch.pipelines.latex_ocr import (
            LatexOcrOnnx)
        return cls(LatexOcrOnnx.from_dir(model_dir, **kw), device=device)

    def __call__(self, image) -> Dict:
        return {"latex": self.latex_fn(np.asarray(image))}

    def on_regions(self, image, polygons) -> List[Dict]:
        out = []
        for poly in np.asarray(polygons, np.float32).reshape(-1, 4, 2):
            crop = crop_image(image, order_point(poly.reshape(-1)),
                              self.device)
            out.append({"polygon": poly.reshape(-1),
                        "latex": self.latex_fn(crop)})
        return out
