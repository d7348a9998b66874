"""Document pipelines: module composition + assembly (port of
`advancedliteratemachinery_tpu/pipelines/document.py`; reference
Applications/DocXChain/pipelines/: general_text_reading.py:12,
table_parsing.py, document_structurization.py:15 with `_assemble` :63,
and DocXLayout wrapper.py:95's reading order).

The modules run on the device; the assembly stays on the host in NumPy
and Python, as in the JAX package, down to Python's `round` (half to
even) in the reading-order key and the region polygons.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.pipelines.modules import (
    LayoutAnalysis, TableStructureRecognition, TextDetection,
    TextRecognition, crop_image, order_point)


def _center(poly) -> np.ndarray:
    return np.asarray(poly, np.float32).reshape(4, 2).mean(axis=0)


def _point_in_rect(pt, poly) -> bool:
    q = np.asarray(poly, np.float32).reshape(4, 2)
    return (q[:, 0].min() <= pt[0] <= q[:, 0].max()
            and q[:, 1].min() <= pt[1] <= q[:, 1].max())


def sort_reading_order(items: List[Dict], key: str = "region_poly"
                       ) -> List[Dict]:
    """Top-to-bottom, left-to-right ordering (DocXLayout wrapper.py:95)."""
    def k(it):
        c = _center(it[key])
        return (round(c[1] / 16.0), c[0])

    return sorted(items, key=k)


class GeneralTextReading:
    """det → rec → text instances (general_text_reading.py:12)."""

    def __init__(self, detection: TextDetection,
                 recognition: TextRecognition):
        self.detection = detection
        self.recognition = recognition

    def __call__(self, image) -> Dict:
        det = self.detection(image)
        rec = self.recognition(image, det)
        instances = [
            {"poly": det["polygons"][i].tolist(), "text": rec["texts"][i],
             "confidence": rec["confidences"][i],
             "det_score": float(det["scores"][i])}
            for i in range(len(rec["texts"]))
        ]
        return {"instances": instances}


class DocumentStructurization:
    """layout → det → rec → assemble (document_structurization.py:15).
    `device` is where an equation region is cropped for
    `formula_recognition` (the GPU unless `device="cpu"`)."""

    def __init__(self, layout: LayoutAnalysis, detection: TextDetection,
                 recognition: TextRecognition, formula_recognition=None,
                 device: Union[str, torch.device, None] = None):
        self.layout = layout
        self.detection = detection
        self.recognition = recognition
        self.formula_recognition = formula_recognition
        self.device = device

    def __call__(self, image) -> List[Dict]:
        la = self.layout(image)
        det = self.detection(image)
        rec = self.recognition(image, det)
        return self._assemble(image, la, det, rec)

    def _assemble(self, image, la_result, det_result, rec_result
                  ) -> List[Dict]:
        """Assign each text line to the layout region containing its
        center (document_structurization.py:63)."""
        output = []
        for det_info in la_result["layout_dets"]:
            region = {
                "category_index": det_info["category_id"],
                "category_name": self.layout.mapping(det_info["category_id"]),
                "region_poly": [round(v) for v in det_info["poly"]],
                "text_list": [],
            }
            if (region["category_name"] == "equation"
                    and self.formula_recognition is not None):
                pts = order_point(region["region_poly"])
                crop = crop_image(image, pts, self.device)
                region["text_list"].append(
                    {"poly": region["region_poly"],
                     "content": self.formula_recognition(crop)})
            else:
                for i, poly in enumerate(det_result["polygons"]):
                    if _point_in_rect(_center(poly), region["region_poly"]):
                        region["text_list"].append(
                            {"poly": poly.tolist(),
                             "content": rec_result["texts"][i]})
            output.append(region)
        return sort_reading_order(output)


class TableParsing:
    """table structure + per-cell text (table_parsing.py): detect cells and
    their logical coordinates, fill each cell with the text lines whose
    centers fall inside it."""

    def __init__(self, table: TableStructureRecognition,
                 detection: TextDetection, recognition: TextRecognition):
        self.table = table
        self.detection = detection
        self.recognition = recognition

    def __call__(self, image) -> Dict:
        tsr = self.table(image)
        det = self.detection(image)
        rec = self.recognition(image, det)
        cells = []
        for ci, cell_poly in enumerate(tsr["polygons"]):
            content = [rec["texts"][i]
                       for i, poly in enumerate(det["polygons"])
                       if _point_in_rect(_center(poly), cell_poly)]
            cells.append({
                "poly": np.asarray(cell_poly).tolist(),
                "logi_coord": tsr["logi_coords"][ci].tolist(),
                "content": " ".join(content),
            })
        return {"cells": cells, "html": cells_to_html(cells)}


def cells_to_html(cells: List[Dict]) -> str:
    """Logical coords → HTML table (row/col spans from start/end
    coords)."""
    if not cells:
        return "<table></table>"
    max_row = max(c["logi_coord"][1] for c in cells)
    rows: List[List[Dict]] = [[] for _ in range(max_row + 1)]
    for c in cells:
        rs, re_, cs, ce = c["logi_coord"]
        rows[min(rs, max_row)].append(c)
    html = ["<table>"]
    for row in rows:
        html.append("<tr>")
        for c in sorted(row, key=lambda x: x["logi_coord"][2]):
            rs, re_, cs, ce = c["logi_coord"]
            attrs = ""
            if re_ > rs:
                attrs += f' rowspan="{re_ - rs + 1}"'
            if ce > cs:
                attrs += f' colspan="{ce - cs + 1}"'
            html.append(f"<td{attrs}>{c['content']}</td>")
        html.append("</tr>")
    html.append("</table>")
    return "".join(html)


def convert_document(path: str, structurizer, dpi: int = 150
                     ) -> List[Dict]:
    """Whole-document conversion: every page of an image or PDF file
    through a DocumentStructurization pipeline → list of per-page results
    (reference example.py:164 whole_pdf_conversion_example)."""
    from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
        load_document)

    return [structurizer(page) for page in load_document(path, dpi=dpi)]
