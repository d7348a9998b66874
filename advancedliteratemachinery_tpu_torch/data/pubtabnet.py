"""PubTabNet table-recognition data path for OmniParser (the port's own
copy of `advancedliteratemachinery_tpu/data/pubtabnet.py`; NumPy and the
standard library only).

Parity target: OmniParser's third task, table recognition
(reference OCR/OmniParser/README.md — the paper reports PubTabNet and
iFLYTAB S-TEDS/TEDS numbers, but the released repo ships NO table
dataset code: dataset/ holds only text_spotting.py + cord.py/sroie.py).
This module supplies the missing surface in the unified center-point
scheme the paper describes (structured point sequence + structural
tokens), mapped onto the SAME strict-triplet machinery the VIE task
already uses (reference transformer.py:116-124 period-3 masking):

  per table cell, in HTML reading order:  (x_bin, y_bin, class_token)

where the class token packs the cell's STRUCTURE —
(header, row_start, empty, colspan∈1..MAX_SPAN, rowspan∈1..MAX_SPAN) —
into one id in the vocab's trailing category band
(codecs/coords.py vie_class_base, reference transformer.py:56
index2class layout). Empty cells (PubTabNet cells with no bbox) emit
bin (0, 0) placeholders; their class token carries the `empty` bit so
reconstruction drops the coords. Because the sequence stays a strict
(coord, coord, class) walk, `OmniParser.infer_vie`'s period-3 decode
masking and the batched per-point polygon/content stages apply to tables
unchanged: one model serves spotting, KIE and TR.

Ground truth: PubTabNet jsonl lines
  {"filename", "split", "html": {"structure": {"tokens": [...]},
   "cells": [{"tokens": [...], "bbox": [x0,y0,x1,y1]}, ...]}}
(cells align 1:1 with <td> occurrences; empty cells lack "bbox").

Evaluation: `decode_table_outputs` rebuilds the <table> HTML
(<thead>/<tbody> restored from the header bits) and `eval.teds.TEDS`
scores it — structure_only=True is the paper's S-TEDS.

The page image's size is read from its file header (the PNG IHDR, the
JPEG frame header of any JPEG process, or the BMP, GIF or TIFF header;
`data/lmdb_writer.py` `image_size`), where the JAX module opens it with
PIL; another format raises a `ValueError` naming it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from advancedliteratemachinery_tpu_torch.data.lmdb_writer import image_size

# Span saturation: PubTabNet spans above MAX_SPAN are clipped (rare —
# the class band stays compact; reconstruction then under-reports that
# span, a documented approximation like the reference's rec_length clip).
TABLE_MAX_SPAN = 10
# (header, row_start, empty) bits x colspan x rowspan
N_TABLE_CLASSES = 2 * 2 * 2 * TABLE_MAX_SPAN * TABLE_MAX_SPAN

_INLINE_TAGS = {"<b>", "</b>", "<i>", "</i>", "<sup>", "</sup>",
                "<sub>", "</sub>", "<underline>", "</underline>",
                "<overline>", "</overline>", "<strike>", "</strike>"}


def table_class_token(vocab, header: bool, row_start: bool, empty: bool,
                      colspan: int, rowspan: int) -> int:
    """Pack cell structure into one category-band token id."""
    cs = min(max(int(colspan), 1), TABLE_MAX_SPAN) - 1
    rs = min(max(int(rowspan), 1), TABLE_MAX_SPAN) - 1
    idx = ((((int(header) * 2 + int(row_start)) * 2 + int(empty))
            * TABLE_MAX_SPAN + cs) * TABLE_MAX_SPAN + rs)
    return vocab.vie_class_base + idx


def decode_table_class(vocab, token: int) -> Dict[str, int]:
    """Inverse of table_class_token."""
    idx = int(token) - vocab.vie_class_base
    if not 0 <= idx < N_TABLE_CLASSES:
        raise ValueError(f"token {token} outside the table class band")
    rs = idx % TABLE_MAX_SPAN
    idx //= TABLE_MAX_SPAN
    cs = idx % TABLE_MAX_SPAN
    idx //= TABLE_MAX_SPAN
    empty = idx % 2
    idx //= 2
    row_start = idx % 2
    header = idx // 2
    return {"header": bool(header), "row_start": bool(row_start),
            "empty": bool(empty), "colspan": cs + 1, "rowspan": rs + 1}


def parse_structure_tokens(tokens: Sequence[str]) -> List[Dict]:
    """PubTabNet structure-token stream → flat cell list in reading
    order: {"header", "row_start", "colspan", "rowspan"}. Accepts both
    the atomic '<td>' form and the split '<td' ' colspan=\"n\"' '>'
    attribute form the official jsonl uses."""
    cells: List[Dict] = []
    in_head = False
    row_open = False
    pending: Optional[Dict] = None
    for tok in tokens:
        t = tok.strip()
        if t == "<thead>":
            in_head = True
        elif t == "</thead>":
            in_head = False
        elif t == "<tr>":
            row_open = True
        elif t in ("<td>", "<td"):
            pending = {"header": in_head, "row_start": row_open,
                       "colspan": 1, "rowspan": 1}
            row_open = False
            if t == "<td>":
                cells.append(pending)
                pending = None
        elif pending is not None:
            if t == ">":
                cells.append(pending)
                pending = None
            else:
                m = re.search(r'(colspan|rowspan)="(\d+)"', t)
                if m:
                    pending[m.group(1)] = int(m.group(2))
    return cells


def cell_text(tokens: Sequence[str]) -> str:
    """Cell token list → plain text (inline style tags dropped, the same
    normalization TEDS' text_content applies)."""
    return "".join(t for t in tokens if t not in _INLINE_TAGS)


def _escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def table_html(cells: Sequence[Dict],
               contents: Optional[Sequence[str]] = None) -> str:
    """Flat cell list (+optional per-cell text) → normalized PubTabNet
    HTML: rows split on row_start, the leading header-rows prefix wrapped
    in <thead>, the rest in <tbody>."""
    rows: List[List[int]] = []
    for i, c in enumerate(cells):
        if c.get("row_start") or not rows:
            rows.append([])
        rows[-1].append(i)

    def render_row(idxs: List[int]) -> str:
        tds = []
        for i in idxs:
            c = cells[i]
            attrs = ""
            if c.get("colspan", 1) > 1:
                attrs += f' colspan="{c["colspan"]}"'
            if c.get("rowspan", 1) > 1:
                attrs += f' rowspan="{c["rowspan"]}"'
            text = ""
            if contents is not None and not c.get("empty"):
                text = _escape(contents[i])
            tds.append(f"<td{attrs}>{text}</td>")
        return "<tr>" + "".join(tds) + "</tr>"

    n_head = 0
    for r in rows:
        if cells[r[0]].get("header"):
            n_head += 1
        else:
            break
    head = "".join(render_row(r) for r in rows[:n_head])
    body = "".join(render_row(r) for r in rows[n_head:])
    out = "<table>"
    if head:
        out += f"<thead>{head}</thead>"
    if body:
        out += f"<tbody>{body}</tbody>"
    return out + "</table>"


def gt_table_html(sample: Dict) -> str:
    """PubTabNet jsonl record → the same normalized HTML dialect
    table_html emits (so reconstruction parity means TEDS == 1)."""
    html = sample["html"]
    cells = parse_structure_tokens(html["structure"]["tokens"])
    texts = [cell_text(c.get("tokens", ())) for c in html["cells"]]
    return table_html(cells, contents=texts)


class PubTabNetDataset:
    """PubTabNet jsonl → OmniParser table-task pages.

    Each page dict carries the keys the batch builder needs (the same
    schema vie_spotting.CordLikeVieDataset yields): orig_size,
    file_name, image_folder, plus the reading-order `cells` list
    ({center, quad, rec, header, row_start, empty, colspan, rowspan})
    and the normalized `gt_html`. Image size comes from the page image;
    when the image is absent (annotation-only fixtures) it falls back
    to the bbox extent so coordinate bins stay well-defined.
    """

    def __init__(self, jsonl_path: str, image_folder: str,
                 chars: str, split: Optional[str] = None,
                 rec_length: int = 25, max_samples: Optional[int] = None):
        self.image_folder = image_folder
        self.chars = chars
        self.rec_length = rec_length
        self.samples: List[Dict] = []
        with open(jsonl_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if split and rec.get("split") != split:
                    continue
                self.samples.append(rec)
                if max_samples and len(self.samples) >= max_samples:
                    break

    def __len__(self) -> int:
        return len(self.samples)

    def _rec_ids(self, text: str) -> List[int]:
        out = []
        for ch in text[: self.rec_length - 1]:
            i = self.chars.find(ch)
            out.append(i if i >= 0 else len(self.chars))
        return out

    def __getitem__(self, idx: int) -> Dict:
        rec = self.samples[idx]
        html = rec["html"]
        structure = parse_structure_tokens(html["structure"]["tokens"])
        raw_cells = html["cells"]
        if len(structure) != len(raw_cells):
            raise ValueError(
                f"{rec.get('filename')}: {len(structure)} <td> tokens vs "
                f"{len(raw_cells)} cells")

        path = os.path.join(self.image_folder, rec.get("filename", ""))
        size: Optional[Tuple[int, int]] = None
        if os.path.exists(path):
            with open(path, "rb") as f:
                size = image_size(f.read())

        cells: List[Dict] = []
        max_x = max_y = 1.0
        for st, rc in zip(structure, raw_cells):
            bbox = rc.get("bbox")
            empty = bbox is None
            text = cell_text(rc.get("tokens", ()))
            if bbox is not None:
                x0, y0, x1, y1 = map(float, bbox)
                max_x, max_y = max(max_x, x1), max(max_y, y1)
                center = ((x0 + x1) / 2.0, (y0 + y1) / 2.0)
                quad = np.asarray([[x0, y0], [x1, y0], [x1, y1], [x0, y1]],
                                  np.float64)
            else:
                center = (0.0, 0.0)
                quad = np.zeros((4, 2), np.float64)
            cells.append({
                "center": center, "quad": quad, "text": text,
                "rec": self._rec_ids(text), "empty": empty,
                "header": st["header"], "row_start": st["row_start"],
                "colspan": st["colspan"], "rowspan": st["rowspan"],
            })
        if size is None:
            size = (int(max_y) + 1, int(max_x) + 1)
        return {
            "file_name": rec.get("filename", ""),
            "image_folder": self.image_folder,
            "orig_size": size,
            "cells": cells,
            "gt_html": table_html(
                structure, contents=[c["text"] for c in cells]),
        }


def build_table_pt_sequence(page: Dict, vocab,
                            max_tokens: Optional[int] = None) -> np.ndarray:
    """Reading-order strict-triplet walk: per cell
    (x_bin, y_bin, class_token). Order is the HTML structural order —
    NOT a geometric (y, x) sort like VIE's sorted_instance_pts — because
    for tables the structure IS the label."""
    h, w = page["orig_size"]
    out: List[int] = []
    for c in page["cells"]:
        if c["empty"]:
            out += [0, 0]
        else:
            out.append(int(vocab.quantize(c["center"][0], w)))
            out.append(int(vocab.quantize(c["center"][1], h)))
        out.append(table_class_token(
            vocab, c["header"], c["row_start"], c["empty"],
            c["colspan"], c["rowspan"]))
    seq = np.asarray(out, np.int64)
    return seq[:max_tokens] if max_tokens else seq


def decode_table_outputs(outputs: Dict[str, np.ndarray], vocab,
                         image_hw: Tuple[int, int]) -> Dict:
    """Host-side detokenization of `OmniParser.infer_vie` outputs run
    with table classes: instance (points, classes, rec_tokens) →
    {"cells": [...], "html": str, "structure_html": str}. The first
    cell is forced row_start (a table always opens a row); empty cells
    contribute no text or coords."""
    h, w = image_hw
    valid = np.asarray(outputs["instance_valid"][0]).astype(bool)
    points = np.asarray(outputs["points"][0])
    classes = np.asarray(outputs["classes"][0])
    rec_tokens = np.asarray(outputs["rec_tokens"])
    if rec_tokens.ndim == 3:                        # [1, N, L] vs [N, L]
        rec_tokens = rec_tokens[0]

    cells: List[Dict] = []
    texts: List[str] = []
    for i in np.nonzero(valid)[0]:
        st = decode_table_class(vocab, classes[i])
        if not cells:
            st["row_start"] = True
        x = float(points[i, 0]) / vocab.num_bins * w
        y = float(points[i, 1]) / vocab.num_bins * h
        text = "" if st["empty"] else vocab.decode_text(rec_tokens[i])
        cells.append({**st, "center": None if st["empty"] else (x, y),
                      "text": text})
        texts.append(text)
    return {
        "cells": cells,
        "html": table_html(cells, contents=texts),
        "structure_html": table_html(cells, contents=None),
    }
