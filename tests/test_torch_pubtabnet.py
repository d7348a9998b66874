"""The port's `data/pubtabnet.py` against the JAX module, on the CPU, with
no model: the class band (all 800 tokens and the refusal outside it),
seeded PubTabNet structures (atomic and split `<td` attribute tokens,
spans past TABLE_MAX_SPAN, header rows, empty cells, inline tags and
characters HTML escapes), the HTML builders, the triplet walk, and
`decode_table_outputs` on seeded `infer_vie`-shaped outputs with 800
table classes. `PubTabNetDataset` reads the page size from the file
header: equal to the JAX dataset (which opens the page with PIL) on PNG,
baseline and progressive JPEG files, on a page with no file (the bbox
extent), and an unreadable format raises naming it."""

import json

import numpy as np
import pytest
from PIL import Image

from advancedliteratemachinery_tpu.codecs import coords as jcoords
from advancedliteratemachinery_tpu.data import pubtabnet as jptn
from advancedliteratemachinery_tpu_torch.codecs import coords
from advancedliteratemachinery_tpu_torch.data import pubtabnet as ptn
from advancedliteratemachinery_tpu_torch.data.lmdb_writer import image_size

TEXT = "ab<&>1 xyz"
INLINE = ["<b>", "</b>", "<i>", "</i>", "<sup>", "</sup>"]


def vocabs(num_bins=1000):
    kw = dict(num_bins=num_bins, vie_categories=ptn.N_TABLE_CLASSES)
    return coords.CoordSeqVocab(**kw), jcoords.CoordSeqVocab(**kw)


def seeded_record(seed, name="t.png", split="train"):
    """A PubTabNet jsonl record: 1-3 header rows of 1-5 cells, then body
    rows; spans 1-12 (spans past 10 saturate), each cell's `<td` atomic or
    split into attribute tokens; about a fifth of the cells empty (no
    bbox)."""
    rng = np.random.default_rng(seed)
    tokens, cells = [], []
    n_head = int(rng.integers(0, 3))
    n_rows = n_head + int(rng.integers(1, 5))
    for r in range(n_rows):
        if r == 0 and n_head:
            tokens.append("<thead>")
        if r == n_head:
            tokens.append("<tbody>")
        tokens.append("<tr>")
        for _ in range(int(rng.integers(1, 6))):
            spans = {k: int(rng.choice([1, 1, 1, 2, 3, 12]))
                     for k in ("colspan", "rowspan")}
            attrs = [f' {k}="{n}"' for k, n in spans.items() if n > 1]
            if attrs or rng.random() < 0.2:
                tokens += ["<td"] + attrs + [">", "</td>"]
            else:
                tokens += ["<td>", "</td>"]
            if rng.random() < 0.2:
                cells.append({"tokens": []})
                continue
            text = [TEXT[i] for i in rng.integers(0, len(TEXT),
                                                  rng.integers(1, 8))]
            if rng.random() < 0.3:
                text = [INLINE[0]] + text + [INLINE[1]]
            x0, y0 = rng.uniform(0, 300, 2)
            w, h = rng.uniform(5, 80, 2)
            cells.append({"tokens": text,
                          "bbox": [float(x0), float(y0), float(x0 + w),
                                   float(y0 + h)]})
        tokens.append("</tr>")
        if r == n_head - 1:
            tokens.append("</thead>")
    tokens.append("</tbody>")
    return {"filename": name, "split": split,
            "html": {"structure": {"tokens": tokens}, "cells": cells}}


def test_class_band_matches_jax():
    tv, jv = vocabs()
    assert ptn.N_TABLE_CLASSES == jptn.N_TABLE_CLASSES == 800
    assert ptn.TABLE_MAX_SPAN == jptn.TABLE_MAX_SPAN
    for tok in range(tv.vie_class_base,
                     tv.vie_class_base + ptn.N_TABLE_CLASSES):
        st = ptn.decode_table_class(tv, tok)
        assert st == jptn.decode_table_class(jv, tok)
        assert ptn.table_class_token(tv, **st) == tok
    for bits in [(1, 0, 1, 0, 3), (0, 1, 0, 14, 1), (1, 1, 1, 10, 11)]:
        assert (ptn.table_class_token(tv, *bits)
                == jptn.table_class_token(jv, *bits))
    for tok in (tv.vie_class_base - 1, tv.num_classes):
        with pytest.raises(ValueError, match="outside the table class band"):
            ptn.decode_table_class(tv, tok)


@pytest.mark.parametrize("seed", range(6))
def test_structures_and_html_match_jax(seed):
    rec = seeded_record(seed)
    toks = rec["html"]["structure"]["tokens"]
    cells = ptn.parse_structure_tokens(toks)
    assert cells == jptn.parse_structure_tokens(toks)
    assert len(cells) == len(rec["html"]["cells"])
    texts = [ptn.cell_text(c["tokens"]) for c in rec["html"]["cells"]]
    assert texts == [jptn.cell_text(c["tokens"])
                     for c in rec["html"]["cells"]]
    for contents in (None, texts):
        assert (ptn.table_html(cells, contents)
                == jptn.table_html(cells, contents))
    html = ptn.gt_table_html(rec)
    assert html == jptn.gt_table_html(rec)
    assert html.startswith("<table>") and "<td" in html
    if any("<" in t for t in texts):
        assert "&lt;" in html


def write_pages(tmp_path):
    """The same seeded table as PNG, baseline JPEG and progressive JPEG
    (odd sizes), and a record whose file is missing; the jsonl of all."""
    rng = np.random.default_rng(7)
    recs = []
    for i, (name, kw) in enumerate([
            ("p.png", {}), ("b.jpg", {"quality": 90}),
            ("q.jpg", {"quality": 80, "progressive": True}),
            ("gone.png", None)]):
        h, w = 123 + 17 * i, 311 - 29 * i
        if kw is not None:
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                tmp_path / name, **kw)
        recs.append(seeded_record(10 + i, name,
                                  "val" if i % 2 else "train"))
    data = tmp_path / "pubtabnet.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in recs) + "\n")
    return data


def test_dataset_matches_jax_and_reads_sizes_from_headers(tmp_path):
    data = write_pages(tmp_path)
    tv, jv = vocabs(num_bins=50)
    chars = jcoords.PRINTABLE_CHARS
    got = ptn.PubTabNetDataset(str(data), str(tmp_path), chars=chars)
    want = jptn.PubTabNetDataset(str(data), str(tmp_path), chars=chars)
    assert len(got) == len(want) == 4
    for i in range(4):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        assert g["orig_size"] == w["orig_size"]
        assert g["gt_html"] == w["gt_html"]
        for gc, wc in zip(g["cells"], w["cells"]):
            np.testing.assert_array_equal(gc.pop("quad"), wc.pop("quad"))
            assert gc == wc
        np.testing.assert_array_equal(ptn.build_table_pt_sequence(g, tv),
                                      jptn.build_table_pt_sequence(w, jv))
        np.testing.assert_array_equal(
            ptn.build_table_pt_sequence(g, tv, max_tokens=7),
            jptn.build_table_pt_sequence(w, jv, max_tokens=7))
    # the files' own sizes, and the bbox extent where there is no file
    assert [got[i]["orig_size"] for i in range(3)] == [
        (123, 311), (140, 282), (157, 253)]
    bboxes = [c["bbox"] for c in got.samples[3]["html"]["cells"]
              if "bbox" in c]
    assert got[3]["orig_size"] == (
        int(max(b[3] for b in bboxes)) + 1, int(max(b[2] for b in bboxes))
        + 1)
    split = ptn.PubTabNetDataset(str(data), str(tmp_path), chars=chars,
                                 split="val", max_samples=1)
    assert [s["filename"] for s in split.samples] == ["b.jpg"]


def test_dataset_names_an_unread_format(tmp_path):
    """A WebP page is named; BMP, GIF and TIFF pages (the TIFF turned by
    its Orientation), unread before their decoders were ported, give
    PIL's size."""
    rec = seeded_record(3, "t.webp")
    (tmp_path / "t.webp").write_bytes(b"RIFF\0\0\0\0WEBPVP8 " + bytes(20))
    data = tmp_path / "d.jsonl"
    data.write_text(json.dumps(rec) + "\n")
    ds = ptn.PubTabNetDataset(str(data), str(tmp_path), chars="ab")
    with pytest.raises(ValueError, match="WebP"):
        ds[0]
    page = Image.fromarray(np.zeros((9, 13, 3), np.uint8))
    for name, kw in (("t.bmp", {}), ("t.gif", {}),
                     ("t.tif", {"tiffinfo": {274: 6}})):
        page.save(tmp_path / name, **kw)
        with Image.open(tmp_path / name) as im:
            want = im.size[::-1]
        assert image_size((tmp_path / name).read_bytes()) == want, name


def seeded_outputs(v, seed, n=128, length=6):
    """`infer_vie`-shaped outputs with table classes: a valid prefix of
    instances, points in bins, classes anywhere in the band, and rec rows
    of characters, EOS and recog-pad."""
    rng = np.random.default_rng(seed)
    n_valid = int(rng.integers(1, 20))
    valid = np.arange(n) < n_valid
    rec = rng.integers(v.num_bins, v.num_bins + v.num_char_classes,
                       (n, length))
    rec[rng.random((n, length)) < 0.15] = v.rec_eos_index
    rec[rng.random((n, length)) < 0.05] = v.recog_pad_index
    return {"instance_valid": valid[None],
            "points": rng.integers(0, v.num_bins, (1, n, 2)),
            "classes": rng.integers(v.vie_class_base, v.num_classes,
                                    (1, n)),
            "rec_tokens": rec[None] if seed % 2 else rec}


@pytest.mark.parametrize("seed", range(4))
def test_decode_table_outputs_matches_jax(seed):
    tv, jv = vocabs()
    out = seeded_outputs(tv, seed)
    got = ptn.decode_table_outputs(out, tv, (480, 640))
    want = jptn.decode_table_outputs(out, jv, (480, 640))
    assert got == want
    assert got["cells"][0]["row_start"] and "<td" in got["html"]
