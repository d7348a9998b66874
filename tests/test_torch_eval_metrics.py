"""The port's scoring modules (`eval/ocr_metrics.py`, `tree_edit.py`,
`kie_metrics.py`, `teds.py`, `ccocr_harness.py`, `det_map.py`,
`lore_metrics.py`, `spotting_eval.py` and `ops/nms.py`, with the CLI's
`ccocr-collect`, `ccocr-eval` and `eval-det`) against the JAX package on
the CPU, on inputs made from numpy seeds:

- the pure-Python metrics equal to the JAX ones;
- TEDS and S-TEDS equal to the JAX ones, whose tables lxml (libxml2)
  parses and the port's `html.parser` tree builds: a corpus of
  PubTabNet-style tables (spans, `th`), nested inline tags, omitted end
  tags, entities, comments, two tables, empty and table-less strings and
  LMM-style garbage, then seeded random tag soup;
- the CC-OCR harness: the three evaluator groups, prediction collection
  with the dummy and `import:` models (resume, a failing image), and the
  pipeline on one thread and on four;
- COCO mAP (crowd regions, `max_dets`, empty categories), the LORE cell
  metrics, quad IoU within QUAD_IOU_TOL of the JAX function, the NMS
  functions' keep sets and the spotting F-score.
"""

import contextlib
import io
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from advancedliteratemachinery_tpu import cli as jcli
from advancedliteratemachinery_tpu.eval import ccocr_harness as jh
from advancedliteratemachinery_tpu.eval import det_map as jdet
from advancedliteratemachinery_tpu.eval import kie_metrics as jkie
from advancedliteratemachinery_tpu.eval import lore_metrics as jlore
from advancedliteratemachinery_tpu.eval import ocr_metrics as jocr
from advancedliteratemachinery_tpu.eval import spotting_eval as jspot
from advancedliteratemachinery_tpu.eval import teds as jteds
from advancedliteratemachinery_tpu.eval import tree_edit as jtree
from advancedliteratemachinery_tpu.ops import nms as jnms
from advancedliteratemachinery_tpu_torch import cli as tcli
from advancedliteratemachinery_tpu_torch.eval import ccocr_harness as th
from advancedliteratemachinery_tpu_torch.eval import det_map as tdet
from advancedliteratemachinery_tpu_torch.eval import kie_metrics as tkie
from advancedliteratemachinery_tpu_torch.eval import lore_metrics as tlore
from advancedliteratemachinery_tpu_torch.eval import ocr_metrics as tocr
from advancedliteratemachinery_tpu_torch.eval import spotting_eval as tspot
from advancedliteratemachinery_tpu_torch.eval import teds as tteds
from advancedliteratemachinery_tpu_torch.eval import tree_edit as ttree
from advancedliteratemachinery_tpu_torch.ops import nms as tnms
from test_torch_mgp_str import FAST_COMPILE

torch.set_num_threads(2)

QUAD_IOU_TOL = 1e-5          # float32 clipping in JAX and in torch
# The JAX NMS functions are compiled with FAST_COMPILE, whose quad IoUs are
# bit for bit those of the functions called op by op, as `spotting_fscore`
# calls `quad_iou` (op by op they take 7-9 s a new shape). The default jit
# contracts multiply-adds into FMAs and moves a clipped quad's IoU by up to
# 2.6e-4 (a quad's IoU with itself to 0.99974): the port is held to it
# within that error.
DEFAULT_JIT_QUAD_IOU_TOL = 5e-4


@pytest.fixture(scope="module")
def jax_nms():
    """The JAX NMS functions, each jitted once for the module with
    FAST_COMPILE."""
    return {"quad_iou": jax.jit(jnms.quad_iou,
                                compiler_options=FAST_COMPILE),
            "poly_nms": jax.jit(jnms.poly_nms.__wrapped__,
                                compiler_options=FAST_COMPILE),
            "soft_nms_scores": jax.jit(jnms.soft_nms_scores,
                                       static_argnames=("method",),
                                       compiler_options=FAST_COMPILE),
            "box_nms": jax.jit(jnms.box_nms,
                               compiler_options=FAST_COMPILE),
            "box_iou_matrix": jax.jit(jnms.box_iou_matrix,
                                      compiler_options=FAST_COMPILE)}


def words(rng, n):
    vocab = ["Hello", "world", "foo", "BAR", "a-b", "x1", "###", "***", "的",
             "日本", "42", "w\tz", "end.", ""]
    return " ".join(rng.choice(vocab, n))


def test_ocr_token_metrics_match_jax():
    rng = np.random.default_rng(0)
    gts = {f"im{i}": words(rng, int(rng.integers(0, 9))) for i in range(30)}
    preds = {k: words(rng, int(rng.integers(0, 9))) for k in list(gts)[:25]}
    preds["im3"] = gts["im3"] + "\n" + gts["im3"]
    for kw in ({}, {"word_level": False}, {"alphanum_only": True},
               {"lowercase": False}):
        assert jocr.token_metrics(preds, gts, **kw) == tocr.token_metrics(
            preds, gts, **kw)


def random_tree(mod, rng, depth=0):
    node = mod.Node(str(rng.choice(list("abcd"))))
    if depth < 3:
        node.children = [random_tree(mod, rng, depth + 1)
                         for _ in range(int(rng.integers(0, 4)))]
    return node


def test_tree_edit_distance_matches_jax():
    for seed in range(40):
        pair = []
        for mod in (jtree, ttree):
            rng = np.random.default_rng(seed)
            pair.append((random_tree(mod, rng), random_tree(mod, rng)))
        (ja, jb), (ta, tb) = pair
        assert jtree.tree_edit_distance(ja, jb) == ttree.tree_edit_distance(
            ta, tb)
        assert jtree.tree_size(ja) == ttree.tree_size(ta)


def random_record(rng, depth=0):
    keys = ["menu", "nm", "price", "cnt", "total", "sub", "tax", ""]
    out = {}
    for _ in range(int(rng.integers(0, 4))):
        k = str(rng.choice(keys))
        r = rng.random()
        if r < 0.3 and depth < 2:
            out[k] = [random_record(rng, depth + 1)
                      for _ in range(int(rng.integers(0, 3)))]
        elif r < 0.45 and depth < 2:
            out[k] = random_record(rng, depth + 1)
        elif r < 0.6:
            out[k] = [words(rng, 1), int(rng.integers(0, 9)), None, " "]
        else:
            out[k] = words(rng, int(rng.integers(0, 3)))
    return out


def test_kie_metrics_match_jax():
    rng = np.random.default_rng(1)
    answers = {f"r{i}": random_record(rng) for i in range(25)}
    preds = {k: (v if i % 4 == 0 else random_record(rng))
             for i, (k, v) in enumerate(answers.items())}
    for k in answers:
        assert jkie.normalize_dict(answers[k]) == tkie.normalize_dict(
            answers[k])
        assert jkie.flatten(answers[k]) == tkie.flatten(answers[k])
        assert jkie.ntED(preds[k], answers[k]) == tkie.ntED(preds[k],
                                                            answers[k])
    assert jkie.field_f1(preds, answers) == tkie.field_f1(preds, answers)
    ents = {k: [{"text": words(rng, 1), "class": str(rng.choice(
        ["menu", "total"]))} for _ in range(3)] for k in answers}
    assert jkie.evaluate_vie(ents, answers) == tkie.evaluate_vie(ents,
                                                                 answers)
    tags = ["O", "B-Q", "I-Q", "B-A", "I-A", "I-H"]
    seqs = [[str(t) for t in rng.choice(tags, 12)] for _ in range(20)]
    assert jkie.bio_entity_f1(seqs[:10], seqs[10:]) == tkie.bio_entity_f1(
        seqs[:10], seqs[10:])


TABLES = [
    # PubTabNet-style: thead with th, spans, tbody
    "<table><thead><tr><th>Name</th><th colspan=\"2\">Score</th></tr>"
    "</thead><tbody><tr><td rowspan=\"2\">A</td><td>1</td><td>2</td></tr>"
    "<tr><td>3</td><td>4.5</td></tr></tbody></table>",
    # nested inline tags, entities, a comment, whitespace in cells
    "<table><tr><td><b>Tot</b><i>al</i>&nbsp;&amp; more</td>"
    "<td> <sup>2</sup> <!-- note --> </td></tr></table>",
    # omitted </td> and </tr>, upper case, no tbody
    "<TABLE><TR><TD>a<TD>b<TR><TD colspan=2>c</TABLE>",
    # two tables: the first counts
    "<table><tr><td>first</td></tr></table><table><tr><td>second</td>"
    "</tr></table>",
    # LMM-style answers around a table
    "Here is the table:\n```html\n<table>\n<tr>\n<td>1</td>\n<td>x &lt; y"
    "</td>\n</tr>\n</table>\n```\nHope this helps!",
    "<div><p>Intro<table border=1><caption>T</caption><tr><th>h</th>"
    "</tr><tr><td><span>in</span> cell</tr></table></div>",
    "<table><tr><td>a<p>b<td>c<em>d<td>e</em></table>",
    "", "   ", "no table at all", "<p>only a paragraph</p>",
    "<table></table>", "<tr><td>rows without a table</td></tr>",
    "| a | b |\n|---|---|\n| 1 | 2 |",
    "<table><tr><td>unterminated",
]


def tag_soup(rng):
    tags = ("table thead tbody tfoot tr td th caption b i span p div br "
            "sup em font a html body head").split()
    texts = ["a", "b c", " ", "\n", "\r\n", "&amp;", "&lt;td&gt;", "&nbsp;",
             "&#65;", "1.5", "<", "  z  "]
    out = []
    for _ in range(rng.randint(0, 30)):
        r, tag = rng.random(), rng.choice(tags)
        if r < 0.4:
            attrs = (rng.choice([" colspan=2", ' rowspan="3"', ' colspan=""'])
                     if tag in ("td", "th") and rng.random() < 0.4 else "")
            out.append(f"<{tag}{attrs}{'/' if rng.random() < 0.05 else ''}>")
        elif r < 0.65:
            out.append(f"</{tag}>")
        elif r < 0.95:
            out.append(rng.choice(texts))
        else:
            out.append(rng.choice(["<!-- c -->", "<!doctype html>",
                                   "</ td>"]))
    return "".join(out)


def canon(node):
    if node is None:
        return None
    return (node.label, node.colspan, node.rowspan,
            None if node.content is None else "".join(node.content),
            tuple(canon(c) for c in node.children))


def test_teds_matches_jax_lxml():
    rng = random.Random(2)
    corpus = TABLES + [tag_soup(rng) for _ in range(400)]
    for html in corpus:
        assert canon(jteds._parse_html_table(html)) == canon(
            tteds._parse_html_table(html)), html
        assert jteds.extract_and_clean_tables(html) == \
            tteds.extract_and_clean_tables(html)
    pairs = [(a, b) for a in TABLES[:8] for b in TABLES[:8]]
    pairs += [(corpus[i], corpus[i + 1]) for i in range(len(TABLES), 120)]
    for structure_only in (False, True):
        j, t = jteds.TEDS(structure_only), tteds.TEDS(structure_only)
        for a, b in pairs:
            assert j.evaluate(a, b) == t.evaluate(a, b), (a, b)


def ccocr_inputs():
    rng = np.random.default_rng(3)
    index = [{"dataset": "scene", "group": "multi_scene_ocr"},
             {"dataset": "zh_doc", "group": "multi_lan_ocr"},
             {"dataset": "tables", "group": "doc_parsing"},
             {"dataset": "receipts", "group": "kie"},
             {"dataset": "hidden", "group": "kie", "release": False}]
    gts = {"scene": {f"s{i}": words(rng, 4) for i in range(6)},
           "zh_doc": {f"z{i}": words(rng, 3) for i in range(4)},
           "tables": {f"t{i}": TABLES[i] for i in range(5)},
           "receipts": {f"r{i}": json.dumps(random_record(rng))
                        for i in range(5)},
           "hidden": {"h": "{}"}}
    resp = {"scene": {k: (v if i % 2 else words(rng, 4))
                      for i, (k, v) in enumerate(gts["scene"].items())},
            "zh_doc": {k: v for k, v in list(gts["zh_doc"].items())[:3]},
            "tables": {f"t{i}": TABLES[(i + 1) % 5] for i in range(5)},
            "receipts": {"r0": "```json\n" + gts["receipts"]["r0"] + "```",
                         "r1": "not json", "r2": gts["receipts"]["r3"]},
            "hidden": {"h": "{}"}}
    return index, resp, gts


def strip_time(out):
    return {k: {kk: vv for kk, vv in v.items() if kk != "time"}
            for k, v in out.items()}


def test_evaluate_and_summary_matches_jax():
    index, resp, gts = ccocr_inputs()
    for weighted in (False, True):
        assert strip_time(jh.evaluate_and_summary(index, resp, gts,
                                                  weighted)) == \
            strip_time(th.evaluate_and_summary(index, resp, gts, weighted))


def make_bench(tmp_path, pages):
    """A CC-OCR-format tree: <root>/data/scene/{qa.jsonl, images/}."""
    data = tmp_path / "bench" / "data" / "scene"
    (data / "images").mkdir(parents=True)
    with open(data / "qa.jsonl", "w") as f:
        for i, page in enumerate(pages):
            Image.fromarray(page).save(data / "images" / f"p{i}.png")
            f.write(json.dumps({"url": f"images/p{i}.png",
                                "prompt": "Read all text."}) + "\n")
    index = [{"dataset": "scene", "group": "multi_scene_ocr",
              "base_dir": "data/scene"}]
    (tmp_path / "bench" / "index").mkdir()
    path = tmp_path / "bench" / "index" / "index.json"
    path.write_text(json.dumps(index))
    return str(path), index


def fake_model(image_path, question):
    name = os.path.basename(image_path)
    if name == "p2.png":
        raise RuntimeError("a failing image")
    return f"{name} {question}"


def responses(out_dir):
    return {n: json.loads(open(os.path.join(out_dir, n)).read())["response"]
            for n in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("model", ["dummy", "import"])
def test_collect_predictions_matches_jax(tmp_path, model, capsys):
    """Both CLIs' `ccocr-collect` over the same tree: the same stats and
    responses (a failing image logged and skipped), then a resumed run
    that retries only what is missing."""
    index_path, _ = make_bench(tmp_path, np.zeros((4, 8, 8, 3), np.uint8))
    spec = ("dummy" if model == "dummy"
            else "import:test_torch_eval_metrics:fake_model")
    got = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out = str(tmp_path / name)
        runs = []
        for _ in range(2):
            assert main(["ccocr-collect", index_path, out, "--model", spec,
                         "--workers", "2"]) == 0
            text = capsys.readouterr().out
            runs.append(json.loads(text[text.index("{"):]))
        got[name] = runs, responses(os.path.join(
            out, spec.replace(":", "_"), "scene"))
    assert got["jax"] == got["port"]
    runs, resp = got["port"]
    ok = 4 if model == "dummy" else 3
    assert runs == [{"scene": {"total": 4, "ok": ok, "skipped": 0}},
                    {"scene": {"total": 4, "ok": 0, "skipped": ok}}]
    assert len(resp) == ok


@pytest.mark.parametrize("argv, workers", [
    (["--model", "pipeline"], 1),
    (["--model", "pipeline", "--workers", "3"], 3),
    (["--model", "dummy"], 4),
    (["--model", "import:test_torch_eval_metrics:fake_model"], 4)])
def test_ccocr_collect_workers_default(tmp_path, monkeypatch, capsys, argv,
                                       workers):
    """The pipeline's threads would share one card, so it runs on one
    unless `--workers` says otherwise; other models keep the reference's 4
    (an `import:` callable may be a network client)."""
    seen = []
    monkeypatch.setattr(tcli, "_pipeline_model_fn", lambda args: fake_model)
    monkeypatch.setattr(th, "collect_predictions",
                        lambda index, **kw: seen.append(kw["workers"]) or {})
    index_path = tmp_path / "index.json"
    index_path.write_text("[]")
    assert tcli.main(["ccocr-collect", str(index_path), str(tmp_path / "out"),
                      *argv, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert seen == [workers]


def test_ccocr_collect_pipeline_same_at_one_and_four_workers(
        tmp_path, monkeypatch, capsys):
    """`ccocr-collect --model pipeline` on the CPU with the CLI's own
    pipeline (a tiny MGP-STR, a tiny DB made an ink detector by
    `chip_smoke.readable_db`, DB at 128²): four threads calling it at once
    give the responses one thread gives, and decode one page file at a
    time; every page is read, some words found; `ccocr-eval` scores them
    1.0 against themselves."""
    import threading

    from advancedliteratemachinery_tpu_torch.models import db, mgp_str

    Db = db.DBConfig

    class ReadableDB(db.DBDetector):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            chip_smoke.readable_db(self)

    monkeypatch.setattr(db, "DETECT_HW", (128, 128))
    monkeypatch.setattr(db, "DBConfig",
                        lambda: Db(width=8, fpn_dim=16, head_dim=8))
    monkeypatch.setattr(db, "DBDetector", ReadableDB)
    monkeypatch.setattr(mgp_str, "MGPSTRConfig",
                        lambda **kw: chip_smoke.GOLDEN_MGP_STR)
    load, lock, decoding = tcli._load_image, threading.Lock(), []

    def counted_load(path):
        with lock:
            decoding.append(path)
            at_once = len(decoding)
        threading.Event().wait(0.02)
        with lock:
            decoding.remove(path)
        decoded.append(at_once)
        return load(path)

    decoded = []
    monkeypatch.setattr(tcli, "_load_image", counted_load)
    pages = chip_smoke.document_pages(4, hw=(192, 160), seed=5)
    index_path, index = make_bench(tmp_path, pages)
    got = {}
    for workers in (1, 4):
        out = str(tmp_path / f"w{workers}")
        assert tcli.main(["ccocr-collect", index_path, out, "--workers",
                          str(workers), "--device", "cpu"]) == 0
        stats = json.loads(capsys.readouterr().out)
        assert stats == {"scene": {"total": 4, "ok": 4, "skipped": 0}}
        got[workers] = responses(os.path.join(out, "pipeline", "scene"))
    assert got[1] == got[4]
    assert decoded == [1] * 8
    assert all(got[1].values())
    gt_dir = tmp_path / "gt"
    (gt_dir / "scene").mkdir(parents=True)
    for name, text in got[1].items():
        (gt_dir / "scene" / name).write_text(json.dumps({"text": text}))
    pred_dir = tmp_path / "w1" / "pipeline"
    assert tcli.main(["ccocr-eval", index_path, str(pred_dir),
                      str(gt_dir)]) == 0
    out = json.loads(capsys.readouterr().out)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main(["ccocr-eval", index_path, str(pred_dir), str(gt_dir)])
    assert strip_time(json.loads(buf.getvalue())) == strip_time(out)
    # the reference's macro F1 divides by counts + 1e-9: "1.0" is 1 - ~1e-9
    assert out["_overall"]["datasets"] == len(index)
    assert abs(out["_overall"]["score"] - 1.0) < 1e-6


def seeded_coco(rng, n_img=6, cats=(1, 2, 5)):
    gts, dts = [], []
    for img in range(n_img):
        for _ in range(int(rng.integers(0, 6))):
            cat = int(rng.choice(cats[:2]))         # category 5: no GT
            x, y = rng.uniform(0, 80, 2)
            w, h = rng.uniform(5, 30, 2)
            gts.append({"image_id": img, "category_id": cat,
                        "bbox": [x, y, w, h],
                        "iscrowd": int(rng.random() < 0.15)})
            for _ in range(int(rng.integers(0, 3))):
                j = rng.normal(0, 3, 4)
                dts.append({"image_id": img, "category_id": cat,
                            "bbox": [x + j[0], y + j[1], w + j[2], h + j[3]],
                            "score": float(rng.random())})
        for _ in range(int(rng.integers(0, 4))):
            dts.append({"image_id": img, "category_id": int(rng.choice(cats)),
                        "bbox": list(rng.uniform(0, 60, 4)),
                        "score": float(rng.random())})
    return dts, gts


def test_coco_map_and_converters_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(4)
    dts, gts = seeded_coco(rng)
    for kw in ({}, {"max_dets": 2}, {"categories": [1, 2, 5]},
               {"iou_thresholds": [0.5, 0.75]}):
        want, got = jdet.coco_map(dts, gts, **kw), tdet.coco_map(dts, gts,
                                                                 **kw)
        assert want.keys() == got.keys()
        np.testing.assert_array_equal(list(got.values()),
                                      list(want.values()))
    outs = {"boxes": rng.uniform(0, 50, (7, 4)) + [0, 0, 50, 50],
            "scores": rng.random(7), "classes": rng.integers(0, 3, 7),
            "valid": rng.random(7) < 0.7}
    assert jdet.cascade_to_coco(outs, "im") == tdet.cascade_to_coco(outs,
                                                                     "im")
    spots = [{"image_id": 1, "polys": rng.uniform(0, 99, (16, 2)).tolist(),
              "score": 0.5}, {"image_id": 2, "bbox": [1, 2, 3, 4]}]
    assert jdet.spotting_json_to_coco(spots) == tdet.spotting_json_to_coco(
        spots)
    (tmp_path / "dt.json").write_text(json.dumps(dts))
    (tmp_path / "gt.json").write_text(json.dumps({"annotations": gts}))
    argv = ["eval-det", str(tmp_path / "dt.json"), str(tmp_path / "gt.json")]
    assert tcli.main(argv) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert capsys.readouterr().out == got


def test_lore_metrics_match_jax():
    rng = np.random.default_rng(5)
    gt = [[x, y, x + rng.uniform(5, 20), y + rng.uniform(5, 20)]
          for x, y in rng.uniform(0, 100, (12, 2))]
    pred = [[v + rng.normal(0, 2) for v in r] for r in gt[2:]] + [
        [0, 0, 1, 1]]
    gt_axes = rng.integers(0, 5, (12, 4)).tolist()
    pred_axes = [a if i % 3 else [9, 9, 9, 9]
                 for i, a in enumerate(gt_axes[2:] + [[0, 0, 0, 0]])]
    quad = rng.uniform(0, 9, 8).tolist()
    assert jlore.quad_to_rect(quad) == tlore.quad_to_rect(quad)
    for thr in (0.5, 0.7):
        assert jlore.bbox_prf(pred, gt, thr) == tlore.bbox_prf(pred, gt, thr)
        assert jlore.logical_accuracy(pred, pred_axes, gt, gt_axes, thr) == \
            tlore.logical_accuracy(pred, pred_axes, gt, gt_axes, thr)


def seeded_quads(rng, n):
    """Convex quads: rotated rectangles, trapezoids, some sharing an edge
    or nested, and both orientations."""
    out = []
    for i in range(n):
        c = rng.uniform(20, 80, 2)
        w, h = rng.uniform(4, 30, 2)
        a = rng.uniform(-np.pi, np.pi)
        pts = np.array([[-w, -h], [w, -h], [w * rng.uniform(0.5, 1), h],
                        [-w * rng.uniform(0.5, 1), h]]) / 2
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        q = pts @ rot.T + c
        out.append(q[::-1] if i % 3 == 0 else q)
    out[1] = out[0]                                   # identical
    out[2] = (out[0] - out[0].mean(0)) * 0.5 + out[0].mean(0)  # nested
    return np.asarray(out, np.float32)


def test_quad_iou_matches_jax(jax_nms):
    q = seeded_quads(np.random.default_rng(6), 40)
    want = np.asarray(jax_nms["quad_iou"](jnp.asarray(q)[:, None],
                                          jnp.asarray(q)[None]))
    got = tnms.quad_iou(torch.from_numpy(q)[:, None],
                        torch.from_numpy(q)[None]).numpy()
    fused = np.asarray(jax.jit(jnms.quad_iou)(jnp.asarray(q)[:, None],
                                              jnp.asarray(q)[None]))
    print(f"quad IoU, port against JAX: {np.abs(got - want).max():.1e} "
          f"(FAST_COMPILE), {np.abs(got - fused).max():.1e} (default jit)")
    assert np.abs(got - want).max() <= QUAD_IOU_TOL
    assert np.abs(got - fused).max() <= DEFAULT_JIT_QUAD_IOU_TOL
    assert (want > 0).sum() > 60 and np.allclose(np.diag(got), 1.0,
                                                 atol=1e-6)


def test_nms_functions_keep_the_jax_boxes(jax_nms):
    rng = np.random.default_rng(7)
    q = seeded_quads(rng, 30)
    q[5:10] = q[:5] + rng.normal(0, 1, (5, 4, 2)).astype(np.float32)
    scores = np.sort(rng.permutation(30) / 30.0 + 0.01)[::-1].astype(
        np.float32)                                   # well separated
    boxes = q.reshape(30, 8)
    for thr in (0.1, 0.3, 0.5):
        want = np.asarray(jax_nms["poly_nms"](jnp.asarray(boxes),
                                        jnp.asarray(scores), thr))
        got = tnms.poly_nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), thr).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < 30
    for method in ("gaussian", "linear"):
        want = np.asarray(jax_nms["soft_nms_scores"](
            jnp.asarray(boxes), jnp.asarray(scores), 0.5, method))
        got = tnms.soft_nms_scores(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), 0.5,
                                   method).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    xyxy = np.concatenate([q.min(1), q.max(1)], 1)
    xyxy[20:25] = xyxy[:5] + 0.5
    s = rng.permutation(30).astype(np.float32)
    s[29] = -np.inf
    np.testing.assert_allclose(
        tnms.box_iou_matrix(torch.from_numpy(xyxy)).numpy(),
        np.asarray(jax_nms["box_iou_matrix"](jnp.asarray(xyxy))), atol=1e-6)
    for thr in (0.3, 0.5):
        want = np.asarray(jax_nms["box_nms"](jnp.asarray(xyxy), jnp.asarray(s),
                                       thr))
        got = tnms.box_nms(torch.from_numpy(xyxy), torch.from_numpy(s),
                           thr).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < 30


def grid_quads(rng, n):
    """n convex quads on a grid 40 px apart (no two overlap)."""
    q = seeded_quads(rng, n)
    centre = q.mean(1, keepdims=True)
    slots = np.stack(np.divmod(np.arange(n), 4), 1)[:, None, ::-1] * 40.0
    return ((q - centre) * 0.9 + 20 + slots).astype(np.float32)


def test_spotting_fscore_and_ensemble_match_jax(jax_nms, monkeypatch):
    """Three images of six text regions and one don't-care region, each
    with a detection near every region (every quad_iou call of one of two
    shapes, so the JAX function compiles twice)."""
    monkeypatch.setattr(jnms, "quad_iou", jax_nms["quad_iou"])
    rng = np.random.default_rng(8)
    gts, preds = {}, {}
    for img in range(3):
        q = grid_quads(rng, 7)
        texts = [words(rng, 1) or "w" for _ in range(7)]
        gts[img] = [{"polys": p.tolist(), "text": t, "ignore": k == 6}
                    for k, (p, t) in enumerate(zip(q, texts))]
        preds[img] = [{"polys": (p + rng.normal(0, 2 + 3 * img, (4, 2))
                                 ).reshape(-1).tolist(),
                       "text": t.upper() if k % 2 else t + "x" * (k % 3)}
                      for k, (p, t) in enumerate(zip(q, texts))]
    for kw in ({}, {"e2e": True}, {"e2e": True, "case_sensitive": True},
               {"iou_thr": 0.7}):
        want = jspot.spotting_fscore(preds, gts, **kw)
        assert want == tspot.spotting_fscore(preds, gts, **kw)
        assert 0 < want["matched"] < want["num_gt"] == 18
    runs = [[words(rng, 1) for _ in range(10)] for _ in range(3)]
    confs = rng.random((3, 10)).round(1).tolist()      # some ties
    assert jspot.confidence_ensemble(runs, confs) == \
        tspot.confidence_ensemble(runs, confs)
