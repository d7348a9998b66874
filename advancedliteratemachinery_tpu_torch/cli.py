"""Command-line entry points of the port (port of the document and serving
commands of `advancedliteratemachinery_tpu/cli.py`):

  python -m advancedliteratemachinery_tpu_torch.cli <command> ...

  models [--cost MODEL]        list registered models/codecs/modules
  recognize IMG [IMG...]       word-crop recognition (mgp_str/lister/levocr)
  read / structurize / table   page pipelines → JSON
  vie IMG                      OmniParser key-information extraction → JSON
  table-html IMG               OmniParser table recognition → HTML
  table-eval DATA.jsonl        PubTabNet TEDS / S-TEDS evaluation
  convert DOC                  whole image/PDF → per-page JSON
  serve                        HTTP recognition service (continuous batching)
  eval --data LMDB...          STR benchmark suite (per-set + weighted acc)
  create-lmdb GT OUT           build an STR LMDB from path\tlabel lines
  ccocr-collect INDEX OUT      run a model over a CC-OCR tree → responses
  ccocr-eval INDEX PRED GT     CC-OCR LMM benchmark harness
  eval-det DT.json GT.json     COCO-protocol detection mAP

The arguments are the JAX CLI's. Models run on the card unless
`--device cpu` is given. Weights are seeded at random, or a reference
torch checkpoint of the recognizer (of OmniParser for `vie`, `table-html`
and `table-eval`) through `--torch-ckpt`. `vie`, `table-html` and
`table-eval` resize pages as the JAX commands' PIL `Image.resize` does
(BICUBIC), on the device (`ops/image.py` `resize_bicubic_u8`). Three JAX
arguments are refused with a clear error: `--ckpt` (the JAX package's
Orbax checkpoints), `--visualize` and `--formula-onnx`. Pages and crops
are PNG (any bit depth, interlaced or not), baseline JPEG or `.npy`
files (`pipelines/file_loading.py`).

`read`, `structurize`, `table` and `convert` detect text as the JAX CLI
does: DB, then the host `extract_boxes` on its probability map
(`models/db.py` `make_db_detect_fn`).
`structurize` and `convert` take the whole page as one "plain text"
region, as the JAX commands do; DocXLayout reaches a pipeline through
`models/docxlayout.py` `make_layout_predict_fn` + `LayoutAnalysis`.
"""

from __future__ import annotations

import argparse
import json
import sys


def _refuse_unported(args) -> None:
    """The JAX CLI's arguments that the port does not take yet exit with a
    message naming what to use instead or what is queued."""
    if getattr(args, "ckpt", None):
        raise SystemExit(
            "--ckpt loads the JAX package's Orbax checkpoints, which the "
            "PyTorch port does not read; pass a reference torch checkpoint "
            "with --torch-ckpt")
    if getattr(args, "visualize", None):
        raise SystemExit(
            "--visualize needs utils/visualization.py, which the PyTorch "
            "port has not ported yet (queued)")
    if getattr(args, "formula_onnx", None):
        raise SystemExit(
            "--formula-onnx needs pipelines/latex_ocr.py "
            "(FormulaRecognition.from_onnx), which the PyTorch port has not "
            "ported yet (queued); inject a callable into "
            "FormulaRecognition instead")


def _load_image(path: str):
    from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
        load_image)

    return load_image(path)


# the port's modules that register components (core/registry.py)
REGISTERING = ("codecs.char_codec", "codecs.coords", "codecs.seq_codec",
               "codecs.subword", "models.db", "models.docxlayout",
               "models.levocr", "models.lister", "models.lore",
               "models.mgp_str", "models.omniparser", "pipelines.modules")


def cmd_models(args) -> int:
    import importlib

    from advancedliteratemachinery_tpu_torch.core.registry import (
        CODECS, MODELS, PIPELINE_MODULES)

    for m in REGISTERING:
        importlib.import_module(f"advancedliteratemachinery_tpu_torch.{m}")
    print("models:  ", ", ".join(MODELS))
    print("codecs:  ", ", ".join(CODECS))
    print("modules: ", ", ".join(PIPELINE_MODULES))
    if getattr(args, "cost", None):
        _print_model_cost(args.cost, args.variant, args.device)
    return 0


def _print_model_cost(name: str, variant: str, device) -> None:
    """Params + forward GFLOPs at B=1 on a 32x128 crop for one recognition
    model, the reference's cost probes (MGP-STR test_final.py:391
    get_flops, LISTER model_cost.py). The forward runs in float32 on
    `device`, where every product goes through the PyTorch ops that
    `utils/profiling.py` `flops_estimate` counts (a hand-written kernel is
    opaque to it)."""
    import torch

    from advancedliteratemachinery_tpu_torch.core.precision import (
        FP32_POLICY)
    from advancedliteratemachinery_tpu_torch.utils.profiling import (
        flops_estimate)

    if name == "mgp_str":
        from advancedliteratemachinery_tpu_torch.models.mgp_str import (
            MGPSTR, MGPSTRConfig)

        model = MGPSTR(MGPSTRConfig(variant=variant), policy=FP32_POLICY,
                       device=device)
        args = (torch.zeros((1, 32, 128, 3),
                            device=next(model.parameters()).device),)
    elif name == "lister":
        from advancedliteratemachinery_tpu_torch.models.lister import (
            LISTER, LISTERConfig)

        model = LISTER(LISTERConfig(variant=variant), policy=FP32_POLICY,
                       device=device)
        dev = next(model.parameters()).device
        args = (torch.zeros((1, 32, 128, 3), device=dev),
                torch.ones((1, 32, 128), device=dev))
    else:
        print(f"cost: unsupported model {name!r} (mgp_str, lister)")
        return
    n_params = sum(p.numel() for p in model.parameters())
    flops = flops_estimate(model, *args)
    print(f"cost[{name}-{variant}]: params={n_params / 1e6:.2f}M"
          + (f"  fwd={flops / 1e9:.2f} GFLOPs (B=1 32x128)"
             if flops else ""))


def _cfg_overrides(cfg, json_str):
    """Apply a JSON dict of (possibly nested) field overrides to a frozen
    config dataclass — the JAX CLI's `--config-json`, which lets a command
    run at reduced widths (a nested dict builds a sub-config whose field
    is None, e.g. MGPSTRConfig.vit; a list becomes a tuple)."""
    if not json_str:
        return cfg
    import dataclasses
    import typing

    def dataclass_of(hint):
        for t in (hint, *typing.get_args(hint)):
            if isinstance(t, type) and dataclasses.is_dataclass(t):
                return t
        return None

    def apply(c, d):
        fields = {f.name for f in dataclasses.fields(c)}
        hints = typing.get_type_hints(type(c))
        kw = {}
        for k, v in d.items():
            if k not in fields:
                raise ValueError(f"{type(c).__name__}: unknown config "
                                 f"field {k!r}; valid: {sorted(fields)}")
            cur = getattr(c, k)
            if isinstance(v, dict) and dataclasses.is_dataclass(cur):
                v = apply(cur, v)
            elif isinstance(v, dict) and dataclass_of(hints.get(k)):
                v = apply(dataclass_of(hints[k])(), v)
            elif isinstance(v, list) and (cur is None
                                          or isinstance(cur, tuple)):
                v = tuple(v)
            kw[k] = v
        return dataclasses.replace(c, **kw)

    return apply(cfg, json.loads(json_str))


def _rec_engine(args):
    """--model {mgp_str,lister,levocr}: the three STR recognizers share the
    recognize() -> [(text, conf, tag)] protocol. MGP-STR takes
    `--batch-max-length` (default 25) and each model `--config-json`, as in
    the JAX CLI."""
    from advancedliteratemachinery_tpu_torch.engine import checkpoint as ck

    model_name = getattr(args, "model", "mgp_str")
    device = args.device
    overrides = getattr(args, "config_json", None)
    sd = (ck.load_torch_state_dict(args.torch_ckpt)
          if getattr(args, "torch_ckpt", None) else None)
    if model_name == "mgp_str":
        from advancedliteratemachinery_tpu_torch.codecs.char_codec import (
            CharCodec)
        from advancedliteratemachinery_tpu_torch.engine.infer import (
            MGPSTRInference)
        from advancedliteratemachinery_tpu_torch.models.mgp_str import (
            MGPSTR, MGPSTRConfig)

        cfg = MGPSTRConfig(variant=args.variant, batch_max_length=getattr(
            args, "batch_max_length", None) or 25)
        model = MGPSTR(_cfg_overrides(cfg, overrides), device=device)
        if sd is not None:
            ck.import_mgp_str(sd, model)
        return MGPSTRInference(model, CharCodec(), device=device)
    if model_name == "lister":
        from advancedliteratemachinery_tpu_torch.engine.infer import (
            LISTERInference)
        from advancedliteratemachinery_tpu_torch.models.lister import (
            LISTER, LISTERConfig)

        model = LISTER(_cfg_overrides(LISTERConfig(variant=args.variant),
                                      overrides), device=device)
        if sd is not None:
            ck.import_lister(sd, model)
        return LISTERInference(model, device=device)
    from advancedliteratemachinery_tpu_torch.engine.infer import (
        LevOCRInference)
    from advancedliteratemachinery_tpu_torch.models.levocr import (
        LevOCR, LevOCRConfig)

    model = LevOCR(_cfg_overrides(LevOCRConfig(), overrides), device=device)
    if sd is not None:
        ck.import_levocr(sd, model)
    return LevOCRInference(model, device=device)


def _db_detect_fn(args):
    from advancedliteratemachinery_tpu_torch.models.db import (
        DBConfig, DBDetector, make_db_detect_fn)

    return make_db_detect_fn(DBDetector(DBConfig(), device=args.device),
                             box_thresh=args.det_thresh)


def _lore_table_fn(args):
    from advancedliteratemachinery_tpu_torch.models.lore import (
        LORE, LoreConfig, make_table_predict_fn)

    return make_table_predict_fn(LORE(LoreConfig(), device=args.device),
                                 score_thresh=args.det_thresh)


def _recognition(args, engine):
    from advancedliteratemachinery_tpu_torch.pipelines.modules import (
        TextRecognition)

    return TextRecognition(engine.recognize, device=args.device)


def _whole_page_layout(image):
    import numpy as np

    h, w = image.shape[:2]
    return (np.asarray([[0, 0, w, 0, w, h, 0, h]], np.float32),
            np.asarray([1.0]), np.asarray([2]))


def _structurizer(args):
    from advancedliteratemachinery_tpu_torch.pipelines.document import (
        DocumentStructurization)
    from advancedliteratemachinery_tpu_torch.pipelines.modules import (
        LayoutAnalysis, TextDetection)

    engine = _rec_engine(args)
    return DocumentStructurization(
        LayoutAnalysis(_whole_page_layout),
        TextDetection(_db_detect_fn(args)), _recognition(args, engine),
        device=args.device)


def cmd_recognize(args) -> int:
    from advancedliteratemachinery_tpu_torch.ops.image import resize_each_u8

    engine = _rec_engine(args)
    # every crop goes up once and is resized on the engine's device
    crops = resize_each_u8([_load_image(p) for p in args.images], (32, 128),
                           engine.device)
    results = engine.recognize(crops)
    for path, (text, conf, head) in zip(args.images, results):
        print(json.dumps({"image": path, "text": text,
                          "confidence": round(conf, 4), "head": head}))
    return 0


def cmd_read(args) -> int:
    from advancedliteratemachinery_tpu_torch.pipelines.document import (
        GeneralTextReading)
    from advancedliteratemachinery_tpu_torch.pipelines.modules import (
        TextDetection)

    engine = _rec_engine(args)
    pipe = GeneralTextReading(TextDetection(_db_detect_fn(args)),
                              _recognition(args, engine))
    print(json.dumps(pipe(_load_image(args.image)), indent=2,
                     default=float))
    return 0


def cmd_structurize(args) -> int:
    out = _structurizer(args)(_load_image(args.image))
    print(json.dumps(out, indent=2, default=float))
    return 0


def cmd_table(args) -> int:
    """Table parsing: LORE cells + logical coords, DB det + recognition per
    cell → HTML (reference DocXChain example.py table_parsing_example)."""
    from advancedliteratemachinery_tpu_torch.pipelines.document import (
        TableParsing)
    from advancedliteratemachinery_tpu_torch.pipelines.modules import (
        TableStructureRecognition, TextDetection)

    engine = _rec_engine(args)
    pipe = TableParsing(TableStructureRecognition(_lore_table_fn(args)),
                        TextDetection(_db_detect_fn(args)),
                        _recognition(args, engine))
    print(json.dumps(pipe(_load_image(args.image)), indent=2,
                     default=float))
    return 0


def _omniparser(args, vie_categories: int):
    """OmniParser at `--variant` with `vie_categories` trailing class
    tokens, on `--device`, seeded at random or from `--torch-ckpt`."""
    from advancedliteratemachinery_tpu_torch.engine import checkpoint as ck
    from advancedliteratemachinery_tpu_torch.models.omniparser import (
        OmniParser, OmniParserConfig)

    model = OmniParser(OmniParserConfig(swin_variant=args.variant,
                                        vie_categories=vie_categories),
                       device=args.device)
    if args.torch_ckpt:
        ck.import_omniparser(ck.load_torch_state_dict(args.torch_ckpt),
                             model)
    return model


def _host(out) -> dict:
    return {k: t.cpu().numpy() for k, t in out.items()}


def cmd_vie(args) -> int:
    """Key-information extraction over one page image: OmniParser VIE
    decode → entity JSON (reference main.py --eval with --infer_vie +
    engine/val.py:39-44 per-image json dump)."""
    import torch

    from advancedliteratemachinery_tpu_torch.codecs.coords import (
        CORD_CLASSES, SROIE_CLASSES)
    from advancedliteratemachinery_tpu_torch.eval.spotting_eval import (
        decode_vie_outputs)
    from advancedliteratemachinery_tpu_torch.ops.image import (
        resize_bicubic_u8)

    classes = CORD_CLASSES if args.class_set == "cord" else SROIE_CLASSES
    model = _omniparser(args, len(classes))
    image = _load_image(args.image)
    orig_h, orig_w = image.shape[:2]
    size = args.image_size
    resized = resize_bicubic_u8(image, (size, size),
                                model.input_proj.weight.device)
    x = resized[None].float() / 255.0 * 2.0 - 1.0
    with torch.inference_mode():
        out = _host(model.infer_vie(x))
    entities = decode_vie_outputs(out, model.vocab_layout, classes,
                                  (orig_h, orig_w))
    print(json.dumps({"image": args.image, "entities": entities},
                     indent=2, default=float))
    return 0


def _build_table_model(args):
    """OmniParser with the table class band + loaded weights → (model,
    vocab, run_page: a resized uint8 page [size, size, 3] → infer_vie's
    outputs as NumPy arrays)."""
    import torch

    from advancedliteratemachinery_tpu_torch.data.pubtabnet import (
        N_TABLE_CLASSES)
    from advancedliteratemachinery_tpu_torch.ops.image import (
        as_device_tensor, normalize_crops)

    model = _omniparser(args, N_TABLE_CLASSES)
    dev = model.input_proj.weight.device

    def run_page(page_u8) -> dict:
        x = normalize_crops(as_device_tensor(page_u8, dev)[None],
                            dtype=torch.float32)
        with torch.inference_mode():
            return _host(model.infer_vie(x))

    return model, model.vocab_layout, run_page


def cmd_table_html(args) -> int:
    """Table recognition over one table image: OmniParser TR decode →
    PubTabNet-dialect HTML (see data/pubtabnet.py for the triplet
    scheme)."""
    from advancedliteratemachinery_tpu_torch.data.pubtabnet import (
        decode_table_outputs)
    from advancedliteratemachinery_tpu_torch.ops.image import (
        resize_bicubic_u8)

    model, v, run_page = _build_table_model(args)
    image = _load_image(args.image)
    orig_h, orig_w = image.shape[:2]
    size = args.image_size
    resized = resize_bicubic_u8(image, (size, size),
                                model.input_proj.weight.device)
    res = decode_table_outputs(run_page(resized), v, (orig_h, orig_w))
    print(json.dumps({"image": args.image, "html": res["html"],
                      "structure_html": res["structure_html"],
                      "cells": res["cells"]}, indent=2, default=float))
    return 0


def cmd_table_eval(args, timer=None) -> int:
    """TEDS / S-TEDS over a PubTabNet-format jsonl (the OmniParser README
    protocol: infer_vie per table image → HTML reconstruction → TEDS
    against the normalized ground-truth HTML). `timer`, a
    `utils.profiling.StepTimer`, gets the stages of each table: `load`
    (the file's decode), `resize` (on the device), `infer` (infer_vie,
    its outputs on the host), `decode` (the HTML) and `teds`."""
    import os

    from advancedliteratemachinery_tpu_torch.codecs.coords import (
        PRINTABLE_CHARS)
    from advancedliteratemachinery_tpu_torch.data.pubtabnet import (
        PubTabNetDataset, decode_table_outputs)
    from advancedliteratemachinery_tpu_torch.eval.teds import TEDS
    from advancedliteratemachinery_tpu_torch.ops.image import (
        resize_bicubic_u8)
    from advancedliteratemachinery_tpu_torch.utils.profiling import (
        StepTimer)

    ds = PubTabNetDataset(args.data, args.img_root or ".",
                          chars=PRINTABLE_CHARS, split=args.split,
                          max_samples=args.limit)
    if not len(ds):
        print(json.dumps({"error": "no samples matched",
                          "data": args.data, "split": args.split}))
        return 1
    model, v, run_page = _build_table_model(args)
    dev = model.input_proj.weight.device
    timer = timer or StepTimer()
    teds, steds = TEDS(), TEDS(structure_only=True)
    size = args.image_size
    t_sum = s_sum = 0.0
    per_sample = []
    for i in range(len(ds)):
        page = ds[i]
        with timer.stage("load"):
            image = _load_image(os.path.join(page["image_folder"],
                                             page["file_name"]))
        timer.start("resize")
        resized = resize_bicubic_u8(image, (size, size), dev)
        timer.stop("resize", resized)
        with timer.stage("infer"):
            out = run_page(resized)
        with timer.stage("decode"):
            res = decode_table_outputs(out, v, page["orig_size"])
        with timer.stage("teds"):
            t = teds.evaluate(res["html"], page["gt_html"])
            s = steds.evaluate(res["structure_html"], page["gt_html"])
        t_sum += t
        s_sum += s
        per_sample.append({"file": page["file_name"],
                           "teds": t, "s_teds": s})
    n = len(ds)
    summary = {"samples": n, "teds": t_sum / n, "s_teds": s_sum / n}
    if args.per_sample:
        summary["per_sample"] = per_sample
    print(json.dumps(summary, indent=2, default=float))
    return 0


def cmd_convert(args) -> int:
    """Whole-document (image or PDF) conversion → per-page JSON (reference
    example.py:164 whole_pdf_conversion_example)."""
    from advancedliteratemachinery_tpu_torch.pipelines.document import (
        convert_document)

    pages = convert_document(args.document, _structurizer(args),
                             dpi=args.dpi)
    print(json.dumps(pages, indent=2, default=float))
    return 0


def cmd_serve(args) -> int:
    """HTTP recognition service (engine/http_serving.py): concurrent
    clients coalesce into fixed-shape forwards on the card through the
    ContinuousBatcher."""
    from advancedliteratemachinery_tpu_torch.engine.http_serving import (
        RecognitionHTTPServer)

    engine = _rec_engine(args)
    detect_fn = _db_detect_fn(args) if args.with_detector else None
    server = RecognitionHTTPServer(
        engine, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        host=args.host, port=args.port, detect_fn=detect_fn,
        model_name=args.model)
    print(f"serving {args.model}/{args.variant} on "
          f"http://{args.host}:{server.port}  "
          f"(POST /v1/recognize{', /v1/read' if detect_fn else ''})",
          flush=True)
    server.serve_forever()
    return 0


def cmd_eval(args) -> int:
    """STR benchmark suite: per-set + weighted total word accuracy over
    LMDB eval dirs (reference test_final.py:29 benchmark_all_eval /
    LISTER test.py:23 / LevOCR eval.py:21). Crops are decoded on the host
    and resized on the engine's device."""
    from advancedliteratemachinery_tpu_torch.eval.str_eval import (
        benchmark_all_eval)

    engine = _rec_engine(args)
    out = benchmark_all_eval(engine.recognize, args.data,
                             charset=args.charset,
                             max_length=args.batch_max_length,
                             batch_size=args.batch_size,
                             device=engine.device)
    print(json.dumps(out, indent=2, default=float))
    return 0


def cmd_create_lmdb(args) -> int:
    from advancedliteratemachinery_tpu_torch.data.lmdb_writer import (
        create_str_lmdb)

    n = create_str_lmdb(args.gt_file, args.out_dir, root=args.root,
                        check_valid=not args.no_check)
    print(json.dumps({"out_dir": args.out_dir, "num_samples": n}))
    return 0


def cmd_ccocr_eval(args) -> int:
    """CC-OCR LMM benchmark harness over a predictions directory
    (reference Benchmarks/CC-OCR/evaluation/main.py: index-driven
    per-dataset evaluators + overall summary)."""
    import os

    from advancedliteratemachinery_tpu_torch.eval.ccocr_harness import (
        evaluate_and_summary, load_response_from_dir)

    def load_any(path):
        if os.path.isdir(path):
            return load_response_from_dir(path)
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    with open(args.index, encoding="utf-8") as f:
        index = json.load(f)
    responses, gts = {}, {}
    for item in index:
        name = item["dataset"]
        pdt = os.path.join(args.pred_dir, name)
        gt = os.path.join(args.gt_dir, name)
        if os.path.exists(pdt) and os.path.exists(gt):
            responses[name] = load_any(pdt)
            gts[name] = load_any(gt)
        elif os.path.exists(pdt + ".json") and os.path.exists(gt + ".json"):
            responses[name] = load_any(pdt + ".json")
            gts[name] = load_any(gt + ".json")
    out = evaluate_and_summary(index, responses, gts,
                               weighted=args.weighted)
    print(json.dumps(out, indent=2, default=float))
    return 0


def _pipeline_model_fn(args):
    """`ccocr-collect --model pipeline`: the port's `GeneralTextReading`
    as the JAX command builds it (MGP-STR-base at batch_max_length 25, DB
    with the host `extract_boxes` at the read command's default threshold,
    0.3), on `--device`; a page's response is its words' texts, one a
    line. Workers decode one page file at a time: the host decoders make
    many short NumPy calls, and threads running them at once spend
    several times the CPU a page and run slower than one thread
    (`collect_profile.py` measures it); decoded one at a time, four
    threads keep one thread's pace."""
    import threading
    from argparse import Namespace

    from advancedliteratemachinery_tpu_torch.pipelines.document import (
        GeneralTextReading)
    from advancedliteratemachinery_tpu_torch.pipelines.modules import (
        TextDetection)

    sub = Namespace(model="mgp_str", variant="base", device=args.device,
                    torch_ckpt=args.torch_ckpt, batch_max_length=25,
                    det_thresh=0.3)
    pipe = GeneralTextReading(TextDetection(_db_detect_fn(sub)),
                              _recognition(sub, _rec_engine(sub)))

    decoding = threading.Lock()

    def model_fn(image_path, question):
        with decoding:
            image = _load_image(image_path)
        out = pipe(image)
        return "\n".join(inst.get("text", "")
                         for inst in out.get("instances", []))

    return model_fn


def cmd_ccocr_collect(args) -> int:
    """Prediction collection over a CC-OCR-format benchmark tree
    (reference Benchmarks/CC-OCR/example.py): per released dataset, run a
    model on each qa.jsonl entry and write the per-image response JSONs
    that `ccocr-eval` consumes, with resume + parallel workers (threads;
    the pipeline's would share one card, so it runs on one by default)."""
    import importlib
    import os

    from advancedliteratemachinery_tpu_torch.eval.ccocr_harness import (
        collect_predictions)

    spec = args.model
    if spec == "dummy":
        model_fn = lambda image_path, question: ""           # noqa: E731
    elif spec == "pipeline":
        model_fn = _pipeline_model_fn(args)
    elif spec.startswith("import:"):
        mod_name, _, attr = spec[len("import:"):].rpartition(":")
        model_fn = getattr(importlib.import_module(mod_name), attr)
    else:
        raise SystemExit(f"unknown --model {spec!r} (pipeline | dummy | "
                         f"import:module:attr)")

    with open(args.index, encoding="utf-8") as f:
        index = json.load(f)
    # reference path resolution: dataset base_dirs are relative to the
    # index file's grandparent (example.py: dirname(dirname(index_path)))
    base = args.base_dir or os.path.dirname(
        os.path.dirname(os.path.abspath(args.index)))
    stats = collect_predictions(
        index, base_dir=base, output_dir=args.output_dir, model_fn=model_fn,
        model_name=args.model_name or args.model.replace(":", "_"),
        workers=(args.workers if args.workers is not None
                 else 1 if spec == "pipeline" else 4),
        resume=not args.no_resume)
    print(json.dumps(stats, indent=2))
    return 0


def cmd_eval_det(args) -> int:
    """COCO-protocol detection scoring: detections JSON + ground-truth
    JSON → mAP/AP50/AP75 + per-category AP (the metric detectron2's
    COCOEvaluator reports for VGT — VGTTrainer.py:668)."""
    from advancedliteratemachinery_tpu_torch.eval.det_map import coco_map

    with open(args.detections, encoding="utf-8") as f:
        dets = json.load(f)
    with open(args.ground_truth, encoding="utf-8") as f:
        gt = json.load(f)
    if isinstance(gt, dict):            # full COCO file → annotations
        gt = gt.get("annotations", gt)
    if isinstance(dets, dict):
        dets = dets.get("annotations", dets)
    print(json.dumps(coco_map(dets, gt), indent=2, default=float))
    return 0


COMMANDS = {"models": cmd_models, "vie": cmd_vie,
            "table-html": cmd_table_html, "table-eval": cmd_table_eval,
            "recognize": cmd_recognize, "read": cmd_read,
            "structurize": cmd_structurize, "table": cmd_table,
            "convert": cmd_convert, "serve": cmd_serve, "eval": cmd_eval,
            "create-lmdb": cmd_create_lmdb, "ccocr-eval": cmd_ccocr_eval,
            "ccocr-collect": cmd_ccocr_collect, "eval-det": cmd_eval_det}


def _common(p, model: bool = True) -> None:
    if model:
        p.add_argument("--model", default="mgp_str",
                       choices=["mgp_str", "lister", "levocr"])
    p.add_argument("--variant", default="tiny",
                   choices=["tiny", "small", "base", "large"])
    p.add_argument("--ckpt", help="refused: the JAX package's Orbax "
                                  "checkpoints (use --torch-ckpt)")
    p.add_argument("--torch-ckpt",
                   help="reference torch checkpoint of the command's "
                        "model")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain versions on the CPU)")


def parse_args(argv=None) -> argparse.Namespace:
    """The command line → its arguments (the arguments the port refuses
    exit here with a message)."""
    parser = argparse.ArgumentParser(
        prog="alm-torch", description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("models", help="list registered components")
    p.add_argument("--cost", metavar="MODEL",
                   help="also print params + forward GFLOPs for a "
                        "recognition model (get_flops / model_cost.py)")
    p.add_argument("--variant", default="tiny",
                   choices=["tiny", "small", "base", "large"])
    p.add_argument("--device", default=None,
                   help="torch device of the --cost forward (default: the "
                        "CUDA card)")

    p = sub.add_parser("vie",
                       help="key-information extraction (OmniParser VIE) "
                            "→ entity JSON")
    p.add_argument("image")
    _common(p, model=False)
    p.set_defaults(variant="base")
    p.add_argument("--class-set", default="cord", choices=["cord", "sroie"])
    p.add_argument("--image-size", type=int, default=640)

    p = sub.add_parser("table-html",
                       help="table recognition (OmniParser TR) → "
                            "PubTabNet-dialect HTML")
    p.add_argument("image")
    _common(p, model=False)
    p.set_defaults(variant="base")
    p.add_argument("--image-size", type=int, default=640)

    p = sub.add_parser("table-eval",
                       help="TEDS/S-TEDS over a PubTabNet-format jsonl "
                            "(OmniParser TR README protocol)")
    p.add_argument("data", help="PubTabNet jsonl annotations")
    p.add_argument("--img-root", help="table image directory")
    p.add_argument("--split", help="filter on the jsonl split field")
    p.add_argument("--limit", type=int, help="cap evaluated samples")
    p.add_argument("--per-sample", action="store_true",
                   help="include per-table scores in the JSON")
    _common(p, model=False)
    p.set_defaults(variant="base")
    p.add_argument("--image-size", type=int, default=640)

    p = sub.add_parser("recognize",
                       help="recognize word crops (MGP-STR/LISTER/LevOCR)")
    p.add_argument("images", nargs="+")
    _common(p)

    for name, help_ in (("read", "detect + recognize full image"),
                        ("structurize", "document structurization → JSON"),
                        ("table", "table parsing → cells + HTML")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("image")
        _common(p)
        p.add_argument("--det-thresh", type=float, default=0.3)
        p.add_argument("--visualize", metavar="OUT.png",
                       help="refused: utils/visualization.py is not "
                            "ported yet")
        if name == "structurize":
            p.add_argument("--formula-onnx", metavar="DIR",
                           help="refused: pipelines/latex_ocr.py is not "
                                "ported yet")

    p = sub.add_parser("convert",
                       help="whole image/PDF → per-page structurization")
    p.add_argument("document")
    _common(p, model=False)
    p.add_argument("--det-thresh", type=float, default=0.3)
    p.add_argument("--dpi", type=int, default=150)

    p = sub.add_parser("serve",
                       help="HTTP recognition service (continuous batching)")
    _common(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--with-detector", action="store_true",
                   help="enable POST /v1/read (DB detect + recognize)")
    p.add_argument("--det-thresh", type=float, default=0.3)

    p = sub.add_parser("eval",
                       help="STR benchmark over LMDB eval sets "
                            "(benchmark_all_eval protocol)")
    p.add_argument("--data", nargs="+", required=True,
                   help="LMDB eval dirs (IIIT5k, SVT, ...)")
    _common(p)
    p.set_defaults(variant="base")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--batch-max-length", type=int, default=25)
    p.add_argument("--charset")
    p.add_argument("--config-json",
                   help="model-config field overrides (JSON dict), e.g. "
                        "reduced widths")

    p = sub.add_parser("create-lmdb",
                       help="build an STR LMDB from a `path\\tlabel` gt "
                            "file (create_lmdb_dataset.py)")
    p.add_argument("gt_file")
    p.add_argument("out_dir")
    p.add_argument("--root", default="", help="image path prefix")
    p.add_argument("--no-check", action="store_true",
                   help="skip image validity checks")

    p = sub.add_parser("ccocr-eval",
                       help="CC-OCR benchmark harness over a predictions "
                            "directory")
    p.add_argument("index", help="index JSON ([{dataset, group, ...}])")
    p.add_argument("pred_dir", help="per-dataset response dirs/json files")
    p.add_argument("gt_dir", help="per-dataset ground-truth dirs/json files")
    p.add_argument("--weighted", action="store_true",
                   help="sample-weighted overall score")

    p = sub.add_parser("ccocr-collect",
                       help="run a model over a CC-OCR benchmark tree and "
                            "write the per-image prediction dirs the "
                            "harness consumes (reference example.py)")
    p.add_argument("index", help="index JSON ([{dataset, group, base_dir, "
                                 "release}])")
    p.add_argument("output_dir")
    p.add_argument("--model", default="pipeline",
                   help="'pipeline' (the port's general-text-reading "
                        "stack), 'dummy' (empty responses; plumbing "
                        "check), or 'import:module:attr' for any "
                        "callable(image_path, question) -> text")
    p.add_argument("--model-name", default=None,
                   help="output subdirectory name (default: --model)")
    p.add_argument("--workers", type=int, default=None,
                   help="threads calling the model at once (default: 1 for "
                        "'pipeline', whose threads share one card and gain "
                        "nothing over one; 4, the reference's, for 'dummy' "
                        "and 'import:', whose callable may be a network "
                        "client)")
    p.add_argument("--no-resume", action="store_true",
                   help="recompute responses that already exist")
    p.add_argument("--base-dir", default=None,
                   help="benchmark root the index's base_dirs are relative "
                        "to (default: the index file's grandparent, as in "
                        "the reference)")
    p.add_argument("--ckpt", help="refused: the JAX package's Orbax "
                                  "checkpoints (use --torch-ckpt)")
    p.add_argument("--torch-ckpt",
                   help="reference torch checkpoint of the pipeline's "
                        "MGP-STR-base recognizer")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")

    p = sub.add_parser("eval-det",
                       help="COCO-protocol detection mAP from a "
                            "detections JSON vs ground truth")
    p.add_argument("detections", help="[{image_id, category_id, bbox "
                                      "xywh, score}] or COCO results file")
    p.add_argument("ground_truth", help="[{image_id, category_id, bbox}] "
                                        "or a full COCO annotation file")

    args = parser.parse_args(argv)
    _refuse_unported(args)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
