"""Command-line entry points of the port (port of the document and serving
commands of `advancedliteratemachinery_tpu/cli.py`):

  python -m advancedliteratemachinery_tpu_torch.cli <command> ...

  recognize IMG [IMG...]       word-crop recognition (mgp_str/lister/levocr)
  read / structurize / table   page pipelines → JSON
  convert DOC                  whole image/PDF → per-page JSON
  serve                        HTTP recognition service (continuous batching)

The arguments are the JAX CLI's. Models run on the card unless
`--device cpu` is given. Weights are seeded at random, or a reference
torch checkpoint of the recognizer through `--torch-ckpt`. Three JAX
arguments are refused with a clear error: `--ckpt` (the JAX package's
Orbax checkpoints), `--visualize` and `--formula-onnx`. Pages and crops
are PNG or `.npy` files (`pipelines/file_loading.py`).

`read`, `structurize`, `table` and `convert` detect text with DB and
`models/db.py` `make_db_detect_fn`, whose boxes come from the device
extraction (`ops/cc_extract.py`), not the JAX CLI's cv2 contours.
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


def _rec_engine(args):
    """--model {mgp_str,lister,levocr}: the three STR recognizers share the
    recognize() -> [(text, conf, tag)] protocol."""
    from advancedliteratemachinery_tpu_torch.engine import checkpoint as ck

    model_name = getattr(args, "model", "mgp_str")
    device = args.device
    sd = (ck.load_torch_state_dict(args.torch_ckpt)
          if getattr(args, "torch_ckpt", None) else None)
    if model_name == "mgp_str":
        from advancedliteratemachinery_tpu_torch.codecs.char_codec import (
            CharCodec)
        from advancedliteratemachinery_tpu_torch.engine.infer import (
            MGPSTRInference)
        from advancedliteratemachinery_tpu_torch.models.mgp_str import (
            MGPSTR, MGPSTRConfig)

        model = MGPSTR(MGPSTRConfig(variant=args.variant,
                                    batch_max_length=25), device=device)
        if sd is not None:
            ck.import_mgp_str(sd, model)
        return MGPSTRInference(model, CharCodec(), device=device)
    if model_name == "lister":
        from advancedliteratemachinery_tpu_torch.engine.infer import (
            LISTERInference)
        from advancedliteratemachinery_tpu_torch.models.lister import (
            LISTER, LISTERConfig)

        model = LISTER(LISTERConfig(variant=args.variant), device=device)
        if sd is not None:
            ck.import_lister(sd, model)
        return LISTERInference(model, device=device)
    from advancedliteratemachinery_tpu_torch.engine.infer import (
        LevOCRInference)
    from advancedliteratemachinery_tpu_torch.models.levocr import (
        LevOCR, LevOCRConfig)

    model = LevOCR(LevOCRConfig(), device=device)
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


COMMANDS = {"recognize": cmd_recognize, "read": cmd_read,
            "structurize": cmd_structurize, "table": cmd_table,
            "convert": cmd_convert, "serve": cmd_serve}


def _common(p, model: bool = True) -> None:
    if model:
        p.add_argument("--model", default="mgp_str",
                       choices=["mgp_str", "lister", "levocr"])
    p.add_argument("--variant", default="tiny",
                   choices=["tiny", "small", "base", "large"])
    p.add_argument("--ckpt", help="refused: the JAX package's Orbax "
                                  "checkpoints (use --torch-ckpt)")
    p.add_argument("--torch-ckpt",
                   help="reference torch checkpoint of the recognizer")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain versions on the CPU)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="alm-torch", description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

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

    args = parser.parse_args(argv)
    _refuse_unported(args)
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
