"""The port imports neither JAX nor the JAX package, nor `regex`,
`safetensors`, PIL, cv2, lxml, `Levenshtein`, `lmdb` or `onnxruntime` (the
card's machine has none of them), and importing it builds no kernel: every module of
`advancedliteratemachinery_tpu_torch` and the module-level code of
`chip_smoke.py` and the root's measuring scripts (`k4_repeats.py`,
`kernel_ab.py`, `collect_profile.py`) import in a process where all of
them are blocked, the CLI's evaluation, OmniParser task and `train` commands
parse there, and `models` lists the registries there."""

import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "advancedliteratemachinery_tpu_torch"


def test_port_imports_without_jax():
    modules = sorted(                  # build/ holds compiled kernels only
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / PKG).rglob("*.py")
        if p.relative_to(ROOT / PKG).parts[0] != "build")
    modules = [m.removesuffix(".__init__") for m in modules]
    assert f"{PKG}.ops.attention" in modules
    assert f"{PKG}.engine.checkpoint" in modules
    assert f"{PKG}.codecs.subword" in modules
    for m in ("models.abinet", "models.levocr", "ops.levenshtein",
              "codecs.coords", "models.swin", "models.omniparser",
              "engine.serving", "eval.spotting_eval", "models.docxlayout",
              "pipelines", "pipelines.modules", "pipelines.document",
              "pipelines.file_loading", "pipelines.jpeg", "ops.contours",
              "engine.http_serving", "cli", "data.lmdb_reader",
              "data.lmdb_writer", "data.str_dataset", "eval.str_metrics",
              "eval.str_eval", "eval.ocr_metrics", "eval.tree_edit",
              "eval.teds", "eval.kie_metrics", "eval.ccocr_harness",
              "eval.det_map", "eval.lore_metrics", "ops.nms", "ops.image",
              "data.pubtabnet", "models.lister_baselines",
              "utils.profiling", "core.registry", "codecs.seq_codec",
              "utils.visualization", "pipelines.latex_ocr",
              "data.coco_spotting", "engine.train_extras",
              "engine.recipes", "engine.batches", "engine.fit",
              "models.db", "models.lore", "models.dla"):
        assert f"{PKG}.{m}" in modules
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "flax", "advancedliteratemachinery_tpu",
                     "regex", "safetensors", "PIL", "cv2", "lxml",
                     "Levenshtein", "lmdb", "onnxruntime"):
            sys.modules[name] = None          # any import of them raises
        for m in {modules!r}:
            importlib.import_module(m)
        from {PKG} import cli
        for cmd in ("eval", "create-lmdb", "ccocr-eval", "ccocr-collect",
                    "eval-det", "models", "vie", "table-html",
                    "table-eval", "read", "structurize", "table",
                    "train"):
            try:
                cli.main([cmd, "--help"])
            except SystemExit as e:
                assert e.code == 0, cmd
        from {PKG}.eval import str_metrics, teds
        assert str_metrics.edit_distance("kitten", "sitting") == 3
        assert abs(teds.TEDS().evaluate("<table><tr><td>a</table>",
                                        "<table><tr><td>b</table>")
                   - 2 / 3) < 1e-12
        assert cli.main(["models"]) == 0     # imports every registrant
        import chip_smoke, collect_profile, k4_repeats, kernel_ab
        from {PKG}.ops import _kernels
        assert not _kernels._LIBS and not _kernels._FUNCS
        assert not any(_kernels.LAUNCHES.values())
        assert not any(m.startswith(("jax", "flax", "regex", "safetensors",
                                     "PIL", "cv2", "lxml", "Levenshtein",
                                     "lmdb", "onnxruntime"))
                       and sys.modules[m] for m in sys.modules)
        print("ok", len({modules!r}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1].startswith("ok")
