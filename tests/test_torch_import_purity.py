"""The port imports neither JAX nor the JAX package, nor `regex`,
`safetensors`, PIL or cv2 (the card's machine has none of them), and
importing it
builds no kernel: every module of `advancedliteratemachinery_tpu_torch` and
the module-level code of `chip_smoke.py` and `k4_repeats.py` import in a
process where all of them are blocked."""

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
              "pipelines.file_loading", "engine.http_serving", "cli"):
        assert f"{PKG}.{m}" in modules
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "jaxlib", "flax", "advancedliteratemachinery_tpu",
                     "regex", "safetensors", "PIL", "cv2"):
            sys.modules[name] = None          # any import of them raises
        for m in {modules!r}:
            importlib.import_module(m)
        import chip_smoke, k4_repeats
        from {PKG}.ops import _kernels
        assert not _kernels._LIBS and not any(_kernels.LAUNCHES.values())
        assert not any(m.startswith(("jax", "flax", "regex", "safetensors",
                                     "PIL", "cv2"))
                       and sys.modules[m] for m in sys.modules)
        print("ok", len({modules!r}))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
