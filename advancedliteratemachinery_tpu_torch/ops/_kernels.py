"""Build, load and count the port's hand-written CUDA kernels.

Each source under `csrc/` is a plain-C-interface CUDA file. On first use it
is compiled with `nvcc` for `sm_90a` into a shared library under `build/`
(named by a hash of the source and the flags, so an edited source rebuilds)
and loaded with `ctypes`. Nothing is built when a module is imported: the
CPU tests import every module and never reach a kernel.

`LAUNCHES` counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = {
    "deform_conv": "deform_conv.cu",
    "fused_qkv_attention": "fused_qkv_attention.cu",
    "vocab_greedy_decode": "vocab_greedy_decode.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source on first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every kernel in `names` (default: all) that has no library
    for its current source yet, one `nvcc` per source, all started together.
    Returns the seconds each build took; raises if any build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    seconds, failed = {}, []
    for n, (p, tmp) in procs.items():
        out, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        BUILD_LOG[n] = out
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def kernel_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of kernel library `name`, built and loaded
    on first use, returning a CUDA error code."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        lib.alm_error_string.argtypes = [ctypes.c_int]
        lib.alm_error_string.restype = ctypes.c_char_p
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = _LIBS[name].alm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
