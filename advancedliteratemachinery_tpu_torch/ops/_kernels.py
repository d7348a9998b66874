"""Build, load and count the port's hand-written CUDA kernels.

Each source under `csrc/` is a plain-C-interface CUDA file. On first use it
is compiled with `nvcc` for `sm_90a` into a shared library under `build/`
(named by a hash of the source, the local headers it includes and the
flags, so an edited source or header rebuilds) and loaded with `ctypes`.
Nothing is built when a module is imported: the CPU tests import every
module and never reach a kernel.

`LAUNCHES` counts kernel launches per wrapper; a wrapper adds one
(`count`) where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels. Threads may share one card
(the CC-OCR harness's workers): loading a library takes one lock, so no
kernel is built twice, and counting takes another, so no count is lost.
A launch of a loaded kernel takes only the second.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = {
    "deform_conv": "deform_conv.cu",
    "fused_qkv_attention": "fused_qkv_attention.cu",
    "fused_qkv_attention_bwd": "fused_qkv_attention_bwd.cu",
    "mha_short_seq": "mha_short_seq.cu",
    "vocab_greedy_decode": "vocab_greedy_decode.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count(name: str) -> None:
    """Add one launch of kernel `name` to LAUNCHES."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source on first use")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: Path, seen: Optional[list] = None) -> list:
    """`path` and every `#include "..."` beside it that it pulls in,
    recursively, each once, in include order."""
    seen = [] if seen is None else seen
    path = path.resolve()
    if path not in seen:
        seen.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            if (path.parent / inc.decode()).is_file():
                _sources(path.parent / inc.decode(), seen)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(CSRC / SOURCES[name]):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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
    fn = _FUNCS.get((name, symbol))
    if fn is not None:
        return fn
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.alm_error_string.argtypes = [ctypes.c_int]
            lib.alm_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name, symbol] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = _LIBS[name].alm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise for a kernel without a backward when autograd would record the
    call: its output would carry no `grad_fn` and cut the graph silently."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{name} kernel has no backward; call it under "
                         "torch.no_grad() or on inputs that do not require "
                         "grad")
