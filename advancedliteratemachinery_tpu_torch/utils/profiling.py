"""Tracing and profiling (port of
`advancedliteratemachinery_tpu/utils/profiling.py`).

The reference's observability is wall-clock timers sprinkled per project
(MGP-STR forward_time test_final.py:137; LORE tot/net/dec/post timers with
explicit cuda.synchronize base_detector.py; FLOPs counters). Here:

- `trace(dir)`: a context manager around `torch.profiler` (CPU and, when
  there is a card, CUDA activity) that writes a Chrome trace of the
  wrapped region into `dir`;
- `StepTimer`: per-stage wall timing whose `stop` first waits for the
  card (`torch.cuda.synchronize` on each given tensor's device), so a
  stage's time covers its device work, not just its launches;
- `flops_estimate(fn, *args)`: the FLOPs `torch.utils.flop_counter`
  counts for one call of `fn(*args)`.

`flops_estimate` counts only the operations FlopCounterMode knows, the
matrix products and convolutions (2 per multiply-add, on every path,
including the hand-written kernels' plain versions on the CPU), where the
JAX function reads XLA's cost analysis of the compiled graph, which also
counts elementwise ops, softmaxes and norms. So the port's count is the
2·MACs of a model's matmuls and convolutions and lies below the JAX
number by the elementwise work.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the wrapped region into `log_dir`/trace.json (Chrome
    trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(x: Any) -> None:
    """Wait for the card's work on every CUDA tensor in `x` (a tensor or a
    nest of lists, tuples and dicts of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _sync(v)


class StepTimer:
    """Accumulates per-stage timings. Every stop() waits for the card's
    work on the given tensors, so the timing covers device work, not
    dispatch."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._starts: Dict[str, float] = {}

    def start(self, stage: str) -> None:
        self._starts[stage] = time.perf_counter()

    def stop(self, stage: str, *sync_on: Any) -> float:
        for x in sync_on:
            _sync(x)
        dt = time.perf_counter() - self._starts.pop(stage)
        self.totals[stage] += dt
        self.counts[stage] += 1
        return dt

    @contextlib.contextmanager
    def stage(self, name: str, sync_on: Any = None):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name, *([sync_on] if sync_on is not None else []))

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in sorted(self.totals)}

    def report(self) -> str:
        return " | ".join(f"{k}: {v * 1e3:.1f}ms" for k, v in
                          self.summary().items())


def flops_estimate(fn, *args) -> Optional[float]:
    """FLOPs of one call `fn(*args)` as FlopCounterMode counts them (the
    matmuls and convolutions; see the module docstring), or None when it
    counts nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    total = counter.get_total_flops()
    return float(total) if total else None
