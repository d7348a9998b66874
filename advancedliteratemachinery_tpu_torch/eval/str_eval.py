"""STR benchmark runner: LMDB eval sets → per-set + weighted accuracy (port
of `advancedliteratemachinery_tpu/eval/str_eval.py`).

Parity target: MGP-STR benchmark_all_eval (test_final.py:29) — iterate the
standard eval LMDBs (IIIT5k/SVT/IC13/IC15/SVTP/CUTE...), report per-set and
sample-weighted total accuracy, per-head + confidence-fused numbers.

The JAX runner pads the last batch to `batch_size` for its jitted graph;
here the short batch runs as it is (no sample sees another, so its results
are the same). Crops are resized on the collate's device and handed to
`recognize_fn` there.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from advancedliteratemachinery_tpu_torch.data.str_dataset import (
    AlignCollate, LmdbStrDataset)
from advancedliteratemachinery_tpu_torch.eval.str_metrics import (
    STRAccuracyCounter, benchmark_summary)

# the stages `timings` splits a run into
STAGES = ("lmdb_read", "decode", "collate", "recognize", "scoring")


def evaluate_str_dataset(recognize_fn: Callable, dataset,
                         batch_size: int = 64,
                         collate: Optional[AlignCollate] = None,
                         device: Union[str, torch.device, None] = None,
                         timings: Optional[Dict[str, float]] = None
                         ) -> Dict[str, STRAccuracyCounter]:
    """recognize_fn: uint8 [B, h, w, 3] on the collate's device → list of
    (text, conf, head). Returns counters per head + 'fused'. `timings`,
    when given, gathers the seconds of each of STAGES (the device
    synchronized after the collate, so that the resize counts there)."""
    collate = collate or AlignCollate(device=device)
    sync = (torch.cuda.synchronize
            if timings is not None and collate.device.type == "cuda"
            else lambda: None)
    clock = time.perf_counter

    def spent(stage, t0):
        if timings is not None:
            timings[stage] = timings.get(stage, 0.0) + clock() - t0

    counters: Dict[str, STRAccuracyCounter] = {"fused": STRAccuracyCounter()}
    n = len(dataset)
    for start in range(0, n, batch_size):
        t0 = clock()
        raw = [dataset.read(i) for i in range(start, min(start + batch_size,
                                                         n))]
        spent("lmdb_read", t0)
        t0 = clock()
        samples = [(dataset.decode(b), label) for b, label in raw]
        spent("decode", t0)
        t0 = clock()
        batch, labels = collate(samples)
        sync()
        spent("collate", t0)
        t0 = clock()
        results = recognize_fn(batch)[: len(labels)]
        spent("recognize", t0)
        t0 = clock()
        for (text, conf, head), gt in zip(results, labels):
            counters["fused"].add(text, gt)
            counters.setdefault(head, STRAccuracyCounter()).add(text, gt)
        spent("scoring", t0)
    return counters


def benchmark_all_eval(recognize_fn: Callable, data_dirs: Sequence[str],
                       charset: str = None, max_length: int = 25,
                       batch_size: int = 64,
                       device: Union[str, torch.device, None] = None,
                       timings: Optional[Dict[str, float]] = None
                       ) -> Dict[str, float]:
    """test_final.py:29 protocol: per-set accuracy + weighted total. The
    set's name is the directory's last component."""
    per_set: Dict[str, STRAccuracyCounter] = {}
    collate = AlignCollate(device=device)
    for path in data_dirs:
        name = path.rstrip("/").split("/")[-1]
        ds = LmdbStrDataset(path, charset=charset, max_length=max_length)
        try:
            counters = evaluate_str_dataset(recognize_fn, ds, batch_size,
                                            collate, timings=timings)
        finally:
            ds.close()
        per_set[name] = counters["fused"]
    return benchmark_summary(per_set)
