"""Host batches into `engine.fit.fit` (port of the MGP-STR parts of
`advancedliteratemachinery_tpu/engine/batches.py`).

Images stay uint8 across the host→device copy (4x smaller than f32); the
`*_u8` recipe normalises them on the device inside the loss.
`prefetch_batches` keeps batches ahead of the train loop on a loader thread,
already copied to the device from pinned host memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.engine.train import (
    OptimizerConfig, make_optimizer, mgp_str_loss)
from advancedliteratemachinery_tpu_torch.ops.image import normalize_crops


def mgp_str_recipe_u8(model) -> Tuple[Callable, OptimizerConfig]:
    """`mgp_str_recipe` with uint8 images normalised on the device."""

    def loss_fn(batch, generator):
        x = normalize_crops(batch["images"], dtype=model.policy.compute_dtype)
        m = mgp_str_loss(model(x, generator=generator), batch)
        return m["loss"], m

    return loss_fn, make_optimizer(lr=1e-4, total_steps=2_000_000,
                                   grad_clip=5.0)


def to_device(batch: Dict[str, np.ndarray],
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, torch.Tensor]:
    """Host numpy batch → device tensors; for a CUDA device from pinned
    memory with asynchronous copies on the current stream. `device=None`
    means the GPU and raises without one (`resolve_device`)."""
    device = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_batches(batches: Iterator[Dict[str, np.ndarray]], size: int = 2,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Iterator[Dict[str, torch.Tensor]]:
    """Background-thread prefetcher: keeps up to `size` batches ahead of the
    consumer, each already on `device` (`to_device`; None means the GPU and
    raises here, not at the first batch, without one). The reference relies
    on torch DataLoader worker processes for this overlap; here the host
    batch assembly runs ahead on one thread while the loop launches steps.

    An exception in the source iterator is raised to the consumer at the
    matching `next()`. The thread is a daemon and also exits when the
    consumer drops the iterator."""
    return _prefetch(batches, size, resolve_device(device))


def _prefetch(batches: Iterator[Dict[str, np.ndarray]], size: int,
              device: torch.device) -> Iterator[Dict[str, torch.Tensor]]:
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    end = object()

    def produce():
        try:
            for batch in batches:
                q.put(to_device(batch, device))
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            q.put((end, e))
            return
        q.put((end, None))

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is end:
            if item[1] is not None:
                raise item[1]
            return
        yield item
