"""Host batches into `engine.fit.fit` (port of
`advancedliteratemachinery_tpu/engine/batches.py`: MGP-STR, DB and LORE).

Each iterator yields fixed-shape NumPy dicts. Images stay uint8 across the
host→device copy (4x smaller than f32); the `*_u8` recipes normalise them
on the device inside the loss. Pages are read with the port's
`decode_image` and resized as the JAX builders' PIL
`Image.open(...).convert("RGB").resize((W, H))` does (BICUBIC, bit-equal:
`ops/image.py` `resize_bicubic_u8`, here on the host); a missing page file
leaves its image zeros, as in the JAX builders. `prefetch_batches` keeps
batches ahead of the train loop on a loader thread, already copied to the
device from pinned host memory.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.engine.train import (
    OptimizerConfig, make_optimizer, mgp_str_loss)
from advancedliteratemachinery_tpu_torch.ops.image import (
    normalize_crops, resize_bicubic_u8)


def mgp_str_batches(mixer, char_codec, bpe_codec=None, wp_codec=None,
                    collate=None, augment: Optional[Callable] = None
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """MGP-STR batches: uint8 images + char/bpe/wp target ids
    (train_final_dist.py:141-153 encodes all three granularities a batch).
    A missing subword codec gives all-pad targets, which the ignore-pad CE
    leaves out, so the char head still trains. `augment` is a per-image
    callable applied before collation. `collate` defaults to an
    `AlignCollate` on the host."""
    from advancedliteratemachinery_tpu_torch.data.str_dataset import (
        AlignCollate)

    collate = collate or AlignCollate(device="cpu")
    T = char_codec.max_tokens
    while True:
        samples = mixer.get_batch()
        if augment is not None:
            samples = [(augment(img), lab) for img, lab in samples]
        images, labels = collate(samples)
        _, char_ids = char_codec.encode(labels)
        B = len(labels)
        bpe_ids = (bpe_codec.encode(labels) if bpe_codec
                   else np.zeros((B, T), np.int32))
        wp_ids = (wp_codec.encode(labels) if wp_codec
                  else np.zeros((B, T), np.int32))
        yield {"images": images.cpu().numpy(),
               "char_ids": np.asarray(char_ids),
               "bpe_ids": np.asarray(bpe_ids).astype(np.int32),
               "wp_ids": np.asarray(wp_ids).astype(np.int32)}


def _page(sample: Dict, hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """A sample's page file, decoded to RGB and resized to `hw` (H, W) as
    PIL's default `resize` does, or None when the file is missing."""
    from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
        load_image)

    try:
        img = load_image(os.path.join(sample["image_folder"],
                                      sample["file_name"]))
    except FileNotFoundError:
        return None
    return resize_bicubic_u8(img, hw, device="cpu").numpy()


def mgp_str_recipe_u8(model) -> Tuple[Callable, OptimizerConfig]:
    """`mgp_str_recipe` with uint8 images normalised on the device."""

    def loss_fn(batch, generator):
        x = normalize_crops(batch["images"], dtype=model.policy.compute_dtype)
        m = mgp_str_loss(model(x, generator=generator), batch)
        return m["loss"], m

    return loss_fn, make_optimizer(lr=1e-4, total_steps=2_000_000,
                                   grad_clip=5.0)


def db_batches(dataset, batch_size: int,
               image_hw: Tuple[int, int] = (640, 640), seed: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
    """DB batches from COCO spotting annotations (`data/coco_spotting.py`):
    pages drawn at random from `seed`, resized to `image_hw`, with the DB
    paper's maps (`models/db.py` `db_targets`) of each instance's Bezier
    polygon scaled to that size: images [B, H, W, 3] uint8, gt_prob,
    gt_thresh and thresh_mask [B, H, W, 1] float32."""
    from advancedliteratemachinery_tpu_torch.data.coco_spotting import (
        bezier_polygon)
    from advancedliteratemachinery_tpu_torch.models.db import db_targets

    rng = np.random.default_rng(seed)
    H, W = image_hw
    while True:
        batch = {
            "images": np.zeros((batch_size, H, W, 3), np.uint8),
            "gt_prob": np.zeros((batch_size, H, W, 1), np.float32),
            "gt_thresh": np.zeros((batch_size, H, W, 1), np.float32),
            "thresh_mask": np.zeros((batch_size, H, W, 1), np.float32),
        }
        for b in range(batch_size):
            s = dataset[int(rng.integers(0, len(dataset)))]
            img = _page(s, image_hw)
            if img is not None:
                batch["images"][b] = img
            h0, w0 = s["orig_size"]
            sx, sy = W / w0, H / h0
            polys = [bezier_polygon(bp) * np.asarray([sx, sy], np.float32)
                     for bp in s["bezier_pts"]]
            t = db_targets(polys, image_hw)
            for k in ("gt_prob", "gt_thresh", "thresh_mask"):
                batch[k][b] = t[k]
        yield batch


def db_recipe_u8(model) -> Tuple[Callable, OptimizerConfig]:
    """`db_recipe` with uint8 images normalised on the device."""
    from advancedliteratemachinery_tpu_torch.engine.recipes import db_recipe

    base_loss, tx = db_recipe(model)

    def loss_fn(batch, generator=None):
        b = dict(batch)
        b["images"] = normalize_crops(batch["images"],
                                      dtype=model.policy.compute_dtype)
        return base_loss(b, generator)

    return loss_fn, tx


class TableDataset:
    """COCO-style table annotations for LORE training: each annotation's
    `segmentation` is a cell's 8-point polygon and `logic_axis` its
    [row start, row end, col start, col end] (the reference's dataset
    jsons, src/lib/datasets/sample/ctdet.py). Item i → file name, folder,
    (height, width), cells [N, 4, 2] and logic [N, 4] float32."""

    def __init__(self, image_folder: str, anno_file: str):
        self.image_folder = image_folder
        with open(anno_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns: Dict[int, list] = {}
        for a in coco["annotations"]:
            self.anns.setdefault(a["image_id"], []).append(a)
        self.ids = sorted(self.images)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        info = self.images[self.ids[idx]]
        anns = self.anns.get(self.ids[idx], [])
        cells = np.asarray([np.asarray(a["segmentation"],
                                       np.float32).reshape(4, 2)
                            for a in anns], np.float32) \
            if anns else np.zeros((0, 4, 2), np.float32)
        logic = np.asarray([np.asarray(a["logic_axis"],
                                       np.float32).reshape(-1)[:4]
                            for a in anns], np.float32) \
            if anns else np.zeros((0, 4), np.float32)
        return {"file_name": info["file_name"],
                "image_folder": self.image_folder,
                "orig_size": (info["height"], info["width"]),
                "cells": cells, "logic": logic}


def lore_batches(dataset: TableDataset, batch_size: int,
                 image_hw: Tuple[int, int] = (512, 512),
                 max_cells: int = 128, seed: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """LORE batches: pages drawn at random from `seed`, resized to
    `image_hw`, with the CenterNet targets of their cells scaled to that
    size (`models/lore.py` `lore_targets`): images, hm, wh_target,
    ct_inds, ct_mask, logic_target and gt_boxes."""
    from advancedliteratemachinery_tpu_torch.models.lore import lore_targets

    rng = np.random.default_rng(seed)
    H, W = image_hw
    while True:
        batch = None
        for b in range(batch_size):
            s = dataset[int(rng.integers(0, len(dataset)))]
            h0, w0 = s["orig_size"]
            scale = np.asarray([W / w0, H / h0], np.float32)
            cells = s["cells"] * scale[None, None]
            t = lore_targets(cells, s["logic"], image_hw,
                             max_cells=max_cells)
            if batch is None:
                batch = {"images": np.zeros((batch_size, H, W, 3),
                                            np.uint8)}
                batch.update({k: np.zeros((batch_size,) + v.shape,
                                          v.dtype) for k, v in t.items()})
            img = _page(s, image_hw)
            if img is not None:
                batch["images"][b] = img
            for k, v in t.items():
                batch[k][b] = v
        yield batch


def lore_recipe_u8(model) -> Tuple[Callable, OptimizerConfig]:
    """`lore_recipe` with uint8 images normalised on the device."""
    from advancedliteratemachinery_tpu_torch.engine.recipes import (
        lore_recipe)

    base_loss, tx = lore_recipe(model)

    def loss_fn(batch, generator=None):
        b = dict(batch)
        b["images"] = normalize_crops(batch["images"],
                                      dtype=model.policy.compute_dtype)
        return base_loss(b, generator)

    return loss_fn, tx


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
