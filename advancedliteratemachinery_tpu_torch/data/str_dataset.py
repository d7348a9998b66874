"""STR datasets: LMDB reading, filtering, collation, source mixing (port of
`advancedliteratemachinery_tpu/data/str_dataset.py`).

Parity targets (reference OCR/MGP-STR/dataset.py):
- LmdbDataset :142 — keys num-samples / image-%09d / label-%09d, filtering
  by max length and charset, optional sensitive-case keep, rgb/grayscale.
- AlignCollate :421 — resize to (imgW, imgH) (keep-ratio + right-pad
  variant optional).
- Batch_Balanced_Dataset :30 — one loader per source with a batch-ratio
  mix, wrap-around iteration (:95 get_batch).

The card's machine has no PIL or cv2. Samples decode with
`pipelines/file_loading.py` `decode_image` (PNG of every kind, baseline
JPEG) to what PIL's `convert("RGB")` gives, and `rgb=False` takes PIL's
`convert("L")`: the ITU-R 601 luma in PIL's fixed point, which returns a
gray, gray + alpha or 16-bit gray PNG's own level and looks a palette
image up through its palette. A format the port does not decode raises
`ValueError` naming it. The collates resize each batch on their device
with `ops/image.py` (cv2's INTER_LINEAR fixed point: equal to
`cv2.resize` on downscales, within one level on upscales).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.data.lmdb_reader import LmdbReader
from advancedliteratemachinery_tpu_torch.ops.image import resize_each_u8
from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
    decode_image)


def luma_u8(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] → uint8 L [...], PIL's `convert("L")`:
    (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    v = rgb.astype(np.uint32)
    return ((v[..., 0] * 19595 + v[..., 1] * 38470 + v[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


class LmdbStrDataset:
    def __init__(self, path: str, charset: Optional[str] = None,
                 max_length: int = 25, rgb: bool = True,
                 sensitive: bool = False, filter_off: bool = False):
        self.reader = LmdbReader(path)
        n = self.reader.get(b"num-samples")
        self.num_samples = int(n) if n else 0
        self.charset = charset
        self.max_length = max_length
        self.rgb = rgb
        self.sensitive = sensitive
        self.indices: List[int] = []
        if filter_off:
            self.indices = list(range(1, self.num_samples + 1))
        else:
            pat = re.compile(f"[^{re.escape(charset)}]") if charset else None
            for i in range(1, self.num_samples + 1):
                label = self.reader.get(b"label-%09d" % i)
                if label is None:
                    continue
                text = label.decode("utf-8", "ignore")
                if not self.sensitive:
                    text = text.lower()
                if len(text) > self.max_length:
                    continue
                if pat is not None and pat.search(text):
                    continue
                self.indices.append(i)

    def __len__(self) -> int:
        return len(self.indices)

    def read(self, idx: int) -> Tuple[bytes, str]:
        """The sample's encoded image bytes and its label (lowercased
        unless `sensitive`), as stored."""
        i = self.indices[idx]
        label = self.reader.get(b"label-%09d" % i).decode("utf-8", "ignore")
        if not self.sensitive:
            label = label.lower()
        return self.reader.get(b"image-%09d" % i), label

    def decode(self, img_bytes: bytes) -> np.ndarray:
        """Encoded bytes → uint8 [H, W, 3] (`rgb`) or [H, W, 1]."""
        arr = decode_image(img_bytes)
        return arr if self.rgb else luma_u8(arr)[..., None]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        img_bytes, label = self.read(idx)
        return self.decode(img_bytes), label

    def close(self) -> None:
        self.reader.close()


def _rgb(img):
    return img if img.shape[-1] == 3 else np.repeat(img, 3, axis=-1)


def _resize_by_width(images: Sequence[np.ndarray], img_h: int,
                     widths: Sequence[int], device) -> List[torch.Tensor]:
    """Image i resized to (img_h, widths[i]) on `device`; one batched
    resize for each distinct width."""
    out: List[Optional[torch.Tensor]] = [None] * len(images)
    for w in sorted(set(widths)):
        idx = [i for i, wi in enumerate(widths) if wi == w]
        resized = resize_each_u8([images[i] for i in idx], (img_h, w),
                                 device)
        for j, i in enumerate(idx):
            out[i] = resized[j]
    return out


class AlignCollate:
    """Resize word crops to a uint8 [B, img_h, img_w, 3] batch on `device`
    (dataset.py:421); the engine normalizes on the device."""

    def __init__(self, img_h: int = 32, img_w: int = 128,
                 keep_ratio_with_pad: bool = False,
                 device: Union[str, torch.device, None] = None):
        self.img_h, self.img_w = img_h, img_w
        self.keep_ratio_with_pad = keep_ratio_with_pad
        self.device = resolve_device(device)

    def __call__(self, samples: Sequence[Tuple[np.ndarray, str]]
                 ) -> Tuple[torch.Tensor, List[str]]:
        images = [_rgb(img) for img, _ in samples]
        labels = [label for _, label in samples]
        if not self.keep_ratio_with_pad:
            return resize_each_u8(images, (self.img_h, self.img_w),
                                  self.device), labels
        batch = torch.zeros((len(images), self.img_h, self.img_w, 3),
                            dtype=torch.uint8, device=self.device)
        widths = [min(self.img_w, max(1, int(self.img_h * im.shape[1]
                                             / im.shape[0])))
                  for im in images]
        for i, (r, w) in enumerate(zip(
                _resize_by_width(images, self.img_h, widths, self.device),
                widths)):
            batch[i, :, :w] = r
            batch[i, :, w:] = r[:, -1:]          # the edge column
        return batch, labels


class ListerCollate:
    """LISTER-style collation: keep-ratio resize into a fixed-width canvas
    plus a validity mask over the real columns (reference LISTER
    dataset/dataset.py pads variable-width crops and feeds the mask to the
    masked FocalNet encoder), on `device`."""

    def __init__(self, img_h: int = 32, img_w: int = 128,
                 device: Union[str, torch.device, None] = None):
        self.img_h, self.img_w = img_h, img_w
        self.device = resolve_device(device)

    def __call__(self, samples: Sequence[Tuple[np.ndarray, str]]
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[str]]:
        images = [_rgb(img) for img, _ in samples]
        B = len(images)
        batch = torch.zeros((B, self.img_h, self.img_w, 3),
                            dtype=torch.uint8, device=self.device)
        mask = torch.zeros((B, self.img_h, self.img_w), dtype=torch.float32,
                           device=self.device)
        # Python's round: half to even, as the JAX collate
        widths = [min(self.img_w, max(1, int(round(self.img_h * im.shape[1]
                                                   / im.shape[0]))))
                  for im in images]
        for i, (r, w) in enumerate(zip(
                _resize_by_width(images, self.img_h, widths, self.device),
                widths)):
            batch[i, :, :w] = r
            mask[i, :, :w] = 1.0
        return batch, mask, [label for _, label in samples]


class BalancedMixer:
    """Round-robin sampler mixing multiple sources at fixed per-source batch
    fractions (dataset.py:30 Batch_Balanced_Dataset, :95 get_batch)."""

    def __init__(self, datasets: Sequence, ratios: Sequence[float],
                 batch_size: int, seed: int = 0):
        if len(datasets) != len(ratios):
            raise ValueError(f"{len(datasets)} datasets, {len(ratios)} "
                             f"ratios")
        total = sum(ratios)
        self.datasets = list(datasets)
        self.counts = [max(1, round(batch_size * r / total)) for r in ratios]
        # distribute rounding remainder to the first source
        self.counts[0] += batch_size - sum(self.counts)
        self.rng = np.random.default_rng(seed)
        self._perm = [self.rng.permutation(len(d)) for d in datasets]
        self._pos = [0] * len(datasets)

    def _next_idx(self, s: int) -> int:
        if self._pos[s] >= len(self._perm[s]):
            self._perm[s] = self.rng.permutation(len(self.datasets[s]))
            self._pos[s] = 0
        i = int(self._perm[s][self._pos[s]])
        self._pos[s] += 1
        return i

    def get_batch(self) -> List[Tuple[np.ndarray, str]]:
        out = []
        for s, c in enumerate(self.counts):
            for _ in range(c):
                out.append(self.datasets[s][self._next_idx(s)])
        return out
