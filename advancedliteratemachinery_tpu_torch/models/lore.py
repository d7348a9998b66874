"""LORE-TSR table structure recognition, inference path (port of
`advancedliteratemachinery_tpu/models/lore.py` `LORE`).

DLA-34 + DCN CenterNet heads {hm 2, st 8, wh 8, ax 256, cr 256, reg 2}
(`models/dla.py`) → device decode: heatmap peaks → top-K cells → 4-point
boxes, and the corner heatmap's group boxes (`ops/heatmap.py`) → the
logical `Processor`: cell features (ax + the summed cr features of the
four corners) plus x/y position embeddings of the box extremes, through a
transformer and a stacker transformer, regress 4 logical coordinates
(row_start, row_end, col_start, col_end) per cell.

The attention is plain torch, as it is an einsum outside any Pallas kernel
in the JAX package. `make_table_predict_fn` gives the
`pipelines.modules.TableStructureRecognition` callable. Losses and
training targets are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.core.registry import MODELS
from advancedliteratemachinery_tpu_torch.models.dla import (
    DLASeg, DLASegConfig)
from advancedliteratemachinery_tpu_torch.models.layers import (
    init_params, lecun_normal_, linear)
from advancedliteratemachinery_tpu_torch.ops.heatmap import (
    corner_decode, ctdet_4ps_decode, sigmoid_clamped)
from advancedliteratemachinery_tpu_torch.ops.image import (
    as_device_tensor, resize_linear_u8)

FF_DIM = 2048     # the vendored transformer's fixed feed-forward width
NORM_EPS = 1e-6


class LoreEncoderLayer(nn.Module):
    """x + attn(norm(x)); x + ff(norm(x)) (transformer.py:98-258), with the
    reference's std-norm: alpha (x - mean) / (std + 1e-6) + bias, std with
    Bessel's correction (not LayerNorm), in float32."""

    def __init__(self, dim: int, heads: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.heads = heads
        self.policy = policy
        for n in ("norm1", "norm2"):
            setattr(self, f"{n}_alpha", nn.Parameter(torch.ones(dim)))
            setattr(self, f"{n}_bias", nn.Parameter(torch.zeros(dim)))
        for n in ("q", "k", "v", "out"):
            setattr(self, n, nn.Linear(dim, dim))
        self.ff1 = nn.Linear(dim, FF_DIM)
        self.ff2 = nn.Linear(FF_DIM, dim)

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        h = x.float()
        mu = h.mean(-1, keepdim=True)
        sd = h.std(-1, keepdim=True, correction=1)
        h = (getattr(self, f"{name}_alpha") * (h - mu) / (sd + NORM_EPS)
             + getattr(self, f"{name}_bias"))
        return h.to(self.policy.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        h = self._norm(x, "norm1")
        B, T, C = h.shape
        hd = C // self.heads
        q, k, v = (linear(h, getattr(self, n), c).reshape(B, T, self.heads,
                                                          hd)
                   for n in ("q", "k", "v"))
        scores = torch.einsum("bthd,bshd->bhts", q, k) / (hd ** 0.5)
        attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, C)
        x = x + linear(o, self.out, c)
        h = self._norm(x, "norm2")
        h = linear(F.relu(linear(h, self.ff1, c)), self.ff2, c)
        return x + h


class LoreTransformer(nn.Module):
    """linear → N encoder layers → 2-layer ReLU decoder (transformer.py:48);
    no norm after the encoder stack, as the reference's forward applies
    none."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, layers: int,
                 heads: int, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.layers = layers
        self.in_proj = nn.Linear(in_dim, hidden)
        for i in range(layers):
            self.add_module(f"layer_{i}", LoreEncoderLayer(hidden, heads,
                                                           policy))
        self.dec1 = nn.Linear(hidden, hidden)
        self.dec2 = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        x = linear(x, self.in_proj, c)
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x)
        x = linear(F.relu(linear(x, self.dec1, c)), self.dec2, c)
        return F.relu(x).float()


@dataclasses.dataclass(frozen=True)
class LoreConfig:
    backbone: DLASegConfig = DLASegConfig()
    input_size: int = 256        # cell feature dim (== ax/cr head dim)
    hidden_size: int = 256
    output_size: int = 4         # logical coords
    tsfm_layers: int = 4
    stacking_layers: int = 4
    num_heads: int = 8
    max_fmp_size: int = 256
    wiz_2dpe: bool = True
    wiz_stacking: bool = True
    top_k: int = 100             # cell detections
    corner_k: int = 400


class LoreProcessor(nn.Module):
    """Logical location regression over detected-cell features
    (classifier.py:51), with the Stacker (classifier.py:22) when
    `wiz_stacking`."""

    def __init__(self, config: LoreConfig, policy: Policy = DEFAULT_POLICY):
        super().__init__()
        cfg = self.config = config
        self.policy = policy
        D = cfg.hidden_size
        if cfg.wiz_2dpe:
            self.x_pe = nn.Embedding(cfg.max_fmp_size, D)
            self.y_pe = nn.Embedding(cfg.max_fmp_size, D)
        self.tsfm_axis = LoreTransformer(D, D, cfg.output_size,
                                         cfg.tsfm_layers, cfg.num_heads,
                                         policy)
        if cfg.wiz_stacking:
            self.logi_enc1 = nn.Linear(cfg.output_size, D)
            self.logi_enc2 = nn.Linear(D, D)
            self.stacker_tsfm = LoreTransformer(2 * D, D, cfg.output_size,
                                                cfg.stacking_layers,
                                                cfg.num_heads, policy)

    def forward(self, feat: torch.Tensor, boxes: torch.Tensor = None
                ) -> Dict[str, torch.Tensor]:
        """feat [B, K, D] cell features; boxes [B, K, 8] 4-point boxes on
        the feature map. Returns logic [B, K, 4] (+ stacked_logic)."""
        cfg = self.config
        c = self.policy.compute_dtype
        if feat.shape[-1] != cfg.hidden_size:
            raise ValueError(
                f"LoreProcessor: cell-feature dim {feat.shape[-1]} must "
                f"equal hidden_size {cfg.hidden_size}")
        if cfg.wiz_2dpe and boxes is not None:
            ps = torch.round(boxes).clamp(0, cfg.max_fmp_size - 1).long()
            feat = (feat + self.x_pe(ps[:, :, 0]) + self.y_pe(ps[:, :, 1])
                    + self.x_pe(ps[:, :, 2]) + self.y_pe(ps[:, :, 5]))
        logic = self.tsfm_axis(feat)
        out = {"logic": logic}
        if cfg.wiz_stacking:
            h = F.relu(linear(logic, self.logi_enc1, c))
            h = F.relu(linear(h, self.logi_enc2, c))
            cat = torch.cat([h, feat.to(h.dtype)], dim=-1)
            out["stacked_logic"] = self.stacker_tsfm(cat)
        return out


@MODELS.register("lore")
class LORE(nn.Module):
    """DLASeg heads, then at inference the device decode and the Processor.
    Built on `device` (the GPU unless `device="cpu"`) with random weights
    from `seed`; load real weights with `engine.convert`."""

    def __init__(self, config: LoreConfig = LoreConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.backbone = DLASeg(config.backbone, policy, device, seed)
        self.processor = LoreProcessor(config, policy)
        gen = torch.Generator().manual_seed(seed + 1)
        init_params(self.processor, gen)
        for m in self.processor.modules():      # flax Embed's default init
            if isinstance(m, nn.Embedding):
                lecun_normal_(m.weight, m.weight.shape[1], gen)
        self.to(device)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw head maps: images [B, H, W, 3] → {head: [B, H/4, W/4, C]}."""
        return self.backbone(images)

    def infer(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full inference: heads → clamped sigmoid → decode → processor
        (base_detector.py:180 run, ctdet.py:41 process). Returns
        detections [B, top_k, 10], logic and raw_logic [B, top_k, 4],
        scores [B, top_k] and, with a corner heatmap, corners
        [B, corner_k, 8] and corner_scores [B, corner_k, 1]."""
        cfg = self.config
        out = self.backbone(images)
        hm = sigmoid_clamped(out["hm"][..., 0:1])
        dec = ctdet_4ps_decode(hm, out["wh"], out["ax"], out["cr"],
                               reg=out.get("reg"), k=cfg.top_k)
        corners = None
        if out["hm"].shape[-1] > 1:
            corners = corner_decode(sigmoid_clamped(out["hm"][..., 1:2]),
                                    out["st"], out.get("reg"),
                                    k=cfg.corner_k)
        logic = self.processor(dec["ax_feat"] + dec["cr_feat"],
                               dec["detections"][..., :8])
        res = {"detections": dec["detections"],
               "logic": logic.get("stacked_logic", logic["logic"]),
               "raw_logic": logic["logic"], "scores": dec["scores"]}
        if corners is not None:
            res["corners"] = corners["gboxes"]
            res["corner_scores"] = corners["scores"]
        return res


def make_table_predict_fn(model: LORE, input_size: int = 512,
                          down_ratio: int = 4, score_thresh: float = 0.3):
    """→ predict_fn(image_u8) for
    `pipelines.modules.TableStructureRecognition`: the page resized to
    `input_size`² on the model's device (`ops/image.py`
    `resize_linear_u8`, cv2's INTER_LINEAR), scaled to [0, 1] in float32,
    `LORE.infer`; then on the host the cells whose score passes
    `score_thresh`, mapped back by the page's own scale, their logical
    coordinates through `np.rint` (base_detector.py:180 post_process):
    {"polygons" [N, 8] float32, "logi_coords" [N, 4] int32}."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def predict(image_u8):
        page = as_device_tensor(image_u8, device)
        h, w = page.shape[:2]
        x = resize_linear_u8(page[None], (input_size, input_size))
        out = model.infer(x.float() / 255.0)
        det = out["detections"][0].cpu().numpy()
        scores = out["scores"][0].cpu().numpy()
        logic = np.rint(out["logic"][0].cpu().numpy()).astype(np.int32)
        keep = scores > score_thresh
        polys = det[keep, :8] * down_ratio
        polys = polys * np.tile([w / input_size, h / input_size], 4)
        return {"polygons": polys.astype(np.float32),
                "logi_coords": logic[keep]}

    return predict
