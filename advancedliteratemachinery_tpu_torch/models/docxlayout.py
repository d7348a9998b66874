"""DocXLayout: two-level document layout analysis, inference (port of
`advancedliteratemachinery_tpu/models/docxlayout.py`; reference
DocumentUnderstanding/DocXLayout).

A DLA-34 CenterNet with the plain-conv v0 neck (`models/dla.py`
`DLASegV0`, no deformable conv, so no port kernel) and two head groups:
the layout level {hm, cls (13), ftype, wh (8), reg (2)} and the subfield
level {hm_sub, wh_sub, reg_sub}, both decoded on the device with the
4-point decode of `ops/heatmap.py` (detectors/ctdet_subfield.py:26).
`make_layout_predict_fn` gives the `pipelines.modules.LayoutAnalysis`
callable: the score threshold and the class argmax run on the host in
NumPy, as in the JAX function.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch
import torch.nn as nn

from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.core.registry import MODELS
from advancedliteratemachinery_tpu_torch.models.dla import (
    DLAConfig, DLASegConfig, DLASegV0)
from advancedliteratemachinery_tpu_torch.ops.heatmap import (
    ctdet_4ps_decode, gather_feat, sigmoid_clamped)
from advancedliteratemachinery_tpu_torch.ops.image import as_device_tensor


@dataclasses.dataclass(frozen=True)
class DocXLayoutConfig:
    num_classes: int = 13
    num_secondary_classes: int = 3      # ftype
    top_k: int = 100
    top_k_sub: int = 20
    score_threshold: float = 0.3
    dla: DLAConfig = DLAConfig()
    head_conv: int = 256

    def seg_config(self) -> DLASegConfig:
        return DLASegConfig(
            dla=self.dla, head_conv=self.head_conv,
            heads=(
                ("hm", 1), ("cls", self.num_classes),
                ("ftype", self.num_secondary_classes),
                ("wh", 8), ("reg", 2),
                ("hm_sub", 1), ("wh_sub", 8), ("reg_sub", 2),
            ))


@MODELS.register("docxlayout")
class DocXLayout(nn.Module):
    """Built on `device` (the GPU unless `device="cpu"`) with random
    weights from `seed`; load real weights with
    `engine.checkpoint.import_docxlayout` or `engine.convert`."""

    def __init__(self, config: DocXLayoutConfig = DocXLayoutConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        self.config = config
        self.policy = policy
        self.backbone = DLASegV0(config.seg_config(), policy, device, seed)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw head maps: images [B, H, W, 3] → {head: [B, H/4, W/4, C]}."""
        return self.backbone(images)

    def infer(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """→ layout detections [B, K, 10], per-detection class
        probabilities [B, K, C] and ftype probabilities, subfield
        detections [B, Ks, 10] (ctdet_subfield.py:58-90)."""
        cfg = self.config
        out = self.backbone(images)
        hm = sigmoid_clamped(out["hm"])
        cls = sigmoid_clamped(out["cls"])
        ftype = sigmoid_clamped(out["ftype"])
        hm_sub = sigmoid_clamped(out["hm_sub"])
        # the decode's ax/cr features are LORE's; one zero channel here
        zeros = torch.zeros_like(out["wh"][..., :1])
        dec = ctdet_4ps_decode(hm, out["wh"], zeros, zeros, reg=out["reg"],
                               k=cfg.top_k)
        dec_sub = ctdet_4ps_decode(hm_sub, out["wh_sub"], zeros, zeros,
                                   reg=out["reg_sub"], k=cfg.top_k_sub)
        return {
            "detections": dec["detections"],
            "cls_probs": gather_feat(cls, dec["inds"]),
            "ftype_probs": gather_feat(ftype, dec["inds"]),
            "detections_sub": dec_sub["detections"],
        }


def make_layout_predict_fn(model: DocXLayout, down_ratio: int = 4):
    """→ predict_fn(image_u8) for `pipelines.modules.LayoutAnalysis`: the
    page as it is (no resize), scaled to [0, 1] in float32 on the model's
    device → `infer` → (quads [N, 8] in page pixels, scores [N],
    category ids [N]) as NumPy arrays, the detections whose score passes
    `score_threshold`."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def predict(image):
        cfg = model.config
        x = as_device_tensor(image, device)[None]
        out = model.infer(x.float() / 255.0)
        dets = out["detections"][0].cpu().numpy()
        cls_probs = out["cls_probs"][0].cpu().numpy()
        keep = dets[:, 8] >= cfg.score_threshold
        quads = dets[keep, :8] * down_ratio
        scores = dets[keep, 8]
        cats = cls_probs[keep].argmax(-1)
        return quads, scores, cats

    return predict
