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
`pipelines.modules.TableStructureRecognition` callable.

Training (`LORE.train_logic`, in `train()` mode): the head maps with
BatchNorm on batch statistics, the ax features gathered at the ground-truth
centres, and the Processor over them with the cells' padding mask (a
pairwise mask on the attention scores, -1e9 where either cell is padding).
The losses are the reference's (losses.py): CornerNet focal on the heat
map, masked L1 on the gathered corner offsets, and L1 / 4 on the logical
coordinates. `gaussian_radius`, `draw_gaussian` and `lore_targets` make
the CenterNet targets on the host (ctdet.py label generation).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

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
    corner_decode, ctdet_4ps_decode, gather_feat, sigmoid_clamped)
from advancedliteratemachinery_tpu_torch.ops.image import (
    as_device_tensor, resize_linear_u8)

FF_DIM = 2048     # the vendored transformer's fixed feed-forward width
NORM_EPS = 1e-6
MASKED_SCORE = -1e9   # the attention score of a pair with a padded cell


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

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C]; mask [B, T] (1 a cell, 0 padding) keeps the
        scores of pairs of cells and sets the others to -1e9
        (transformer.py:117-123)."""
        c = self.policy.compute_dtype
        h = self._norm(x, "norm1")
        B, T, C = h.shape
        hd = C // self.heads
        q, k, v = (linear(h, getattr(self, n), c).reshape(B, T, self.heads,
                                                          hd)
                   for n in ("q", "k", "v"))
        scores = torch.einsum("bthd,bshd->bhts", q, k) / (hd ** 0.5)
        if mask is not None:
            m2d = mask[:, None, :, None] * mask[:, None, None, :]
            scores = torch.where(m2d > 0, scores,
                                 scores.new_tensor(MASKED_SCORE))
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

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.policy.compute_dtype
        x = linear(x, self.in_proj, c)
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x, mask)
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

    def forward(self, feat: torch.Tensor, boxes: torch.Tensor = None,
                mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """feat [B, K, D] cell features; boxes [B, K, 8] 4-point boxes on
        the feature map; mask [B, K] the cells that are not padding (all
        are when None). Returns logic [B, K, 4] (+ stacked_logic)."""
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
        logic = self.tsfm_axis(feat, mask)
        out = {"logic": logic}
        if cfg.wiz_stacking:
            h = F.relu(linear(logic, self.logi_enc1, c))
            h = F.relu(linear(h, self.logi_enc2, c))
            cat = torch.cat([h, feat.to(h.dtype)], dim=-1)
            out["stacked_logic"] = self.stacker_tsfm(cat, mask)
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
        self.policy = policy
        self.backbone = DLASeg(config.backbone, policy, device, seed)
        self.processor = LoreProcessor(config, policy)
        gen = torch.Generator().manual_seed(seed + 1)
        init_params(self.processor, gen)
        for m in self.processor.modules():      # flax Embed's default init
            if isinstance(m, nn.Embedding):
                lecun_normal_(m.weight, m.weight.shape[1], gen)
        self.to(device).eval()

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


    def train_logic(self, images: torch.Tensor, ct_inds: torch.Tensor,
                    ct_mask: torch.Tensor,
                    gt_boxes: Optional[torch.Tensor] = None
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
        """The training path (classifier.py:94-118 in training mode): the
        head maps, then the Processor over the ax features gathered at the
        ground-truth centres `ct_inds` [B, K] (flat indices into the
        output map), with `ct_mask` [B, K] as its attention mask and
        `gt_boxes` [B, K, 8] for its position embeddings. BatchNorm
        follows the module's mode: call `train()` first, as the train
        step does. Returns (head maps, logic)."""
        out = self.backbone(images)
        ax_feat = gather_feat(out["ax"], ct_inds)
        return out, self.processor(ax_feat, gt_boxes, mask=ct_mask)


# ---------------- losses (losses.py) ----------------


def focal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """CornerNet's modified focal loss (losses.py:10); pred in (0, 1)."""
    pos = (gt == 1.0).float()
    neg = 1.0 - pos
    neg_w = (1.0 - gt) ** 4
    pos_loss = torch.log(pred) * (1 - pred) ** 2 * pos
    neg_loss = torch.log(1 - pred) * pred ** 2 * neg_w * neg
    num_pos = pos.sum()
    total = pos_loss.sum() + neg_loss.sum()
    return torch.where(num_pos == 0, -neg_loss.sum(),
                       -total / num_pos.clamp(min=1.0))


def reg_l1_loss(pred: torch.Tensor, mask: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """Masked L1 of gathered regressions (losses.py:97): pred and target
    [B, K, D], mask [B, K]; the denominator counts the mask expanded over
    D, as the reference's `mask.expand_as(pred).sum()`."""
    m = mask[..., None].float().expand_as(pred)
    loss = (pred * m - target * m).abs().sum()
    return loss / (m.sum() + 1e-4)


def axis_loss(pred: torch.Tensor, mask: torch.Tensor,
              target: torch.Tensor) -> torch.Tensor:
    """L1 of the logical coordinates / 4 (losses.py:54)."""
    m = mask[..., None].float()
    loss = (pred * m - target * m).abs().sum()
    return loss / (4 * (m.sum() + 1e-4))


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


# ---------------- host-side training targets ----------------


def gaussian_radius(det_size: Tuple[float, float],
                    min_overlap: float = 0.7) -> float:
    """CornerNet's radius heuristic (reference src/lib/utils/image.py
    `gaussian_radius`): the least of the three quadratic solutions."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(max(b1 ** 2 - 4 * c1, 0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(max(b2 ** 2 - 16 * c2, 0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0))) / 2
    return max(0.0, min(r1, r2, r3))


def draw_gaussian(heatmap: np.ndarray, center, radius: int) -> None:
    """Splat an unnormalised 2D gaussian into `heatmap` [H, W] by maximum
    (image.py `draw_umich_gaussian`)."""
    diameter = 2 * radius + 1
    sigma = diameter / 6
    y, x = np.ogrid[-radius: radius + 1, -radius: radius + 1]
    gaussian = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    cx, cy = int(center[0]), int(center[1])
    H, W = heatmap.shape
    left, right = min(cx, radius), min(W - cx, radius + 1)
    top, bottom = min(cy, radius), min(H - cy, radius + 1)
    if right + left <= 0 or top + bottom <= 0:
        return
    masked = heatmap[cy - top: cy + bottom, cx - left: cx + right]
    g = gaussian[radius - top: radius + bottom,
                 radius - left: radius + right]
    np.maximum(masked, g, out=masked)


def lore_targets(cells, logic_axes, hw: Tuple[int, int],
                 down_ratio: int = 4, max_cells: int = 128
                 ) -> Dict[str, np.ndarray]:
    """LORE's CenterNet training targets (reference
    src/lib/datasets/sample/ctdet.py): cells [N, 4, 2] corners in page
    pixels, logic_axes [N, 4] → hm [H/4, W/4, 2] (gaussian peaks at the
    cell centres, channel 0, and at their corners, channel 1), wh_target
    [K, 8] (corner offsets from the float centre), ct_inds and ct_mask
    [K] (flat centre indices into the output map), logic_target [K, 4]
    and gt_boxes [K, 8] (corners on the output map). A cell whose centre
    falls off the map is left out."""
    H, W = hw
    ho, wo = H // down_ratio, W // down_ratio
    hm = np.zeros((ho, wo, 2), np.float32)
    wh = np.zeros((max_cells, 8), np.float32)
    inds = np.zeros((max_cells,), np.int32)
    mask = np.zeros((max_cells,), np.float32)
    logic = np.zeros((max_cells, 4), np.float32)
    boxes = np.zeros((max_cells, 8), np.float32)
    for k, cell in enumerate(cells[:max_cells]):
        c = np.asarray(cell, np.float32).reshape(4, 2) / down_ratio
        ct = c.mean(axis=0)
        cti = np.floor(ct).astype(np.int32)
        if not (0 <= cti[0] < wo and 0 <= cti[1] < ho):
            continue
        h_box = float(c[:, 1].max() - c[:, 1].min())
        w_box = float(c[:, 0].max() - c[:, 0].min())
        radius = max(0, int(gaussian_radius((np.ceil(h_box),
                                             np.ceil(w_box)))))
        draw_gaussian(hm[..., 0], cti, radius)
        for corner in c:
            ci = np.floor(corner).astype(np.int32)
            if 0 <= ci[0] < wo and 0 <= ci[1] < ho:
                draw_gaussian(hm[..., 1], ci, max(1, radius // 2))
        wh[k] = (c - ct[None]).reshape(-1)
        inds[k] = cti[1] * wo + cti[0]
        mask[k] = 1.0
        logic[k] = np.asarray(logic_axes[k], np.float32)
        boxes[k] = c.reshape(-1)
    return {"hm": hm, "wh_target": wh, "ct_inds": inds, "ct_mask": mask,
            "logic_target": logic, "gt_boxes": boxes}
