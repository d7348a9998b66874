"""Reference checkpoints straight into the port (port of the torch-import
half of `advancedliteratemachinery_tpu/engine/checkpoint.py`).

`load_torch_state_dict` reads a released artifact: a torch `.pth`/`.bin`
(`weights_only` unless trusted), a `.safetensors` file (parsed here, with no
`safetensors` package) or a sharded HF `*.index.json`, and returns CPU
tensors in the dtype stored.

Each importer maps the reference's keys onto one of the port's modules and
loads the result into it (strict), returning the module's full state dict.
The port keeps torch layouts, so most tensors carry over as they are; the
maps are where the port's own layout differs: the grouped 1x1 convs of
MGP-STR's TokenLearners ([G, I/G, O/G]), its zero-padded heads, the DCN
offset channels (split dy | dx | mask, not interleaved), the bilinear up
kernels ([2f, 2f, C]; LORE's and DocXLayout's necks), the 1x1 convs that
are Linear layers here, and the navigator's [1, C, C] weight. A shape that
disagrees with the module raises `ValueError` naming the key and both
shapes; a tensor the module needs and the checkpoint lacks raises
`KeyError` naming it; checkpoint tensors left unused are reported with a
warning, buffers (`_BUFFER_SUFFIXES`) excepted.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import warnings
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64,
                       "I32": torch.int32}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file: an 8-byte little-endian header length, a JSON
    header ({name: {dtype, shape, data_offsets}}, plus `__metadata__`),
    then the raw little-endian bytes."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"which the loader does not read")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        if count == 0:
            t = torch.empty(0, dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=count,
                                 offset=8 + n + start).clone()
        out[name] = t.reshape(info["shape"])
    return out


def load_torch_state_dict(path: str, trusted: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """Load a released checkpoint: torch `.pth`/`.bin`, `.safetensors`, or
    a sharded HF `*.index.json` (shards merged). Unwraps `model`,
    `state_dict` and `net`, strips DDP `module.` prefixes, and returns CPU
    tensors in the dtype stored.

    Defaults to `weights_only=True`: released checkpoints are third-party
    artifacts, and full unpickling runs arbitrary code. Pass `trusted=True`
    only for checkpoints you built yourself that need it."""

    def finish(sd):
        for key in ("model", "state_dict", "net"):
            if isinstance(sd, dict) and isinstance(sd.get(key), dict):
                sd = sd[key]
        return {re.sub(r"^module\.", "", k):
                (v.detach().cpu() if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v)))
                for k, v in sd.items()}

    if path.endswith(".safetensors"):
        return finish(load_safetensors(path))
    if path.endswith(".index.json"):
        with open(path, encoding="utf-8") as f:
            index = json.load(f)
        base = os.path.dirname(os.path.abspath(path))
        merged: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(index["weight_map"].values())):
            merged.update(load_torch_state_dict(os.path.join(base, shard),
                                                trusted=trusted))
        return merged
    try:
        sd = torch.load(path, map_location="cpu", weights_only=not trusted)
    except pickle.UnpicklingError as e:     # what weights_only refuses
        if trusted:
            raise
        raise RuntimeError(
            f"{path} is not loadable with weights_only=True; if you trust "
            f"its origin, retry with trusted=True") from e
    return finish(sd)


class _TrackingDict(dict):
    """Records which checkpoint keys an importer read, so that the ones it
    left unused can be reported."""

    def __init__(self, *a, importer: str = "", **k):
        super().__init__(*a, **k)
        self.importer = importer
        self.read: set = set()

    def __getitem__(self, key):
        self.read.add(key)
        if not super().__contains__(key):
            raise KeyError(f"{self.importer}: the checkpoint has no tensor "
                           f"'{key}'")
        return super().__getitem__(key)

    def __contains__(self, key):
        self.read.add(key)
        return super().__contains__(key)


_BUFFER_SUFFIXES = ("num_batches_tracked", "position_ids", ".pe", "version",
                    "relative_position_index")


def _warn_unused(p: _TrackingDict) -> None:
    unused = [k for k in p if k not in p.read
              and not any(k.endswith(s) for s in _BUFFER_SUFFIXES)]
    if unused:
        warnings.warn(
            f"{p.importer}: {len(unused)} checkpoint tensors were not mapped "
            f"onto the model (first few: {sorted(unused)[:4]}) — extra heads "
            f"or a richer variant than this config", stacklevel=3)


class _Mapper:
    """Reads reference tensors (keys under `prefix`, prefix removed) and
    writes them under the port module's keys, checking each shape."""

    def __init__(self, sd: Dict[str, torch.Tensor], module: nn.Module,
                 importer: str, prefix: str = ""):
        self.p = _TrackingDict({k[len(prefix):]: v for k, v in sd.items()
                                if k.startswith(prefix)}, importer=importer)
        self.module = module
        self.importer = importer
        self.want = module.state_dict()
        self.out: Dict[str, torch.Tensor] = {}

    def put(self, key: str, value: torch.Tensor) -> None:
        if key not in self.want:
            raise KeyError(f"{self.importer}: the model has no '{key}'")
        want = self.want[key]
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(
                f"{self.importer}: checkpoint tensor for '{key}' has shape "
                f"{tuple(value.shape)} but the model expects "
                f"{tuple(want.shape)} — wrong variant/config for this "
                f"checkpoint?")
        self.out[key] = value.to(want.dtype).contiguous()

    def copy(self, dst: str, src: str, leaves=("weight", "bias")) -> None:
        """dst.{leaf} ← src.{leaf} as they are (Linear, conv, norm)."""
        for leaf in leaves:
            self.put(f"{dst}.{leaf}", self.p[f"{src}.{leaf}"])

    def bn(self, dst: str, src: str) -> None:
        self.copy(dst, src, ("weight", "bias", "running_mean",
                             "running_var"))

    def finish(self) -> Dict[str, torch.Tensor]:
        """Zero the BatchNorm counters (no effect at eval), check that
        every tensor of the module was filled, load strictly, warn about
        unused checkpoint tensors."""
        for k, v in self.want.items():
            if k.endswith("num_batches_tracked"):
                self.out[k] = torch.zeros_like(v, device="cpu")
        missing = sorted(set(self.want) - set(self.out))
        if missing:
            raise KeyError(f"{self.importer}: no checkpoint tensor for "
                           f"{missing[:4]} ({len(missing)} in all)")
        self.module.load_state_dict(self.out, strict=True)
        _warn_unused(self.p)
        return self.out


def _grouped_from_torch(w: torch.Tensor, groups: int) -> torch.Tensor:
    """torch grouped 1x1 conv weight [O, I/G, 1, 1] → the port's
    block-diagonal [G, I/G, O/G]: out[g·O/G + o] = Σ_i w[g·O/G + o, i] ·
    x[g·I/G + i]."""
    O, Ig = w.shape[:2]
    return w[:, :, 0, 0].reshape(groups, O // groups, Ig).transpose(1, 2)


# ---------------- MGP-STR ----------------


def import_mgp_str(sd: Dict[str, torch.Tensor], model: nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """An MGP-STR checkpoint (timm ViT + three TokenLearners + heads,
    reference modules/mgp_str.py) into the port's `MGPSTR`. Heads are
    zero-padded to `cfg.padded_vocab`, with bias -1e4 on the padding
    columns, so that they never win."""
    sd = {k[len("mgp_str."):] if k.startswith("mgp_str.") else k: v
          for k, v in sd.items()}
    m = _Mapper(sd, model, "import_mgp_str")
    p = m.p
    m.copy("encoder.patch_embed.proj", "patch_embed.proj")
    for name in ("cls_token", "pos_embed"):
        m.put(f"encoder.{name}", p[name])
    for i in range(model.config.vit_config().depth):
        dst, src = f"encoder.blocks_{i}.", f"blocks.{i}."
        for part in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                     "mlp.fc2"):
            m.copy(dst + part, src + part)
    for head in model.config.heads:
        dst, src = f"{head}_token_learner.", f"{head}_tokenLearner."
        groups = getattr(model, f"{head}_token_learner").select_group.groups
        m.copy(dst + "token_norm", src + "token_norm")
        m.put(dst + "select_group.kernel",
              _grouped_from_torch(p[src + "tokenLearner.0.weight"], groups))
        m.put(dst + "select_proj.weight",
              p[src + "tokenLearner.1.weight"][:, :, 0, 0])
        m.put(dst + "feat.kernel",
              _grouped_from_torch(p[src + "feat.weight"], groups))
        m.copy(dst + "norm", src + "norm")
        w, b = p[f"{head}_head.weight"], p[f"{head}_head.bias"]
        want = m.want[f"{head}_head.weight"]
        if w.shape[0] > want.shape[0] or w.shape[1] != want.shape[1]:
            raise ValueError(
                f"import_mgp_str: checkpoint tensor for '{head}_head.weight' "
                f"has shape {tuple(w.shape)} but the model expects at most "
                f"{tuple(want.shape)} — wrong variant/config for this "
                f"checkpoint?")
        padded = torch.zeros(want.shape, dtype=want.dtype)
        padded[:w.shape[0]] = w
        bias = torch.full((want.shape[0],), -1e4, dtype=want.dtype)
        bias[:b.shape[0]] = b
        m.put(f"{head}_head.weight", padded)
        m.put(f"{head}_head.bias", bias)
    return m.finish()


# ---------------- LORE-TSR and DocXLayout: DLASeg, DLASegV0, Processor ----


def dcn_offset_perm(K: int) -> torch.Tensor:
    """The reference DCNv2 `conv_offset_mask` emits interleaved (y_k, x_k)
    pairs, then K mask channels (dcn_v2.py:147 and the CUDA kernel's
    2k/2k+1 indexing); the port's DeformConv2d splits [dy·K, dx·K,
    mask·K]."""
    k = torch.arange(K)
    return torch.cat([2 * k, 2 * k + 1, 2 * K + k])


def _dla_trunk(m: "_Mapper", base: nn.Module, dst: str) -> None:
    """The DLA-34 trunk (reference DLA :224: `base.base_layer`,
    `base.level0`-`level5`, ConvBnRelu as a Sequential of conv and bn)
    into the port's `DLA` at `dst`."""
    from advancedliteratemachinery_tpu_torch.models.dla import BasicBlock

    p = m.p

    def cbr(d, conv, bn):          # ConvBnRelu: conv (no bias) + bn
        m.put(f"{d}.conv.weight", p[f"{conv}.weight"])
        m.bn(f"{d}.bn", bn)

    def tree(mod, d, src):
        if isinstance(mod, BasicBlock):
            cbr(f"{d}.conv1", f"{src}.conv1", f"{src}.bn1")
            cbr(f"{d}.conv2", f"{src}.conv2", f"{src}.bn2")
            return
        if mod.project is not None:
            cbr(f"{d}.project", f"{src}.project.0", f"{src}.project.1")
        if mod.levels == 1:
            cbr(f"{d}.root.conv", f"{src}.root.conv", f"{src}.root.bn")
        tree(mod.tree1, f"{d}.tree1", f"{src}.tree1")
        tree(mod.tree2, f"{d}.tree2", f"{src}.tree2")

    cbr(f"{dst}.base_layer", "base.base_layer.0", "base.base_layer.1")
    for lv in range(2):
        cbr(f"{dst}.level{lv}", f"base.level{lv}.0", f"base.level{lv}.1")
    for lv in range(2, 6):
        tree(getattr(base, f"level{lv}"), f"{dst}.level{lv}",
             f"base.level{lv}")


def _up_kernel(w: torch.Tensor) -> torch.Tensor:
    """Grouped ConvTranspose2d weight [C, 1, k, k] → the port's
    UpsampleBilinear kernel [k, k, C]."""
    return w[:, 0].permute(1, 2, 0)


def import_dla(sd: Dict[str, torch.Tensor],
               model: nn.Module) -> Dict[str, torch.Tensor]:
    """A LORE-TSR / CenterNet DLASeg (ctdet) checkpoint (reference
    pose_dla_dcn.py: DLA :224, DLAUp :390, IDAUp :361, DeformConv :346,
    heads :443) into the port's `DLASeg`, BatchNorm statistics included."""
    m = _Mapper(sd, model, "import_dla")
    p = m.p
    _dla_trunk(m, model.base, "base")

    def dcn_block(dst, src):
        w = p[f"{src}.conv.weight"]
        m.put(f"{dst}.dcn.weight", w)
        m.put(f"{dst}.dcn.bias", p[f"{src}.conv.bias"])
        perm = dcn_offset_perm(w.shape[2] * w.shape[3])
        for leaf in ("weight", "bias"):
            m.put(f"{dst}.dcn.conv_offset_mask.{leaf}",
                  p[f"{src}.conv.conv_offset_mask.{leaf}"][perm])
        m.bn(f"{dst}.bn", f"{src}.actf.0")

    def ida(mod, name):
        for j in range(1, mod.n):
            dcn_block(f"{name}.proj_{j}", f"{name}.proj_{j}")
            dcn_block(f"{name}.node_{j}", f"{name}.node_{j}")
            if mod.up_factors[j] != 1:    # factor-1 ups have no kernel
                m.put(f"{name}.up_{j}.kernel",
                      _up_kernel(p[f"{name}.up_{j}.weight"]))

    for i in range(model.dla_up.n):
        ida(getattr(model.dla_up, f"ida_{i}"), f"dla_up.ida_{i}")
    ida(model.ida_up, "ida_up")
    for head, _ in model.config.heads:
        m.copy(f"{head}_conv1", f"{head}.0")
        m.copy(f"{head}_out", f"{head}.2")
    return m.finish()


def import_docxlayout(sd: Dict[str, torch.Tensor], model: nn.Module,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """The released DocXLayout checkpoint (DocXLayout_231012.pth; reference
    DocumentUnderstanding/DocXLayout/models/networks/dlav0_subfield.py
    DLASeg) into the port's `DocXLayout`: the DLA trunk as `import_dla`
    reads it, the v0 neck's `dla_up.ida_{i}.{proj,node}_{j}.{0,1}.*`
    (conv, BatchNorm) and `up_{j}.weight` (the grouped transposed conv),
    and the heads `{head}.{0,2}.*`. Keys under `prefix` only, the prefix
    removed."""
    m = _Mapper(sd, model, "import_docxlayout", prefix)
    p = m.p
    seg = model.backbone
    _dla_trunk(m, seg.base, "backbone.base")
    for i in range(seg.dla_up.n):
        mod = getattr(seg.dla_up, f"ida_{i}")
        name = f"dla_up.ida_{i}"
        for j in range(mod.n):
            if mod.projected[j]:
                m.put(f"backbone.{name}.proj_{j}.conv.weight",
                      p[f"{name}.proj_{j}.0.weight"])
                m.bn(f"backbone.{name}.proj_{j}.bn", f"{name}.proj_{j}.1")
            if mod.up_factors[j] != 1:
                m.put(f"backbone.{name}.up_{j}.kernel",
                      _up_kernel(p[f"{name}.up_{j}.weight"]))
            if j:
                m.put(f"backbone.{name}.node_{j}.conv.weight",
                      p[f"{name}.node_{j}.0.weight"])
                m.bn(f"backbone.{name}.node_{j}.bn", f"{name}.node_{j}.1")
    for head, _ in seg.config.heads:
        m.copy(f"backbone.{head}_conv1", f"{head}.0")
        m.copy(f"backbone.{head}_out", f"{head}.2")
    return m.finish()


def _lore_tsfm(m: _Mapper, mod: nn.Module, dst: str, src: str) -> None:
    """One vendored transformer (LORE-TSR transformer.py:48): linear →
    encoder.layers.{i}.{norm_1, attn, norm_2, ff} → decoder.linear.{0,2}.
    The reference Encoder's `norm` and `pe` are never applied in its
    forward; they are marked read and skipped."""
    p = m.p
    m.copy(f"{dst}.in_proj", f"{src}.linear")
    for i in range(mod.layers):
        d, s = f"{dst}.layer_{i}.", f"{src}.encoder.layers.{i}."
        for n in ("1", "2"):
            m.put(f"{d}norm{n}_alpha", p[f"{s}norm_{n}.alpha"])
            m.put(f"{d}norm{n}_bias", p[f"{s}norm_{n}.bias"])
        for ours, theirs in (("q", "q_linear"), ("k", "k_linear"),
                             ("v", "v_linear"), ("out", "out")):
            m.copy(d + ours, f"{s}attn.{theirs}")
        m.copy(d + "ff1", s + "ff.linear_1")
        m.copy(d + "ff2", s + "ff.linear_2")
    for dead in ("encoder.norm.alpha", "encoder.norm.bias"):
        _ = f"{src}.{dead}" in p
    m.copy(f"{dst}.dec1", f"{src}.decoder.linear.0")
    m.copy(f"{dst}.dec2", f"{src}.decoder.linear.2")


def import_lore_processor(sd: Dict[str, torch.Tensor],
                          model: nn.Module) -> Dict[str, torch.Tensor]:
    """LORE's logical `Processor` checkpoint (the second file the reference
    loads, base_detector.py:29-30; module at classifier.py:51) into the
    port's `LoreProcessor`: the x/y position embeddings, the `tsfm_axis`
    regressor and, with `wiz_stacking`, the Stacker's logi_encoder
    (classifier.py:25-29) and its transformer."""
    m = _Mapper(sd, model, "import_lore_processor")
    if model.config.wiz_2dpe:
        m.put("x_pe.weight", m.p["x_position_embeddings.weight"])
        m.put("y_pe.weight", m.p["y_position_embeddings.weight"])
    _lore_tsfm(m, model.tsfm_axis, "tsfm_axis", "tsfm_axis")
    if model.config.wiz_stacking:
        m.copy("logi_enc1", "stacker.logi_encoder.0")
        m.copy("logi_enc2", "stacker.logi_encoder.2")
        _lore_tsfm(m, model.stacker_tsfm, "stacker_tsfm", "stacker.tsfm")
    return m.finish()


def load_lore(model: nn.Module, model_path: str, processor_path: str,
              trusted: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's two LORE files, the DLASeg model and the Processor
    (base_detector.py:29-30), into the port's `LORE`; returns its full
    state dict."""
    out = {f"backbone.{k}": v for k, v in import_dla(
        load_torch_state_dict(model_path, trusted), model.backbone).items()}
    out.update({f"processor.{k}": v for k, v in import_lore_processor(
        load_torch_state_dict(processor_path, trusted),
        model.processor).items()})
    return out


# ---------------- LISTER: FocalNet and the NeighborDecoder ----------------


def _focal_block(m: _Mapper, mod: nn.Module, dst: str, src: str) -> None:
    """One torch FocalNetBlock (feature_extractor.py:142): the FocalNet
    stages and LISTER's FEM merge blocks."""
    p = m.p
    m.copy(dst + "norm1", src + "norm1")
    for part in ("f", "proj"):
        m.copy(f"{dst}modulation.{part}", f"{src}modulation.{part}")
    m.put(dst + "modulation.h.weight",
          p[src + "modulation.h.weight"][:, :, 0, 0])
    m.put(dst + "modulation.h.bias", p[src + "modulation.h.bias"])
    for level in range(mod.modulation.focal_level):
        m.put(f"{dst}modulation.focal_{level}.weight",
              p[f"{src}modulation.focal_layers.{level}.0.weight"])
    m.copy(dst + "norm2", src + "norm2")
    m.copy(dst + "mlp_fc1", src + "mlp.fc1")
    m.copy(dst + "mlp_fc2", src + "mlp.fc2")
    m.put(dst + "gamma_1", p[src + "gamma_1"])     # layerscale (lrf)
    m.put(dst + "gamma_2", p[src + "gamma_2"])


def import_focalnet(sd: Dict[str, torch.Tensor],
                    model: nn.Module) -> Dict[str, torch.Tensor]:
    """A LISTER FocalNet-lrf state dict (OCR/LISTER/model/
    feature_extractor.py) into the port's `FocalNet`. Reference keys, all
    under LISTER's `encoder.`: patch_embed.proj.{conv0, norm0, conv1_0, norm_1, conv1_1, conv2_0,
    norm2, conv2_1, conv3} (the Stem; conv3 is a Linear), patch_embed.norm,
    layers.{s}.blocks.{b}.*, layers.{s}.downsample.{proj, norm}, norm."""
    m = _Mapper(sd, model, "import_focalnet", "encoder.")
    for ours, theirs in (("conv0", "conv0"), ("conv1_0", "conv1_0"),
                         ("conv1_1", "conv1_1"), ("conv2_0", "conv2_0"),
                         ("conv2_1", "conv2_1")):
        m.copy(f"stem.{ours}.Conv_0", f"patch_embed.proj.{theirs}")
    for ours, theirs in (("norm0", "norm0"), ("norm1", "norm_1"),
                         ("norm2", "norm2"), ("conv3", "conv3")):
        m.copy(f"stem.{ours}", f"patch_embed.proj.{theirs}")
    m.copy("stem_norm", "patch_embed.norm")
    cfg = model.config
    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            _focal_block(m, getattr(model, f"stage{s}_block{b}"),
                         f"stage{s}_block{b}.", f"layers.{s}.blocks.{b}.")
        if s < len(cfg.depths) - 1:
            m.copy(f"downsample{s}.Conv_0", f"layers.{s}.downsample.proj")
            m.copy(f"ds_norm{s}", f"layers.{s}.downsample.norm")
    m.copy("norm", "norm")
    return m.finish()


def import_lister(sd: Dict[str, torch.Tensor], model: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """A full LISTER checkpoint (OCR/LISTER/model/model.py:40: the
    FocalNet encoder, and nb_decoder.py:98's NeighborDecoder with the
    BilinearLayer navigator, la_utils.py's LocalAttentionModule and the
    FeatureMapEnhancer) into the port's `LISTER`."""
    out = {f"encoder.{k}": v
           for k, v in import_focalnet(sd, model.encoder).items()}
    dec = model.decoder
    m = _Mapper(sd, dec, "import_lister", "decoder.")
    p = m.p
    m.put("eos_emb", p["eos_emb"])
    for part in ("q_fc", "k_fc", "vis_cls"):
        m.copy(part, part)
    # BilinearLayer with out=1: y = q · W[0] · k + b[0] (nb_decoder.py:43)
    m.put("neighbor_navigator.weight", p["neighbor_navigator.weight"][0])
    m.put("neighbor_navigator.bias", p["neighbor_navigator.bias"][0])
    if dec.config.iters > 0:
        for i in range(dec.cntx_module.num_layers):
            src, dst = f"cntx_module.attn_blocks.{i}.", "cntx_module."
            m.put(f"{dst}gamma1_{i}", p[src + "gamma_1"])
            m.put(f"{dst}gamma2_{i}", p[src + "gamma_2"])
            m.copy(f"{dst}norm1_{i}", src + "norm1")
            m.copy(f"{dst}norm2_{i}", src + "norm2")
            for part in ("q_fc", "kv_fc", "proj"):
                m.copy(f"{dst}sa_{i}.{part}", f"{src}sa.{part}")
            if hasattr(getattr(dec.cntx_module, f"sa_{i}"), "kv_pos_bias"):
                m.put(f"{dst}sa_{i}.kv_pos_bias", p[src + "sa.kv_pos_bias"])
            # torch mlp: Linear(0), GELU, Dropout, Linear(3)
            m.copy(f"{dst}mlp_fc1_{i}", src + "mlp.0")
            m.copy(f"{dst}mlp_fc2_{i}", src + "mlp.3")
        m.copy("merge_layer.norm1", "merge_layer.norm1")
        m.copy("merge_layer.norm2", "merge_layer.norm2")
        for i in range(dec.merge_layer.num_layers):
            _focal_block(m, getattr(dec.merge_layer, f"merge_{i}"),
                         f"merge_layer.merge_{i}.",
                         f"merge_layer.merge_layer.{i}.")
    out.update({f"decoder.{k}": v for k, v in m.finish().items()})
    return out



# ---------------- LevOCR: ABINet vision, LevT, the whole model ----------------


def import_abinet_vision(sd: Dict[str, torch.Tensor],
                         model: nn.Module) -> Dict[str, torch.Tensor]:
    """LevOCR's BaseVision (OCR/LevOCR/abinet: resnet.py:50 ResNet45,
    backbone.py:13 ResTranformer, model_vision.py:23 PositionAttention,
    :75 BaseVision), keys under LevOCR's `vision.`, into the port's
    `ABINetVision`. The sincos position tables are fixed on both sides and
    not imported.

    The U-Net key path's convs carry a bias in the reference
    (`nn.Conv2d` defaults to one) and feed an eval-mode BatchNorm, which the
    port's `ConvBN` has no conv bias for: BN((x + b) - mean) = BN(x - (mean
    - b)), so each bias is folded into its BatchNorm's running mean. (The
    JAX importer reads these biases not at all.)"""
    m = _Mapper(sd, model, "import_abinet_vision", "vision.")
    p = m.p

    def conv_bn(dst: str, conv: str, bn: str, bias: bool = False) -> None:
        m.put(f"{dst}.conv.weight", p[f"{conv}.weight"])
        m.bn(f"{dst}.bn", bn)
        if bias:
            m.put(f"{dst}.bn.running_mean",
                  p[f"{bn}.running_mean"] - p[f"{conv}.bias"])

    conv_bn("resnet.stem", "backbone.resnet.conv1", "backbone.resnet.bn1")
    for s, (_, blocks, _) in enumerate(model.resnet.PLAN):
        for b in range(blocks):
            src, dst = f"backbone.resnet.layer{s + 1}.{b}.", \
                f"resnet.layer{s}_block{b}."
            conv_bn(dst + "conv1", src + "conv1", src + "bn1")
            conv_bn(dst + "conv2", src + "conv2", src + "bn2")
            if getattr(model.resnet, f"layer{s}_block{b}").downsample:
                conv_bn(dst + "downsample", src + "downsample.0",
                        src + "downsample.1")
    for i in range(model.config.backbone_layers):
        src = f"backbone.transformer.layers.{i}."
        m.put(f"tfm{i}.qkv.weight", p[src + "self_attn.in_proj_weight"])
        m.put(f"tfm{i}.qkv.bias", p[src + "self_attn.in_proj_bias"])
        for ours, theirs in (("proj", "self_attn.out_proj"),
                             ("ff1", "linear1"), ("ff2", "linear2"),
                             ("norm1", "norm1"), ("norm2", "norm2")):
            m.copy(f"tfm{i}.{ours}", src + theirs)
    for j in range(4):
        # encoder_layer: Sequential(conv, bn, relu); decoder_layer:
        # Sequential(upsample, conv, bn, relu)
        conv_bn(f"attention.k_enc{j}", f"attention.k_encoder.{j}.0",
                f"attention.k_encoder.{j}.1", bias=True)
        conv_bn(f"attention.k_dec{j}", f"attention.k_decoder.{j}.1",
                f"attention.k_decoder.{j}.2", bias=True)
    m.copy("attention.project", "attention.project")
    m.copy("cls", "cls")
    return m.finish()


def _levt_layer(m: _Mapper, dst: str, src: str) -> None:
    """A fairseq TransformerDecoderLayer (levt/transformer_layer.py:
    separate q/k/v projections, post-norm; its cross-attention never runs,
    levenshtein_transformer.py:459) → `PostNormSelfAttnLayer`."""
    for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                         ("v", "self_attn.v_proj"),
                         ("out", "self_attn.out_proj"), ("ff1", "fc1"),
                         ("ff2", "fc2"), ("norm1", "self_attn_layer_norm"),
                         ("norm2", "final_layer_norm")):
        m.copy(dst + ours, src + theirs)


def import_levt(sd: Dict[str, torch.Tensor],
                model: nn.Module) -> Dict[str, torch.Tensor]:
    """The LevT half of a LevOCR checkpoint, keys under `levt.`
    (levenshtein_transformer.py:387 the BERT-embedded text stack, :523 the
    fusion stack and its tied heads), into `model.text_encoder` and
    `model.decoder` of the port's `LevOCR`. Position tables longer than the
    model's are sliced; the text stack's constant token-type row is folded
    into its position table. fairseq ties the decoder's input and output
    embeddings, so the state dict names one tensor twice: both are read,
    and a checkpoint in which they differ raises `ValueError`."""
    parts = nn.ModuleDict({"text_encoder": model.text_encoder,
                           "decoder": model.decoder})
    m = _Mapper(sd, parts, "import_levt", "levt.")
    p = m.p
    emb = "encoder.text_embeddings."
    L = model.config.max_len
    m.put("text_encoder.word_emb.weight", p[emb + "word_embeddings.weight"])
    m.put("text_encoder.pos_emb.weight",
          p[emb + "position_embeddings.weight"][:L]
          + p[emb + "token_type_embeddings.weight"][0][None])
    m.copy("text_encoder.emb_ln", emb + "LayerNorm")
    for i in range(model.config.layers):
        _levt_layer(m, f"text_encoder.layer_{i}.", f"encoder.layers.{i}.")
    out_proj = p["decoder.output_projection.weight"]
    if "decoder.embed_tokens.weight" in p and not torch.equal(
            p["decoder.embed_tokens.weight"], out_proj):
        raise ValueError(
            "import_levt: decoder.embed_tokens.weight differs from "
            "decoder.output_projection.weight; the reference always ties "
            "them (share_decoder_input_output_embed)")
    m.put("decoder.word_emb_out.weight", out_proj)
    for ours, theirs in (("mask_ins_emb", "embed_mask_ins"),
                         ("word_del_emb", "embed_word_del"),
                         ("type_emb", "token_type_embeddings"),
                         ("img_proj", "img_embed_dim")):
        m.put(f"decoder.{ours}.weight", p[f"decoder.{theirs}.weight"])
    m.put("decoder.text_pos", p["decoder.text_pos_emb"][:, :L])
    m.put("decoder.img_pos",
          p["decoder.img_pos_emb"][:, :model.decoder.img_pos.shape[1]])
    for i in range(model.config.layers):
        _levt_layer(m, f"decoder.layer_{i}.", f"decoder.layers.{i}.")
    return m.finish()


def import_levocr(sd: Dict[str, torch.Tensor], model: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """A whole LevOCR checkpoint (models.py:145 LevOCRModel: `vision.*`,
    the image-token convs `conv4_1`/`bn4_1` and `conv4_2`/`bn4_2`, and
    `levt.*`) into the port's `LevOCR`; returns its state dict. Tensors
    outside those names that nothing reads are reported as unused."""
    out = {f"vision.{k}": v for k, v in
           import_abinet_vision(sd, model.vision).items()}
    out.update(import_levt(sd, model))
    rest = {k: v for k, v in sd.items()
            if not k.startswith(("vision.", "levt."))}
    convs = nn.ModuleDict({"img_conv1": model.img_conv1,
                           "img_conv2": model.img_conv2})
    m = _Mapper(rest, convs, "import_levocr")
    for ours, conv, bn in (("img_conv1", "conv4_1", "bn4_1"),
                           ("img_conv2", "conv4_2", "bn4_2")):
        m.put(f"{ours}.conv.weight", m.p[f"{conv}.weight"])
        m.bn(f"{ours}.bn", bn)
    out.update(m.finish())
    return out


# ---------------- OmniParser: Swin, FPN, decoders ----------------


def import_swin(sd: Dict[str, torch.Tensor],
                model: nn.Module) -> Dict[str, torch.Tensor]:
    """OmniParser's Swin backbone (model/backbone/swin_transformer.py, the
    Joiner's element 0: keys under `backbone.0.`) into the port's
    `SwinTransformer`: patch_embed.proj/.norm, layers.{s}.blocks.{b}.
    {norm1, attn.{qkv, proj, relative_position_bias_table}, norm2,
    mlp.fc1/fc2}, layers.{s}.downsample.{reduction, norm} and the per-stage
    output norms norm{s} (a classification checkpoint has none: those stay
    the identity). The relative_position_index buffer is recomputed, not
    imported."""
    m = _Mapper(sd, model, "import_swin", "backbone.0.")
    p = m.p
    m.copy("patch_embed", "patch_embed.proj")
    m.copy("patch_norm", "patch_embed.norm")
    cfg = model.config
    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            dst, src = f"stage{s}_block{b}.", f"layers.{s}.blocks.{b}."
            for part in ("norm1", "attn.qkv", "attn.proj", "norm2"):
                m.copy(dst + part, src + part)
            m.copy(dst + "mlp_fc1", src + "mlp.fc1")
            m.copy(dst + "mlp_fc2", src + "mlp.fc2")
            m.put(dst + "attn.relative_position_bias_table",
                  p[src + "attn.relative_position_bias_table"])
        if s < len(cfg.depths) - 1:
            src = f"layers.{s}.downsample."
            m.put(f"merge{s}.reduction.weight", p[src + "reduction.weight"])
            m.copy(f"merge{s}.norm", src + "norm")
        dim = cfg.stage_dims[s]
        if f"norm{s}.weight" in p:
            m.copy(f"out_norm{s}", f"norm{s}")
        else:
            m.put(f"out_norm{s}.weight", torch.ones(dim))
            m.put(f"out_norm{s}.bias", torch.zeros(dim))
    return m.finish()


def _omni_decoder_layer(m: _Mapper, dst: str, src: str) -> None:
    """One DETR pre-norm decoder layer (reference model/transformer.py:380
    TransformerDecoderLayer): torch MultiheadAttention packs q|k|v rows in
    in_proj_weight [3D, D]."""
    p = m.p
    for attn, ours in (("self_attn", "sa"), ("multihead_attn", "ca")):
        w = p[f"{src}{attn}.in_proj_weight"]
        b = p[f"{src}{attn}.in_proj_bias"]
        D = w.shape[1]
        for j, which in enumerate(("q", "k", "v")):
            m.put(f"{dst}{ours}_{which}.weight", w[j * D:(j + 1) * D])
            m.put(f"{dst}{ours}_{which}.bias", b[j * D:(j + 1) * D])
        m.copy(f"{dst}{ours}_out", f"{src}{attn}.out_proj")
    m.copy(dst + "ff1", src + "linear1")
    m.copy(dst + "ff2", src + "linear2")
    for n in ("norm1", "norm2", "norm3"):
        m.copy(dst + n, src + n)


def import_omniparser(sd: Dict[str, torch.Tensor],
                      model: nn.Module) -> Dict[str, torch.Tensor]:
    """A full OmniParser checkpoint into the port's `OmniParser`; returns
    its state dict. Covers everything the reference Checkpointer loads
    (OCR/OmniParser/utils/checkpointer.py:5): the Swin backbone
    (`import_swin`), the FPN laterals (model/fpn.py:17: fpn_in[0..3] read
    c5..c2, the order of lat0..3; 1x1 convs with no bias, so the port's
    lateral biases are zero), input_proj (a 1x1 stride-2 conv), the
    DecoderEmbeddings (word + 3 task position embeddings + LayerNorm,
    model/transformer.py:283-328; the unused `other_position_embeddings` is
    skipped), and the three task decoders with their 3-layer MLP pred heads
    (model/transformer.py:26-37).

    For VIE checkpoints with added categories, import into a model of the
    checkpoint's vocabulary, then grow it with `resize_embedding`, as
    checkpointer.py:9 does."""
    out = {f"backbone.{k}": v
           for k, v in import_swin(sd, model.backbone).items()}
    rest = nn.ModuleDict({name: getattr(model, name) for name in (
        "fpn", "input_proj", "embedding", "pt_decoder", "poly_decoder",
        "rec_decoder")})
    m = _Mapper({k: v for k, v in sd.items()
                 if not k.startswith("backbone.0.")}, rest,
                "import_omniparser")
    p = m.p
    for i in range(4):
        w = p[f"fpn.fpn_in.{i}.weight"]           # [256, cin, 1, 1]
        m.put(f"fpn.lat{i}.weight", w[:, :, 0, 0])
        bias = f"fpn.fpn_in.{i}.bias"
        m.put(f"fpn.lat{i}.bias",
              p[bias] if bias in p else torch.zeros(w.shape[0]))
    m.copy("input_proj", "input_proj")
    e = "transformer.embedding."
    m.put("embedding.word.weight", p[e + "word_embeddings.weight"])
    for t in ("pt", "poly", "rec"):
        m.put(f"embedding.{t}_pos.weight",
              p[f"{e}{t}_position_embeddings.weight"])
    _ = f"{e}other_position_embeddings.weight" in p     # read, unused
    m.copy("embedding.ln", e + "LayerNorm")
    for t in ("pt", "poly", "rec"):
        dec = getattr(model, f"{t}_decoder")
        for i in range(len(dec.layers)):
            _omni_decoder_layer(m, f"{t}_decoder.layer_{i}.",
                                f"transformer.{t}_decoder.layers.{i}.")
        m.copy(f"{t}_decoder.final_norm", f"transformer.{t}_decoder.norm")
        for j, h in enumerate(("head1", "head2", "head3")):
            m.copy(f"{t}_decoder.{h}",
                   f"transformer.{t}_pred_layer.layers.{j}")
    out.update(m.finish())
    return out


def resize_embedding(model: nn.Module, old: Dict[str, torch.Tensor],
                     grown_keys, added_rows: int) -> Dict[str, torch.Tensor]:
    """Checkpoint surgery when fine-tuning adds vocabulary entries
    (reference OmniParser utils/checkpointer.py:9 resize_embedding): the
    old tensors fill rows [:-added_rows] of the grown tables `grown_keys`
    (embeddings, a head's Linear weight [out, in] and bias: rows on axis
    0), whose last rows keep `model`'s values; every other tensor of
    `model` takes `old`'s as it is. Loads the result into `model`
    (strict) and returns it. A shape that fits neither rule raises
    `ValueError`."""
    grown_keys = set(grown_keys)
    out = {}
    for key, new in model.state_dict().items():
        o = old[key].to(new.dtype).cpu()
        if key in grown_keys:
            if (new.shape[0] != o.shape[0] + added_rows
                    or new.shape[1:] != o.shape[1:]):
                raise ValueError(f"resize_embedding: unexpected resize "
                                 f"{tuple(o.shape)} → {tuple(new.shape)} at "
                                 f"{key}")
            o = torch.cat([o, new[-added_rows:].cpu()])
        elif o.shape != new.shape:
            raise ValueError(f"resize_embedding: shape mismatch at {key}: "
                             f"{tuple(o.shape)} vs {tuple(new.shape)}")
        out[key] = o
    model.load_state_dict(out, strict=True)
    return out
