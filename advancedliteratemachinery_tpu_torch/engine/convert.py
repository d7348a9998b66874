"""Carry weights from the JAX package to the port.

`flax_state_dict` takes a flax parameter tree (nested dicts of arrays:
`params`, and `batch_stats` for models with BatchNorm) and returns a state
dict for the port's module of the same architecture (DocXLayout's tree, for
one, under its `backbone` with the v0 neck's `proj_{i}`/`up_{i}`/`node_{i}`
and their BatchNorm `batch_stats`). The port's submodules carry the flax
names, so only the leaves change:

- conv kernel HWIO → `weight` OIHW;
- Dense kernel [in, out] → `Linear.weight` [out, in];
- GroupedPointwise kernel [G, in, out] and UpsampleBilinear kernel
  [2f, 2f, C] stay `kernel`, as they are;
- LayerNorm/BatchNorm `scale` → `weight`; BatchNorm `mean`/`var` →
  `running_mean`/`running_var`;
- Embed `embedding` [N, D] → `Embedding.weight`, as it is.

The LISTER baselines' GRU (`models/lister_baselines.py`) is flax's
`GRUCell` as its six Dense (`ir`, `iz`, `in`, `hr`, `hz`, `hn`, biases on
`ir`, `iz`, `in` and `hn` only), so the Dense rule maps it.

A tree made under flax's `train=True` carries the running statistics of
every BatchNorm in `batch_stats`; they land in the port's BatchNorm
buffers. Parameters a JAX module makes only under `train=True` (DB's
threshold head `thresh_*`) are named by the port's module in
`FLAX_TRAIN_ONLY`: a tree without them (an inference init) still maps, and
they keep the module's own values.

Other leaves (biases, LORE's std-norm `*_alpha`/`*_bias`, the FocalNet
and LISTER layerscale gammas, LISTER's `eos_emb`, `kv_pos_bias` and its
navigator's [C, C] `weight` and 0-d `bias`) carry over as they are.
Reference torch checkpoints take `engine/checkpoint.py` instead.

A missing key, an unused key or a shape mismatch raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _param_leaf(name: str, value: np.ndarray):
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    if leaf == "kernel" and t.ndim == 4:          # conv HWIO → OIHW
        leaf, t = "weight", t.permute(3, 2, 0, 1)
    elif leaf == "kernel" and t.ndim == 2:        # Dense [in, out]
        leaf, t = "weight", t.t()
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return (f"{path}.{leaf}" if path else leaf), t.contiguous()


_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def flax_state_dict(module: nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """Map flax `params` (+ `batch_stats`) onto `module`'s state dict."""
    sd = dict(_param_leaf(k, v) for k, v in _flatten(params).items())
    for k, v in _flatten(batch_stats or {}).items():
        path, leaf = k.rsplit(".", 1)
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"unexpected batch_stats leaf {k}")
        sd[f"{path}.{_STAT_LEAVES[leaf]}"] = torch.from_numpy(
            np.array(v, dtype=np.float32))
    want = module.state_dict()
    train_only = getattr(module, "FLAX_TRAIN_ONLY", ())
    for k, v in want.items():
        if k not in sd and (k.endswith("num_batches_tracked")  # torch-only
                            or k.startswith(train_only)):
            sd[k] = v.detach().cpu().clone()
    missing = sorted(set(want) - set(sd))
    unused = sorted(set(sd) - set(want))
    if missing or unused:
        raise KeyError(f"flax tree does not match {type(module).__name__}: "
                       f"missing {missing}, unused {unused}")
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: flax shape {tuple(sd[k].shape)} vs "
                             f"module shape {tuple(v.shape)}")
    return sd


def load_flax_params(module: nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Load a flax tree into `module` in place (strict) and return it."""
    sd = flax_state_dict(module, params, batch_stats)
    module.load_state_dict(sd, strict=True)
    return module
