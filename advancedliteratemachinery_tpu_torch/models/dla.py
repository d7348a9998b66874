"""DLA-34 trunk with a deformable-conv upsampling neck and CenterNet heads
(port of `advancedliteratemachinery_tpu/models/dla.py`: DLASeg, reference
LORE-TSR pose_dla_dcn.py; and DLASegV0, the plain-conv v0 neck of
DocXLayout, reference dlav0_subfield.py).

Maps come in and go out NHWC, as in the JAX package. Inside, the network
runs in NCHW tensors kept in `channels_last` memory, so the NHWC view that
each deformable conv (`ops/deform_conv.py`) takes is the same memory and
costs no copy. Convs use flax's explicit symmetric padding `k // 2`.
BatchNorm runs in float32 (eps 1e-5): in eval mode, the default, as flax's
`train=False`, on running statistics; in `train()` mode on the batch's
statistics, updating the running ones as flax's `mutable=["batch_stats"]`
does (`models/layers.py` `batch_norm`). The transposed up kernels stay
trainable. Submodules carry the flax names, so `engine/convert.py` maps a
flax tree onto them one to one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.models.layers import (
    BN_EPS, batch_norm, conv2d, init_params, lecun_normal_)
from advancedliteratemachinery_tpu_torch.ops.deform_conv import DeformConv2d

HM_BIAS = -2.19   # focal-loss warm start of the heatmap heads


class ConvBnRelu(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.relu = relu
        self.conv = nn.Conv2d(in_ch, features, kernel, stride,
                              padding=kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        x = batch_norm(conv2d(x, self.conv, c), self.bn)
        return (F.relu(x) if self.relu else x).to(c)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.conv1 = ConvBnRelu(in_ch, planes, 3, stride, policy=policy)
        self.conv2 = ConvBnRelu(planes, planes, 3, relu=False, policy=policy)

    def forward(self, x: torch.Tensor, residual: torch.Tensor = None
                ) -> torch.Tensor:
        if residual is None:
            residual = x
        return F.relu(self.conv2(self.conv1(x)) + residual)


class Root(nn.Module):
    def __init__(self, in_ch: int, features: int, residual: bool,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.residual = residual
        self.conv = ConvBnRelu(in_ch, features, 1, relu=False, policy=policy)

    def forward(self, *children: torch.Tensor) -> torch.Tensor:
        x = self.conv(torch.cat(children, dim=1))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    def __init__(self, levels: int, in_channels: int, out_channels: int,
                 stride: int = 1, level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.levels, self.stride, self.level_root = levels, stride, level_root
        root_dim = root_dim or 2 * out_channels
        if level_root:
            root_dim += in_channels
        # built at every level, as flax builds it, but read only by a leaf
        self.project = (ConvBnRelu(in_channels, out_channels, 1, relu=False,
                                   policy=policy)
                        if in_channels != out_channels else None)
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride,
                                    policy=policy)
            self.tree2 = BasicBlock(out_channels, out_channels, 1,
                                    policy=policy)
            self.root = Root(root_dim, out_channels, root_residual,
                             policy=policy)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_residual=root_residual, policy=policy)
            self.tree2 = Tree(levels - 1, out_channels, out_channels, 1,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual, policy=policy)

    def forward(self, x: torch.Tensor,
                children: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        children = list(children)
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            project = (self.project(bottom) if self.project is not None
                       else bottom)
            x1 = self.tree1(x, project)
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        if self.project is not None and self.training:
            # flax runs this projection at every level and reads it only at
            # a leaf; in train mode its BatchNorm still updates its running
            # statistics, and its parameters get zero gradients
            self.project(bottom)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


@dataclasses.dataclass(frozen=True)
class DLAConfig:
    levels: Tuple[int, ...] = (1, 1, 1, 2, 2, 1)
    channels: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    in_chans: int = 3


class DLA(nn.Module):
    """dla34 trunk: 6 pyramid levels, strides 1..32 (pose_dla_dcn.py:224)."""

    def __init__(self, config: DLAConfig = DLAConfig(),
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        ch, lv = config.channels, config.levels
        self.base_layer = ConvBnRelu(config.in_chans, ch[0], 7, policy=policy)
        self.level0 = ConvBnRelu(ch[0], ch[0], 3, policy=policy)
        self.level1 = ConvBnRelu(ch[0], ch[1], 3, 2, policy=policy)
        for i in range(2, 6):
            self.add_module(f"level{i}", Tree(lv[i], ch[i - 1], ch[i], 2,
                                              level_root=i > 2,
                                              policy=policy))

    def unread_parameters(self) -> List[nn.Parameter]:
        """The parameters of the projections of Trees above their leaves,
        which no output reads (their gradients are zero)."""
        return [p for m in self.modules()
                if isinstance(m, Tree) and m.levels > 1
                and m.project is not None for p in m.project.parameters()]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.level0(self.base_layer(x))
        y = [x]
        for i in range(1, 6):
            x = getattr(self, f"level{i}")(x)
            y.append(x)
        return y


def _bilinear_upsample_kernel(f: int) -> np.ndarray:
    """fill_up_weights (pose_dla_dcn.py:334): bilinear kernel [2f, 2f]."""
    k = f * 2
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w = np.zeros((k, k), np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    return w


class UpsampleBilinear(nn.Module):
    """Depthwise transposed conv by `factor` (reference ConvTranspose2d(o,
    o, 2f, stride=f, padding=f//2, groups=o)), bilinear-initialized and
    trainable. `kernel` keeps the flax layout [2f, 2f, C]. The JAX module's
    literal form convolves the f-dilated input with the flipped kernel at
    padding 2f-1-f//2; that is a transposed conv with the kernel as it is."""

    def __init__(self, factor: int, channels: int):
        super().__init__()
        self.factor = factor
        self.kernel = nn.Parameter(torch.empty(2 * factor, 2 * factor,
                                               channels))

    def reset_bilinear(self) -> None:
        w = torch.from_numpy(_bilinear_upsample_kernel(self.factor))
        with torch.no_grad():
            self.kernel.copy_(w[:, :, None].expand_as(self.kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.factor
        w = self.kernel.permute(2, 0, 1)[:, None].to(x.dtype)
        return F.conv_transpose2d(x, w, stride=f, padding=f // 2,
                                  groups=x.shape[1])


class DeformUpBlock(nn.Module):
    """DeformConv + BN + ReLU (pose_dla_dcn.py:345); NCHW in and out."""

    def __init__(self, in_ch: int, features: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.dcn = DeformConv2d(in_ch, features, policy=policy)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dcn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return F.relu(batch_norm(y, self.bn)).to(self.policy.compute_dtype)


class IDAUp(nn.Module):
    """Iterative deep aggregation of a pyramid slice to a common resolution
    (pose_dla_dcn.py:361). A factor-1 up is the identity and has no
    kernel, as in the JAX module."""

    def __init__(self, out_channels: int, in_channels: Sequence[int],
                 up_factors: Sequence[int], policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.n = len(in_channels)
        self.up_factors = [int(f) for f in up_factors]
        for i in range(1, self.n):
            self.add_module(f"proj_{i}", DeformUpBlock(
                in_channels[i], out_channels, policy))
            if self.up_factors[i] != 1:
                self.add_module(f"up_{i}", UpsampleBilinear(
                    self.up_factors[i], out_channels))
            self.add_module(f"node_{i}", DeformUpBlock(
                out_channels, out_channels, policy))

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(1, self.n):
            x = getattr(self, f"proj_{i}")(layers[i])
            if self.up_factors[i] != 1:
                x = getattr(self, f"up_{i}")(x)
            layers[i] = getattr(self, f"node_{i}")(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Full pyramid aggregation (pose_dla_dcn.py:390)."""

    def __init__(self, channels: Sequence[int],
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        channels = list(channels)
        scales = [2 ** i for i in range(len(channels))]
        in_ch = list(channels)
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            self.add_module(f"ida_{i}", IDAUp(
                channels[j], in_ch[j:], [s // scales[j] for s in scales[j:]],
                policy))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_ch[j + 1:] = [channels[j]] * len(in_ch[j + 1:])

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n):
            j = -i - 2
            layers[j:] = getattr(self, f"ida_{i}")(layers[j:])
            out.insert(0, layers[-1])
        return out


@dataclasses.dataclass(frozen=True)
class DLASegConfig:
    dla: DLAConfig = DLAConfig()
    down_ratio: int = 4
    last_level: int = 5
    head_conv: int = 256
    heads: Tuple[Tuple[str, int], ...] = (
        ("hm", 2), ("st", 8), ("wh", 8), ("ax", 256), ("cr", 256), ("reg", 2),
    )


class DLASeg(nn.Module):
    """DLA trunk + DLAUp/IDAUp neck + per-task conv heads
    (pose_dla_dcn.py:428). Built on `device` (the GPU unless
    `device="cpu"`) with random weights from `seed`; load real weights with
    `engine.convert`."""

    def __init__(self, config: DLASegConfig = DLASegConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.policy = policy
        self.first = first = int(math.log2(cfg.down_ratio))
        ch = cfg.dla.channels
        self.base = DLA(cfg.dla, policy)
        self.dla_up = DLAUp(ch[first:], policy)
        n = cfg.last_level - first
        self.ida_up = IDAUp(ch[first], ch[first:cfg.last_level],
                            [2 ** i for i in range(n)], policy)
        for head, classes in cfg.heads:
            self.add_module(f"{head}_conv1", nn.Conv2d(
                ch[first], cfg.head_conv, 3, padding=1))
            self.add_module(f"{head}_out", nn.Conv2d(cfg.head_conv, classes,
                                                     1))
        # the JAX package's init: flax defaults, lecun-normal DCN kernels,
        # zero offset/mask convs, bilinear up kernels, the hm heads' bias
        gen = torch.Generator().manual_seed(seed)
        init_params(self, gen)
        for m in self.modules():
            if isinstance(m, DeformConv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), gen)
                nn.init.zeros_(m.conv_offset_mask.weight)
                nn.init.zeros_(m.conv_offset_mask.bias)
            elif isinstance(m, UpsampleBilinear):
                m.reset_bilinear()
        for head, _ in cfg.heads:
            if "hm" in head:
                nn.init.constant_(getattr(self, f"{head}_out").bias, HM_BIAS)
        self.to(device).eval()

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, H, W, C] → {head: [B, H/4, W/4, classes] float32}."""
        cfg = self.config
        c = self.policy.compute_dtype
        x = images.to(c).permute(0, 3, 1, 2)        # channels_last NCHW
        feats = self.base(x)
        pyramid = self.dla_up(feats[self.first:])
        feat = self.ida_up(pyramid[:cfg.last_level - self.first])[-1]
        out = {}
        for head, _ in cfg.heads:
            h = F.relu(conv2d(feat, getattr(self, f"{head}_conv1"), c))
            h = conv2d(h, getattr(self, f"{head}_out"), c)
            out[head] = h.float().permute(0, 2, 3, 1)
        return out


# ---------------- DLA-v0 neck (DocXLayout) ----------------
# Reference DocumentUnderstanding/DocXLayout/models/networks/
# dlav0_subfield.py. Unlike the DCN neck above there is no deformable conv:
# every input level with another width is projected (conv1x1 + BN + ReLU,
# the first level included), upsampled by the fixed-bilinear transposed
# conv, and each node is a conv3x3 + BN + ReLU over the channel
# concatenation of the running aggregate with the next level. `proj_{i}`
# and `node_{i}` are the JAX package's ProjV0 and NodeV0 (a `conv` and a
# float32 `bn`), which is `ConvBnRelu`.


class IDAUpV0(nn.Module):
    """dlav0 IDAUp: project and upsample every level, then chain the
    concat nodes. Returns (the final aggregate, the node outputs)."""

    def __init__(self, out_channels: int, in_channels: Sequence[int],
                 up_factors: Sequence[int], policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.n = len(in_channels)
        self.projected = [c != out_channels for c in in_channels]
        self.up_factors = [int(f) for f in up_factors]
        for i, (c, f) in enumerate(zip(in_channels, self.up_factors)):
            if self.projected[i]:
                self.add_module(f"proj_{i}", ConvBnRelu(c, out_channels, 1,
                                                        policy=policy))
            if f != 1:
                self.add_module(f"up_{i}", UpsampleBilinear(f, out_channels))
        for i in range(1, self.n):
            self.add_module(f"node_{i}", ConvBnRelu(2 * out_channels,
                                                    out_channels, 3,
                                                    policy=policy))

    def forward(self, layers: Sequence[torch.Tensor]):
        layers = list(layers)
        for i in range(self.n):
            x = layers[i]
            if self.projected[i]:
                x = getattr(self, f"proj_{i}")(x)
            if self.up_factors[i] != 1:
                x = getattr(self, f"up_{i}")(x)
            layers[i] = x
        x = layers[0]
        ys = []
        for i in range(1, self.n):
            x = getattr(self, f"node_{i}")(torch.cat([x, layers[i]], dim=1))
            ys.append(x)
        return x, ys


class DLAUpV0(nn.Module):
    """dlav0 DLAUp: aggregate the pyramid down to the first level's
    resolution; returns the final aggregate map."""

    def __init__(self, channels: Sequence[int],
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        channels = list(channels)
        scales = [2 ** i for i in range(len(channels))]
        in_ch = list(channels)
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            self.add_module(f"ida_{i}", IDAUpV0(
                channels[j], in_ch[j:], [s // scales[j] for s in scales[j:]],
                policy))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_ch[j + 1:] = [channels[j]] * len(in_ch[j + 1:])

    def forward(self, layers: Sequence[torch.Tensor]) -> torch.Tensor:
        layers = list(layers)
        x = layers[-1]
        for i in range(self.n):
            j = -i - 2
            x, ys = getattr(self, f"ida_{i}")(layers[j:])
            layers[j + 1:] = ys
        return x


class DLASegV0(nn.Module):
    """dlav0_subfield DLASeg: DLA trunk → DLAUpV0 → per-task heads
    (conv3x3 + ReLU + conv1x1; the hm* heads' bias starts at -2.19). Built
    on `device` (the GPU unless `device="cpu"`) with random weights from
    `seed`; load real weights with `engine.convert` or
    `engine.checkpoint.import_docxlayout`."""

    def __init__(self, config: DLASegConfig = DLASegConfig(),
                 policy: Policy = DEFAULT_POLICY,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.policy = policy
        self.first = first = int(math.log2(cfg.down_ratio))
        ch = cfg.dla.channels
        self.base = DLA(cfg.dla, policy)
        self.dla_up = DLAUpV0(ch[first:], policy)
        for head, classes in cfg.heads:
            self.add_module(f"{head}_conv1", nn.Conv2d(
                ch[first], cfg.head_conv, 3, padding=1))
            self.add_module(f"{head}_out", nn.Conv2d(cfg.head_conv, classes,
                                                     1))
        init_params(self, torch.Generator().manual_seed(seed))
        for m in self.modules():
            if isinstance(m, UpsampleBilinear):
                m.reset_bilinear()
        for head, _ in cfg.heads:
            if "hm" in head:
                nn.init.constant_(getattr(self, f"{head}_out").bias, HM_BIAS)
        self.to(device).eval()

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, H, W, C] → {head: [B, H/4, W/4, classes] float32}."""
        c = self.policy.compute_dtype
        x = images.to(c).permute(0, 3, 1, 2)        # channels_last NCHW
        feat = self.dla_up(self.base(x)[self.first:])
        out = {}
        for head, _ in self.config.heads:
            h = F.relu(conv2d(feat, getattr(self, f"{head}_conv1"), c))
            h = conv2d(h, getattr(self, f"{head}_out"), c)
            out[head] = h.float().permute(0, 2, 3, 1)
        return out
