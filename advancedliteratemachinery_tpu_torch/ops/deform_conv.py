"""Modulated deformable convolution v2 (DCNv2).

Port of `advancedliteratemachinery_tpu/ops/deform_conv.py`: for each output
position p and kernel tap k,

    out(p) = sum_k W_k . m_k(p) . bilinear(x, p.stride - pad + k.dilation
                                              + offset_k(p))

with zero outside the image and modulation mask m_k. Layout is the JAX
package's: x NHWC, offsets [B, Ho, Wo, K, 2] as (dy, dx), mask
[B, Ho, Wo, K], weights HWIO [kh, kw, Cin, Cout]. Sample coordinates are
always float32, formed from the (possibly bf16) offsets: a bf16 coordinate
grid loses the bilinear fraction past x=64.

On a CUDA tensor `deform_conv2d` launches the hand-written kernel in
`csrc/deform_conv.cu`, which is exact for every offset; on a CPU tensor it
runs the plain version below, which is also the kernel's reference on the
card. `DeformConv2d` asks `supports_deform_conv` which of the two to
take. The JAX package's windowed sampler, sparse correction and fallback
exist only to make its TPU kernel exact and have no counterpart here.

Under autograd `DeformConv2d` goes through `DeformConvFunction`, the port
of the JAX `_dcn_dispatch` custom VJP: its forward is the kernel (or the
plain version, by the same rule) run without recording a graph, and its
backward recomputes `deform_conv2d_plain` on the saved inputs and returns
that version's gradients for x, offsets, mask, weights and bias, as the
JAX backward returns the VJP of its gather form. The kernel itself is
never differentiated.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, Policy)
from advancedliteratemachinery_tpu_torch.ops import _kernels

KERNEL = "deform_conv"


def bilinear_gather(x: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of x [B, H, W, C] at float coordinates ys/xs
    [B, ...] → [B, ..., C] in float32; each corner outside the image
    contributes zero (reference `dmcn_im2col_bilinear`)."""
    B, H, W, C = x.shape
    out_shape = ys.shape
    ys = ys.reshape(B, -1).float()
    xs = xs.reshape(B, -1).float()
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    # clamping keeps far-off samples off the image and in integer range
    y0 = y0.clamp(-2, H).long()
    x0 = x0.clamp(-2, W).long()
    x_flat = x.reshape(B, H * W, C).float()
    rows = torch.arange(B, device=x.device)[:, None]

    def corner(yi, xi, w):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return x_flat[rows, idx] * (w * valid)[..., None]

    out = (corner(y0, x0, wy0 * wx0) + corner(y0, x0 + 1, wy0 * wx1)
           + corner(y0 + 1, x0, wy1 * wx0)
           + corner(y0 + 1, x0 + 1, wy1 * wx1))
    return out.reshape(*out_shape, C)


def _out_size(H: int, W: int, kh: int, kw: int, stride: int, padding: int,
              dilation: int) -> Tuple[int, int]:
    return ((H + 2 * padding - dilation * (kh - 1) - 1) // stride + 1,
            (W + 2 * padding - dilation * (kw - 1) - 1) // stride + 1)


def deform_conv2d_plain(x: torch.Tensor, offsets: torch.Tensor,
                        mask: torch.Tensor, weights: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        stride: int = 1, padding: int = 1,
                        dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version, the per-tap gather form of the JAX package's
    `_dcn_full_gather`, for any stride, padding and dilation: each tap's
    sample is computed in float32, scaled by the mask and rounded to x's
    dtype (as the kernel rounds it), then contracted with W_k in float32;
    the sum is rounded to x's dtype before the bias is added in it."""
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = weights.shape
    K = kh * kw
    Ho, Wo = _out_size(H, W, kh, kw, stride, padding, dilation)
    dev = x.device
    taps = torch.arange(K, device=dev)
    base_y = ((torch.arange(Ho, device=dev) * stride - padding)[:, None, None]
              + (taps // kw * dilation)[None, None, :]).float()  # [Ho,1,K]
    base_x = ((torch.arange(Wo, device=dev) * stride - padding)[None, :, None]
              + (taps % kw * dilation)[None, None, :]).float()  # [1,Wo,K]
    ys = base_y + offsets[..., 0].float()
    xs = base_x + offsets[..., 1].float()
    wk = weights.reshape(K, Cin, Cout).float()
    out = torch.zeros(B, Ho, Wo, Cout, device=dev)
    for k in range(K):
        g = bilinear_gather(x, ys[..., k], xs[..., k])
        g = (g * mask[..., k, None].float()).to(x.dtype).float()
        out += g @ wk[k]
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def pack_weights(weights: torch.Tensor) -> torch.Tensor:
    """HWIO weights [kh, kw, Cin, Cout] → the kernel's [kh·kw, Cout, Cin8]:
    each tap's matrix as [out, in] rows, Cin padded with zeros to Cin8, the
    next multiple of 8, so that a row's pitch is a multiple of 16 bytes, as
    TMA requires."""
    kh, kw, cin, cout = weights.shape
    wt = weights.permute(0, 1, 3, 2).reshape(kh * kw, cout, cin)
    return F.pad(wt, (0, -cin % 8)).contiguous()


def supports_deform_conv(x_shape: Tuple[int, ...],
                         w_shape: Tuple[int, ...], stride: int, padding: int,
                         dilation: int, dtype: torch.dtype, device) -> bool:
    """Whether a module may send a DCN with input x [B, H, W, Cin] and
    weights [kh, kw, Cin, Cout] to the kernel: the stride and padding
    clauses of the JAX package's `dcn_windowed_pallas_supported` (stride 1,
    2·padding == dilation·(k − 1) on both axes: a same-size output) on a
    CUDA device in bf16, within the kernel's 32-bit element offsets. The
    JAX check's VMEM budget has no counterpart: the kernel streams its
    input."""
    B, H, W, Cin = x_shape
    kh, kw, _, Cout = w_shape
    pixels = B * H * W
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and stride == 1 and 2 * padding == dilation * (kh - 1)
            and 2 * padding == dilation * (kw - 1)
            and pixels * max(2 * Cin, Cout, 2 * kh * kw) < 2 ** 31)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                  weights: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin]; offsets [B, Ho, Wo, K, 2] (dy, dx); mask
    [B, Ho, Wo, K]; weights [kh, kw, Cin, Cout] → [B, Ho, Wo, Cout].

    CPU tensors take the plain version. CUDA tensors go through the kernel
    (stride 1, same-size output, every tensor bf16 and contiguous) or
    raise `ValueError`."""
    B, H, W, Cin = x.shape
    kh, kw, w_cin, Cout = weights.shape
    K = kh * kw
    Ho, Wo = _out_size(H, W, kh, kw, stride, padding, dilation)
    if (w_cin != Cin or tuple(offsets.shape) != (B, Ho, Wo, K, 2)
            or tuple(mask.shape) != (B, Ho, Wo, K)
            or (bias is not None and tuple(bias.shape) != (Cout,))):
        raise ValueError(
            f"deform_conv2d: x {tuple(x.shape)}, offsets "
            f"{tuple(offsets.shape)}, mask {tuple(mask.shape)}, weights "
            f"{tuple(weights.shape)} do not fit together")
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, mask, weights, bias, stride,
                                   padding, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if stride != 1 or (Ho, Wo) != (H, W):
        raise ValueError(
            f"deform_conv kernel takes stride 1 and a same-size output; got "
            f"stride {stride}, {H}x{W} -> {Ho}x{Wo}")
    tensors = [x, offsets, mask, weights] + ([bias] if bias is not None
                                             else [])
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("deform_conv kernel takes bf16 tensors; got "
                         f"{[t.dtype for t in tensors]}")
    # differentiable only through DeformConvFunction
    _kernels.refuse_grad(KERNEL, *tensors)
    if not all(t.is_contiguous() for t in (x, offsets, mask)):
        raise ValueError("x, offsets and mask must be contiguous")
    if offsets.data_ptr() % 4:       # read as (dy, dx) pairs
        raise ValueError("offsets must be 4-byte aligned")
    wt = pack_weights(weights)
    b = bias.contiguous() if bias is not None else None
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    fn = _kernels.kernel_function(
        KERNEL, "alm_deform_conv",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
             wt.data_ptr(), b.data_ptr() if b is not None else None,
             out.data_ptr(), B, H, W, Cin, Cout, kh, kw, padding, dilation,
             stream)
    _kernels.check(KERNEL, err)
    _kernels.count(KERNEL)
    return out


class DeformConvFunction(torch.autograd.Function):
    """A 3x3, stride-1, padding-1 DCN under autograd (JAX `_dcn_dispatch`
    with its custom VJP). Forward: the kernel where `supports_deform_conv`
    passes (the card, bf16), the plain version on other devices and
    dtypes; a bf16 CUDA tensor the kernel does not take raises. Backward:
    `deform_conv2d_plain` recomputed under grad on the saved inputs, in
    the dtypes the forward saw, and its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, x, offsets, mask, weights, bias):
        ctx.save_for_backward(x, offsets, mask, weights, bias)
        if supports_deform_conv(x.shape, weights.shape, 1, 1, 1, x.dtype,
                                x.device):
            return deform_conv2d(x, offsets, mask, weights, bias)
        if x.device.type == "cuda" and x.dtype == torch.bfloat16:
            raise ValueError(
                f"deform_conv kernel does not take x {tuple(x.shape)}, "
                f"weights {tuple(weights.shape)}")
        return deform_conv2d_plain(x, offsets, mask, weights, bias)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = deform_conv2d_plain(*inputs)
        return torch.autograd.grad(out, inputs, grad)


class DeformConv2d(nn.Module):
    """3x3, stride-1 DCN layer (JAX `DeformConv2d` at its defaults, the one
    form DLA's neck uses; reference DCN dcn_v2.py:147): a plain conv
    predicts 27 channels, split as flax splits them — dy [0, 9), dx [9, 18),
    mask logits [18, 27) — then `deform_conv2d` samples and contracts where
    `supports_deform_conv` passes (the card, bf16), and
    `deform_conv2d_plain` otherwise (the CPU, f32), as the JAX dispatch
    takes its Pallas kernel only where its check passes, through
    `DeformConvFunction` (differentiable, as the JAX dispatch is). Takes
    and returns NHWC. Offsets and mask are cast to the compute dtype
    before sampling; the bias is added in the output dtype. `weight` is
    OIHW, as `engine/convert.py` carries the flax `kernel`."""

    def __init__(self, in_ch: int, features: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.conv_offset_mask = nn.Conv2d(in_ch, 27, 3, padding=1)
        self.weight = nn.Parameter(torch.empty(features, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.compute_dtype
        x = x.to(c)
        com = self.conv_offset_mask
        om = F.conv2d(x.permute(0, 3, 1, 2), com.weight.to(c),
                      com.bias.to(c), padding=1).permute(0, 2, 3, 1)
        # the kernel reads offsets as (dy, dx) pairs and every map densely
        offsets = torch.stack([om[..., :9], om[..., 9:18]],
                              dim=-1).contiguous()
        mask = torch.sigmoid(om[..., 18:]).contiguous()
        w = self.weight.to(c).permute(2, 3, 1, 0)
        return DeformConvFunction.apply(x.contiguous(), offsets, mask, w,
                                        self.bias.to(c))
