"""Multi-head attention: the fused-qkv forward and backward, the short
sequence kernel on separate q/k/v, and the generic masked dispatch.

Port of `advancedliteratemachinery_tpu/ops/attention.py`:

- `fused_qkv_attention` (Pallas `_fused_qkv_kernel`, K1) reads the qkv
  projection output in its natural [B, S, 3D] timm layout (q | k | v) and
  writes [B, S, D]: no transposed copy of q, k or v is made. Under grad it
  goes through `FusedQKVAttention`, the counterpart of the JAX
  `custom_vjp`, whose backward is `fused_qkv_attention_bwd` (Pallas
  `_fused_qkv_bwd_kernel`, K4): a recompute of the probabilities from the
  saved qkv, so no [B, H, S, S] tensor is kept between the passes.
- `mha_short_seq` (Pallas `_mha_kernel`, K5) takes separate q, k, v in
  [B, S, H, hd] and reads them in place through their strides.
- `attention` is the plain masked einsum path for callers holding separate
  q/k/v; it never calls a kernel, as in the JAX package.
- `supports_fused_qkv` is the eligibility check a module asks before it
  takes K1/K4, as the JAX module asks its namesake.

On a CUDA tensor each wrapper launches its hand-written kernel under
`csrc/` or raises `ValueError`; on a CPU tensor it runs the plain version
beside it, which is also the kernel's reference on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from advancedliteratemachinery_tpu_torch.ops import _kernels

KERNEL = "fused_qkv_attention"
BWD_KERNEL = "fused_qkv_attention_bwd"
MHA_KERNEL = "mha_short_seq"
HEAD_DIM = 64        # the kernels' head dim
MAX_SEQ = 768        # K1/K4's longest sequence (a head's K/V in shared memory)
MHA_MAX_SEQ = 1024   # K5's longest sequence (the JAX kernel's VMEM bound)


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' arithmetic type: f32, or f64 for f64 inputs."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _split_heads(qkv: torch.Tensor, num_heads: int,
                 scale: Optional[float]) -> Tuple[int, int, int, int, float]:
    B, S, threeD = qkv.shape
    D = threeD // 3
    if threeD % 3 or D % num_heads:
        raise ValueError(f"qkv width {threeD} does not split into 3 x "
                         f"{num_heads} heads")
    hd = D // num_heads
    return B, S, D, hd, (hd ** -0.5 if scale is None else float(scale))


def _check_kernel_input(name: str, t: torch.Tensor, S: int, hd: int,
                        max_seq: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if t.dtype != torch.bfloat16 or hd != HEAD_DIM or not 1 <= S <= max_seq:
        raise ValueError(
            f"{name} kernel takes bf16, head dim {HEAD_DIM}, "
            f"1 <= S <= {max_seq}; got {t.dtype}, head dim {hd}, S={S}")


def _check_dense(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} inputs must be contiguous and 16-byte "
                             "aligned")


# ---------------------------------------------------------------- K1 + K4


def supports_fused_qkv(seq: int, dim: int, num_heads: int,
                       dtype: torch.dtype, device) -> bool:
    """Whether a module may send qkv [B, seq, 3·dim] to K1 (and K4 under
    grad): the JAX package's `supports_fused_qkv` (head dim a multiple of
    64, seq ≥ 8, never on the CPU) narrowed to what the port's kernels take
    (a CUDA tensor, bf16, head dim 64, seq ≤ MAX_SEQ). A head dim of 128,
    which the TPU kernel takes, goes to the plain path here. The JAX check's
    VMEM budget (`_choose_group`) has no counterpart: a block holds one
    head."""
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and dim % num_heads == 0 and dim // num_heads == HEAD_DIM
            and 8 <= seq <= MAX_SEQ)


def fused_qkv_attention_plain(qkv: torch.Tensor, num_heads: int,
                              scale: Optional[float] = None,
                              safe: bool = True) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's `_einsum_attention_from_qkv`):
    f32 scores and softmax, probabilities rounded to the input dtype before
    the product with v, as the kernel does."""
    B, S, D, hd, scale = _split_heads(qkv, num_heads, scale)
    q, k, v = _acc(qkv).reshape(B, S, 3, num_heads, hd).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if safe:
        s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s)
    o = torch.einsum("bhqk,bkhd->bqhd", _acc(e.to(qkv.dtype)), v)
    o = o / e.sum(-1).transpose(1, 2)[..., None]
    return o.reshape(B, S, D).to(qkv.dtype)


def fused_qkv_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                                  num_heads: int,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of K4 with the JAX kernel's arithmetic and
    rounding points (`_fused_qkv_bwd_kernel`): qs = round(q·scale) to the
    input dtype; s = qs·kᵀ and the safe softmax p in f32; dV = round(p)ᵀ·dO;
    dP = dO·vᵀ in f32; r = rowsum(dP ⊙ p) in f32; dS = round(p ⊙ (dP − r));
    dQ = (dS·k)·scale; dK = dSᵀ·qs. Returns dqkv [B, S, 3D] in the input
    dtype."""
    B, S, D, hd, scale = _split_heads(qkv, num_heads, scale)
    dt = qkv.dtype
    q, k, v = qkv.reshape(B, S, 3, num_heads, hd).unbind(2)
    qs = _acc((q * scale).to(dt))
    k, v = _acc(k), _acc(v)
    do = _acc(dout.reshape(B, S, num_heads, hd))
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k)
    s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", _acc(p.to(dt)), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    r = (dp * p).sum(-1, keepdim=True)
    ds = _acc((p * (dp - r)).to(dt))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return torch.stack([dq, dk, dv], 2).reshape(B, S, 3 * D).to(dt)


def _fused_qkv_forward(qkv: torch.Tensor, num_heads: int, scale: float,
                       safe: bool) -> torch.Tensor:
    B, S, D, hd, scale = _split_heads(qkv, num_heads, scale)
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, num_heads, scale, safe)
    _check_kernel_input(KERNEL, qkv, S, hd, MAX_SEQ)
    _check_dense(KERNEL, qkv)
    out = torch.empty((B, S, D), dtype=qkv.dtype, device=qkv.device)
    fn = _kernels.kernel_function(
        KERNEL, "alm_fused_qkv_attention",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = fn(qkv.data_ptr(), out.data_ptr(), B, S, num_heads, scale,
             int(safe), stream)
    _kernels.check(KERNEL, err)
    _kernels.count(KERNEL)
    return out


def fused_qkv_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                            num_heads: int, scale: Optional[float] = None
                            ) -> torch.Tensor:
    """The backward of `fused_qkv_attention` (always the safe softmax, as
    the JAX VJP): qkv [B, S, 3D] and dout [B, S, D] → dqkv [B, S, 3D].

    CUDA tensors go through K4 (bf16, head dim 64, S ≤ 768, contiguous and
    16-byte aligned) or raise; CPU tensors take the plain version."""
    B, S, D, hd, scale = _split_heads(qkv, num_heads, scale)
    if tuple(dout.shape) != (B, S, D):
        raise ValueError(f"dout {tuple(dout.shape)} does not match qkv "
                         f"{tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return fused_qkv_attention_bwd_plain(qkv, dout, num_heads, scale)
    _check_kernel_input(BWD_KERNEL, qkv, S, hd, MAX_SEQ)
    if dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise ValueError(f"dout must be {qkv.dtype} on {qkv.device}; got "
                         f"{dout.dtype} on {dout.device}")
    _check_dense(BWD_KERNEL, qkv, dout)
    dqkv = torch.empty_like(qkv)
    # per (b, h, row), rows padded to the kernel's 64-row tiles: the
    # log2-sum-exp of the scores and rowsum(dP ⊙ P), written by the row
    # pass and read by the column pass
    stats = torch.empty((B, num_heads, -(-S // 64) * 64, 2),
                        dtype=torch.float32, device=qkv.device)
    # The kernel scales its f32 products by a power-of-two scale, which is
    # bit-identical to rounding q·scale to bf16 first; for any other scale
    # it takes qs = bf16(q·scale), rounded here as the plain version rounds
    # it.
    qs = None
    if math.frexp(scale)[0] != 0.5:
        qs = (qkv[..., :D] * scale).contiguous()
    fn = _kernels.kernel_function(
        BWD_KERNEL, "alm_fused_qkv_attention_bwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = fn(qkv.data_ptr(), dout.data_ptr(),
             None if qs is None else qs.data_ptr(), dqkv.data_ptr(),
             stats.data_ptr(), B, S, num_heads, scale,
             qkv.device.index or 0, stream)
    _kernels.check(BWD_KERNEL, err)
    _kernels.count(BWD_KERNEL)
    return dqkv


class FusedQKVAttention(torch.autograd.Function):
    """K1 forward, K4 backward (their plain versions on the CPU), as the JAX
    `custom_vjp` of `fused_qkv_attention`: only qkv is saved, and the
    backward always recomputes the safe softmax."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, safe):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _fused_qkv_forward(qkv, num_heads, scale, safe)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        dqkv = fused_qkv_attention_bwd(qkv, dout.contiguous(), ctx.num_heads,
                                       ctx.scale)
        return dqkv, None, None, None


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int,
                        scale: Optional[float] = None,
                        safe: bool = True) -> torch.Tensor:
    """qkv [B, S, 3D] (timm q|k|v) → [B, S, D].

    CUDA tensors go through K1 (bf16, head dim 64, S ≤ 768) or raise; CPU
    tensors take the plain version. With grad enabled and a qkv that
    requires grad the call is differentiable, with K4 (or its plain version)
    as the backward. `safe=False` skips the row max subtraction in the
    forward (inference, `Policy.unsafe_softmax`)."""
    scale = _split_heads(qkv, num_heads, scale)[-1]
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FusedQKVAttention.apply(qkv, num_heads, scale, safe)
    return _fused_qkv_forward(qkv, num_heads, scale, safe)


# ---------------------------------------------------------------- K5


def mha_short_seq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K5 (`_mha_kernel`): q, k, v [B, S, H, hd];
    s = (q·kᵀ)·scale in f32, safe softmax, probabilities normalised and then
    rounded to the input dtype before the product with v."""
    hd = q.shape[-1]
    scale = hd ** -0.5 if scale is None else float(scale)
    s = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * scale
    p = _acc(torch.softmax(s, dim=-1).to(v.dtype))
    return torch.einsum("bhqk,bkhd->bqhd", p, _acc(v)).to(q.dtype)


def mha_short_seq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v [B, S, H, hd] → [B, S, H, hd]: per-(batch, head) attention.

    CUDA tensors go through K5 (bf16, head dim 64, S ≤ 1024; each may be a
    strided view, e.g. of a qkv projection, as long as its head dim is
    contiguous and its rows 16-byte aligned) or raise; CPU tensors take the
    plain version. Not differentiable on the card, as the JAX function."""
    B, S, H, hd = q.shape
    if tuple(k.shape) != (B, S, H, hd) or tuple(v.shape) != (B, S, H, hd):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} differ")
    scale = hd ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return mha_short_seq_plain(q, k, v, scale)
    _check_kernel_input(MHA_KERNEL, q, S, hd, MHA_MAX_SEQ)
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share dtype and device")
    for t in (q, k, v):
        if (t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError("mha_short_seq takes a contiguous head dim, "
                             "strides that are multiples of 8 elements and "
                             "16-byte aligned data")
    _kernels.refuse_grad(MHA_KERNEL, q, k, v)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    fn = _kernels.kernel_function(
        MHA_KERNEL, "alm_mha_short_seq",
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             *strides, B, S, H, scale, stream)
    _kernels.check(MHA_KERNEL, err)
    _kernels.count(MHA_KERNEL)
    return out


# ---------------------------------------------------------------- generic


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Generic masked attention for callers holding separate q/k/v
    [B, S, H, hd] (the JAX package's `attention`): einsum scores, masked
    positions set to the f32 minimum, f32 softmax rounded to the input
    dtype. Plain tensor code on every device; self-attention in the
    transformer blocks takes `fused_qkv_attention` wherever
    `supports_fused_qkv` passes, and this otherwise."""
    hd = q.shape[-1]
    scale = hd ** -0.5 if scale is None else float(scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s.float(), torch.finfo(torch.float32).min)
    a = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v)
