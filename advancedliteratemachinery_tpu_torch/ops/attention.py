"""Fused multi-head self-attention straight off the qkv projection.

Port of `advancedliteratemachinery_tpu/ops/attention.py`
`fused_qkv_attention` (Pallas `_fused_qkv_kernel`). The input is the qkv
projection output in its natural [B, S, 3D] timm layout (q | k | v) and the
output is [B, S, D]: no transposed copy of q, k or v is made. On a CUDA
tensor the wrapper launches the hand-written kernel in
`csrc/fused_qkv_attention.cu`; on a CPU tensor it runs the plain version
below, which is also the kernel's reference on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from advancedliteratemachinery_tpu_torch.ops import _kernels

KERNEL = "fused_qkv_attention"
HEAD_DIM = 64        # the kernel's head dim
MAX_SEQ = 768        # the kernel's longest sequence (shared-memory bound)


def fused_qkv_attention_plain(qkv: torch.Tensor, num_heads: int,
                              scale: Optional[float] = None,
                              safe: bool = True) -> torch.Tensor:
    """Plain PyTorch version (the JAX package's `_einsum_attention_from_qkv`):
    f32 scores and softmax, probabilities rounded to the input dtype before
    the product with v, as the kernel does."""
    B, S, threeD = qkv.shape
    D = threeD // 3
    hd = D // num_heads
    if scale is None:
        scale = hd ** -0.5
    q, k, v = qkv.float().reshape(B, S, 3, num_heads, hd).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if safe:
        s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(qkv.dtype).float(), v)
    o = o / e.sum(-1).transpose(1, 2)[..., None]
    return o.reshape(B, S, D).to(qkv.dtype)


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int,
                        scale: Optional[float] = None,
                        safe: bool = True) -> torch.Tensor:
    """qkv [B, S, 3D] (timm q|k|v) → [B, S, D].

    CUDA tensors go through the kernel (bf16, head dim 64, S ≤ 768) or
    raise; CPU tensors take the plain version. `safe=False` skips the row
    max subtraction (inference only, `Policy.unsafe_softmax`)."""
    B, S, threeD = qkv.shape
    D = threeD // 3
    if threeD % 3 or D % num_heads:
        raise ValueError(f"qkv width {threeD} does not split into 3 x "
                         f"{num_heads} heads")
    hd = D // num_heads
    if scale is None:
        scale = hd ** -0.5
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, num_heads, scale, safe)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16 or hd != HEAD_DIM or not 1 <= S <= MAX_SEQ:
        raise ValueError(
            f"fused_qkv_attention kernel takes bf16, head dim {HEAD_DIM}, "
            f"1 <= S <= {MAX_SEQ}; got {qkv.dtype}, head dim {hd}, S={S}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    out = torch.empty((B, S, D), dtype=qkv.dtype, device=qkv.device)
    fn = _kernels.kernel_function(
        KERNEL, "alm_fused_qkv_attention",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = fn(qkv.data_ptr(), out.data_ptr(), B, S, num_heads, float(scale),
             int(safe), stream)
    _kernels.check(KERNEL, err)
    _kernels.LAUNCHES[KERNEL] += 1
    return out
