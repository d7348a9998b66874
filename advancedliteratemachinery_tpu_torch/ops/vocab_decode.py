"""Vocab-head matmul fused with greedy decode.

Port of `advancedliteratemachinery_tpu/ops/vocab_decode.py`
`matmul_greedy_decode` (Pallas `_kernel`): tokens [M, D] times the head
weight, plus bias, reduced per row to the greedy id and the max softmax
probability without the [M, V] logits ever reaching memory. Columns at or
above `true_vocab` (vocab padding) are masked; ties go to the first index.

The weight is taken in the layout the port stores it, `nn.Linear.weight`
[V, D], and the kernel reads it as it is. On a CUDA tensor the wrapper
launches `csrc/vocab_greedy_decode.cu`; on a CPU tensor it runs the plain
version below, which is also the kernel's reference on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from advancedliteratemachinery_tpu_torch.ops import _kernels

KERNEL = "vocab_greedy_decode"


def matmul_greedy_decode_plain(tokens: torch.Tensor, weight: torch.Tensor,
                               bias: Optional[torch.Tensor], true_vocab: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (the JAX package's `matmul_greedy_decode_xla`),
    in f32: materialises the logits. Returns (ids [M] int32, pmax [M] f32)."""
    logits = tokens.float() @ weight.float().t()
    if bias is not None:
        logits = logits + bias.float()
    V = logits.shape[-1]
    cols = torch.arange(V, device=logits.device)
    logits = logits.masked_fill(cols >= true_vocab, float("-inf"))
    lmax = logits.amax(-1)
    # first index attaining the max, stated explicitly rather than relying
    # on argmax's tie order
    ids = torch.where(logits == lmax[:, None], cols, V).amin(-1)
    pmax = torch.exp(lmax - torch.logsumexp(logits, -1))
    return ids.to(torch.int32), pmax


def supports_fused_decode(dim: int, vocab: int, dtype: torch.dtype,
                          device) -> bool:
    """Whether an inference engine may fuse a head of padded width `vocab`
    through the kernel: the JAX package's `supports_fused_decode` (vocab a
    multiple of 128 and at least 1024, dim a multiple of 8, never on the
    CPU) narrowed to the kernel's own limits (a CUDA device, bf16 tokens
    and weight, dim a multiple of 64)."""
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and vocab % 128 == 0 and vocab >= 1024 and dim % 64 == 0)


def matmul_greedy_decode(tokens: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor], true_vocab: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [M, D] @ weight[V, D]ᵀ (+ bias [V]) → (greedy ids [M] int32,
    max softmax prob [M] f32); columns ≥ `true_vocab` never win.

    CUDA tensors go through the kernel (bf16 tokens and weight, D a multiple
    of 64) or raise; CPU tensors take the plain version."""
    M, D = tokens.shape
    V = weight.shape[0]
    if weight.shape[1] != D or not 1 <= true_vocab <= V:
        raise ValueError(f"tokens {tuple(tokens.shape)}, weight "
                         f"{tuple(weight.shape)}, true_vocab {true_vocab}")
    if tokens.device.type == "cpu":
        return matmul_greedy_decode_plain(tokens, weight, bias, true_vocab)
    if tokens.device.type != "cuda" or weight.device != tokens.device:
        raise ValueError(f"unsupported devices {tokens.device}, "
                         f"{weight.device}")
    if (tokens.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16
            or D % 64 or M < 1):
        raise ValueError(
            "matmul_greedy_decode kernel takes bf16 tokens and weight with "
            f"D a multiple of 64; got {tokens.dtype}, {weight.dtype}, D={D}")
    _kernels.refuse_grad(KERNEL, tokens, weight, bias)
    for t in (tokens, weight):       # TMA reads both tile by tile
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("tokens and weight must be contiguous and "
                             "16-byte aligned")
    if bias is None:
        bias = torch.zeros(V, dtype=torch.float32, device=tokens.device)
    bias = bias.to(torch.float32).contiguous()
    lib_args = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn = _kernels.kernel_function(KERNEL, "alm_vocab_greedy_decode", lib_args)
    n_chunks = _kernels.kernel_function(
        KERNEL, "alm_vocab_num_chunks", [ctypes.c_int])(V)
    dev = tokens.device
    part_m = torch.empty((M, n_chunks), dtype=torch.float32, device=dev)
    part_a = torch.empty((M, n_chunks), dtype=torch.int32, device=dev)
    part_s = torch.empty((M, n_chunks), dtype=torch.float32, device=dev)
    ids = torch.empty((M,), dtype=torch.int32, device=dev)
    pmax = torch.empty((M,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(tokens.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             part_m.data_ptr(), part_a.data_ptr(), part_s.data_ptr(),
             ids.data_ptr(), pmax.data_ptr(), M, D, V, true_vocab, stream)
    _kernels.check(KERNEL, err)
    _kernels.count(KERNEL)
    return ids, pmax
