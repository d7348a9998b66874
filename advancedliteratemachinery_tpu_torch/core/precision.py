"""Dtype policy (mirrors `advancedliteratemachinery_tpu/core/precision.py`).

Compute in bfloat16, outputs (logits) in float32; LayerNorm and softmax
always run in float32. Parameters are always built in float32: the modules
do not take a parameter dtype, and the inference engine casts its copy to
`compute_dtype`. `unsafe_softmax` lets the inference engine skip the max
subtraction inside the fused attention kernel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Policy:
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32
    # Inference-only: skip the max-subtraction pass inside fused attention
    # softmax (exp overflows f32 only past logit ~88, which trained encoders
    # never approach). Training keeps the safe default.
    unsafe_softmax: bool = False


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Dtype-aware GELU: the exact erf form in float32 (checkpoint parity),
    the tanh approximation in bfloat16, where the two differ by less than
    bf16 rounding."""
    approx = "tanh" if x.dtype == torch.bfloat16 else "none"
    return F.gelu(x, approximate=approx)
