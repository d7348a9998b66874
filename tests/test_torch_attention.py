"""Fused qkv attention (ops/attention.py): the port's plain version against
the JAX package's einsum path and its Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu.ops.attention import (
    _einsum_attention_from_qkv, fused_qkv_attention as j_fused)
from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.attention import (
    fused_qkv_attention)

torch.set_num_threads(2)

B, S, H, HD = 2, 17, 2, 64


def _qkv(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, 3 * H * HD)) * scale).astype(
        np.float32)


@pytest.mark.parametrize("safe", [True, False])
def test_plain_matches_jax(safe):
    qkv = _qkv(0)
    before = _kernels.LAUNCHES["fused_qkv_attention"]
    got = fused_qkv_attention(torch.from_numpy(qkv), H, safe=safe).numpy()
    # the CPU path is the plain version and launches nothing
    assert _kernels.LAUNCHES["fused_qkv_attention"] == before
    assert got.shape == (B, S, H * HD)
    einsum = np.asarray(_einsum_attention_from_qkv(jnp.asarray(qkv), H,
                                                   HD ** -0.5))
    pallas = np.asarray(j_fused(jnp.asarray(qkv), H, None, safe, True))
    # f32 throughout; 1e-5 covers summation order
    np.testing.assert_allclose(got, einsum, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_unsafe_equals_safe_for_moderate_logits():
    """Skipping the max subtraction changes nothing while exp stays finite."""
    qkv = torch.from_numpy(_qkv(1, scale=3.0))
    np.testing.assert_allclose(
        fused_qkv_attention(qkv, H, safe=False).numpy(),
        fused_qkv_attention(qkv, H, safe=True).numpy(), rtol=1e-5, atol=1e-6)


def test_bf16_input_keeps_dtype_and_layout():
    qkv = torch.from_numpy(_qkv(2)).to(torch.bfloat16)
    out = fused_qkv_attention(qkv, H)
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, H * HD)
    want = np.asarray(_einsum_attention_from_qkv(
        jnp.asarray(qkv.float().numpy()), H, HD ** -0.5))
    # bf16 output rounding (and bf16 probabilities before the product)
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2)


def test_rejects_bad_width():
    with pytest.raises(ValueError):
        fused_qkv_attention(torch.zeros(1, 4, 3 * 100), 3)
