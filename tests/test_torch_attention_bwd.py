"""The attention backward (K4), the short-sequence MHA (K5) and the generic
masked attention of the port (ops/attention.py) against the JAX package:
the plain versions against the Pallas kernels run in interpret mode, and
the port's `FusedQKVAttention` gradients against `jax.grad` through the
JAX `custom_vjp`."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import advancedliteratemachinery_tpu.ops.attention as A
from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.attention import (
    attention, fused_qkv_attention, fused_qkv_attention_bwd,
    mha_short_seq)

torch.set_num_threads(2)

B, H, HD = 2, 2, 64


def _qkv_and_grad(S, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, S, 3 * H * HD)).astype(np.float32)
    g = rng.standard_normal((B, S, H * HD)).astype(np.float32)
    return qkv, g


def _pallas_bwd(qkv, g):
    """The JAX VJP with the Pallas K4 in interpret mode."""
    return np.asarray(A._fused_qkv_bwd(H, None, True, True, jnp.asarray(qkv),
                                       jnp.asarray(g))[0].astype(jnp.float32))


@pytest.mark.parametrize("S", [16, 17])
def test_bwd_plain_matches_pallas_f32(S):
    qkv, g = _qkv_and_grad(S, S)
    before = dict(_kernels.LAUNCHES)
    got = fused_qkv_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(g),
                                  H).numpy()
    assert dict(_kernels.LAUNCHES) == before      # CPU: the plain version
    assert got.shape == qkv.shape
    # f32 throughout; 1e-5 covers summation order
    np.testing.assert_allclose(got, _pallas_bwd(qkv, g), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S", [16, 17])
def test_bwd_plain_matches_pallas_bf16(S):
    qkv, g = _qkv_and_grad(S, 10 + S)
    qb, gb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (qkv, g))
    want = _pallas_bwd(qb, gb)
    got = fused_qkv_attention_bwd(
        torch.from_numpy(np.array(qb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.array(gb.astype(jnp.float32))).bfloat16(),
        H)
    assert got.dtype == torch.bfloat16
    # the same rounding points (qs, p, dS, the output) in bf16; f32 sums in
    # another order may flip one bf16 rounding: a few bf16 ulps
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6,
                               atol=1e-3)


def test_function_gradient_matches_jax_grad():
    """`FusedQKVAttention` (forward K1, backward K4: plain versions on the
    CPU) against jax.grad through the JAX custom_vjp with both Pallas
    kernels in interpret mode."""
    S = 17
    qkv, w = _qkv_and_grad(S, 3)
    want = np.asarray(jax.grad(
        lambda x: (A.fused_qkv_attention(x, H, None, True, True)
                   * w).sum())(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_()
    out = fused_qkv_attention(x, H)
    assert type(out.grad_fn).__name__ == "FusedQKVAttentionBackward"
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_no_function_without_grad():
    """Serving calls (no grad, or inputs that need none) take the forward
    alone, as before: no autograd node."""
    x = torch.from_numpy(_qkv_and_grad(5, 4)[0]).requires_grad_()
    with torch.no_grad():
        assert fused_qkv_attention(x, H).grad_fn is None
    with torch.inference_mode():
        assert fused_qkv_attention(x.detach(), H).grad_fn is None
    assert fused_qkv_attention(x.detach(), H).grad_fn is None


def test_gradcheck_plain_pair_f64():
    """The plain forward and backward together are a true gradient."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 5, 3 * HD))).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: fused_qkv_attention(t, 1),
                                    (x,), eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("S", [16, 17])
def test_mha_plain_matches_pallas(S):
    """As tests/test_attention_op.py runs `_mha_kernel`: interpret mode on
    BHSD blocks."""
    rng = np.random.default_rng(20 + S)
    q, k, v = (rng.standard_normal((B, S, H, HD)).astype(np.float32)
               for _ in range(3))
    qt, kt, vt = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))
    spec = pl.BlockSpec((1, 1, S, HD), lambda b, h: (b, h, 0, 0),
                        memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        partial(A._mha_kernel, scale=HD ** -0.5),
        out_shape=jax.ShapeDtypeStruct(qt.shape, qt.dtype),
        grid=(B, H), in_specs=[spec, spec, spec], out_specs=spec,
        interpret=True)(qt, kt, vt).transpose(0, 2, 1, 3)
    got = mha_short_seq(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (B, S, H, HD)
    # f32 throughout; 1e-5 covers summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_jax(masked):
    S = 9
    rng = np.random.default_rng(30)
    q, k, v = (rng.standard_normal((B, S, H, HD)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:         # key padding: the last 3 keys of sample 1 hidden
        mask = np.ones((B, 1, 1, S), bool)
        mask[1, ..., -3:] = False
    want = A.attention(*(jnp.asarray(a) for a in (q, k, v)),
                       None if mask is None else jnp.asarray(mask))
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)),
                    None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
