"""Fused vocab matmul + greedy decode (ops/vocab_decode.py): the port's plain
version against the JAX package's Pallas kernel (interpret mode) and XLA
path, including vocab padding and exact ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu.ops.vocab_decode import (
    matmul_greedy_decode as j_decode, matmul_greedy_decode_xla)
from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.vocab_decode import (
    matmul_greedy_decode)

torch.set_num_threads(2)

M, D, V, TRUE_V = 200, 64, 1024, 1000   # M not a multiple of the 128 tile


def _inputs(seed):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((M, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)   # flax [D, V]
    b = rng.standard_normal((V,)).astype(np.float32)
    # exact ties: column 7 copies column 3 (same tile), column 900 copies
    # column 10 (another tile), and rows 0-1 are steered onto them
    w[:, 7] = w[:, 3]
    b[7] = b[3]
    w[:, 900] = w[:, 10]
    b[900] = b[10]
    tok[0] = np.sign(w[:, 3]) * 4.0
    tok[1] = np.sign(w[:, 10]) * 4.0
    # padded columns would win if they were not masked
    w[:, TRUE_V:] = 1.0
    b[TRUE_V:] = 100.0
    return tok, w, b


def _port(tok, w, b):
    before = _kernels.LAUNCHES["vocab_greedy_decode"]
    ids, pmax = matmul_greedy_decode(torch.from_numpy(tok),
                                     torch.from_numpy(w.T.copy()),
                                     torch.from_numpy(b), TRUE_V)
    assert _kernels.LAUNCHES["vocab_greedy_decode"] == before
    assert ids.dtype == torch.int32 and pmax.dtype == torch.float32
    return ids.numpy(), pmax.numpy()


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_plain_matches_jax(reference):
    tok, w, b = _inputs(0)
    if reference == "xla":
        want_ids, want_p = matmul_greedy_decode_xla(
            jnp.asarray(tok), jnp.asarray(w), jnp.asarray(b), TRUE_V)
    else:
        want_ids, want_p = j_decode(jnp.asarray(tok), jnp.asarray(w),
                                    jnp.asarray(b), TRUE_V, tm=128, tv=256,
                                    interpret=True)
    ids, pmax = _port(tok, w, b)
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    # f32 on both sides; 1e-5 covers summation order
    np.testing.assert_allclose(pmax, np.asarray(want_p), rtol=1e-5,
                               atol=1e-7)
    assert ids[0] == 3 and ids[1] == 10     # first index wins the tie
    assert ids.max() < TRUE_V


def test_bf16_inputs_match_f32_reference():
    tok, w, b = _inputs(1)
    t16 = torch.from_numpy(tok).to(torch.bfloat16)
    w16 = torch.from_numpy(w.T.copy()).to(torch.bfloat16)
    ids, pmax = matmul_greedy_decode(t16, w16, torch.from_numpy(b), TRUE_V)
    want_ids, want_p = matmul_greedy_decode_xla(
        jnp.asarray(t16.float().numpy()), jnp.asarray(w16.float().numpy().T),
        jnp.asarray(b), TRUE_V)
    # the plain version upcasts bf16 inputs and decodes in f32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(pmax.numpy(), np.asarray(want_p), rtol=1e-5)


def test_rejects_bad_shapes():
    with pytest.raises(ValueError):
        matmul_greedy_decode(torch.zeros(4, 8), torch.zeros(16, 9), None, 16)
    with pytest.raises(ValueError):
        matmul_greedy_decode(torch.zeros(4, 8), torch.zeros(16, 8), None, 17)
