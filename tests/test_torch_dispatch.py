"""Which path the port's modules take, against the JAX package's rules.

The JAX modules take a Pallas kernel only where its eligibility check
passes and their XLA path otherwise; the port's modules ask their own
checks (`supports_fused_qkv`, `supports_fused_decode`,
`supports_deform_conv`), which follow the JAX conditions narrowed to what
the port's kernels take. On the CPU every check fails, as the JAX checks
do, so the modules compare like with like against the JAX package. A
test that needs the fused path on the CPU patches a check to pretend a
card, and the wrapper then runs its kernel's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedliteratemachinery_tpu.ops.attention as JA
import advancedliteratemachinery_tpu.ops.vocab_decode as JV
from advancedliteratemachinery_tpu.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.engine.infer import (
    MGPSTRInference as JInference)
from advancedliteratemachinery_tpu.models.layers import (
    EncoderBlock as JEncoderBlock)
from advancedliteratemachinery_tpu.models.mgp_str import (
    MGPSTR as JMGPSTR, MGPSTRConfig as JConfig)
from advancedliteratemachinery_tpu.models.vit import ViTConfig as JViTConfig
from advancedliteratemachinery_tpu.ops.deform_conv import (
    DeformConv2d as JDeformConv2d)
from advancedliteratemachinery_tpu.ops.deform_conv_pallas import (
    dcn_windowed_pallas_supported)
from advancedliteratemachinery_tpu_torch.codecs.char_codec import (
    CharCodec as TCharCodec)
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine import infer
from advancedliteratemachinery_tpu_torch.engine.convert import (
    load_flax_params)
from advancedliteratemachinery_tpu_torch.models import layers
from advancedliteratemachinery_tpu_torch.models.layers import EncoderBlock
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.vit import ViTConfig
from advancedliteratemachinery_tpu_torch.ops import _kernels, deform_conv
from advancedliteratemachinery_tpu_torch.ops.attention import (
    MAX_SEQ, supports_fused_qkv)
from advancedliteratemachinery_tpu_torch.ops.deform_conv import (
    DeformConv2d, supports_deform_conv)
from advancedliteratemachinery_tpu_torch.ops.vocab_decode import (
    supports_fused_decode)
from test_torch_mgp_str import VIT, VOCABS, random_flax_tree

torch.set_num_threads(2)

CUDA = torch.device("cuda")
BF16 = torch.bfloat16


def _on_tpu(monkeypatch, module):
    """Run a JAX check as on an accelerator: its CPU clause is the only
    thing the patch removes."""
    monkeypatch.setattr(module.jax, "default_backend", lambda: "tpu")


# ------------------------------------------------------------ the checks


@pytest.mark.parametrize("dim,heads", [(768, 12), (192, 3), (768, 6),
                                       (192, 6), (200, 3)])
@pytest.mark.parametrize("seq", [1, 7, 8, 257, 768, 769])
def test_fused_qkv_check_follows_jax(monkeypatch, seq, dim, heads):
    """The JAX `supports_fused_qkv` (head dim a multiple of 64, seq ≥ 8)
    narrowed to K1/K4's head dim 64 and seq ≤ 768, on a CUDA bf16 input.
    Its VMEM budget (`_choose_group`) is patched to pass: a TPU limit with
    no counterpart on the card."""
    _on_tpu(monkeypatch, JA)
    monkeypatch.setattr(JA, "_choose_group", lambda *a, **k: 1)
    jax_says = JA.supports_fused_qkv(2, seq, dim, heads)
    want = jax_says and dim // heads == 64 and seq <= MAX_SEQ
    assert supports_fused_qkv(seq, dim, heads, BF16, CUDA) == want
    assert not supports_fused_qkv(seq, dim, heads, BF16, "cpu")
    assert not supports_fused_qkv(seq, dim, heads, torch.float32, CUDA)


@pytest.mark.parametrize("vocab", [128, 1000, 1024, 1152, 30592, 50304])
@pytest.mark.parametrize("dim", [768, 192, 96, 100])
def test_fused_decode_check_follows_jax(monkeypatch, dim, vocab):
    """The JAX `supports_fused_decode` (vocab a multiple of 128 and ≥ 1024,
    dim a multiple of 8) narrowed to K2's dim a multiple of 64, on CUDA in
    bf16."""
    _on_tpu(monkeypatch, JV)
    want = JV.supports_fused_decode(dim, vocab) and dim % 64 == 0
    assert supports_fused_decode(dim, vocab, BF16, CUDA) == want
    assert not supports_fused_decode(dim, vocab, BF16, "cpu")
    assert not supports_fused_decode(dim, vocab, torch.float32, CUDA)


@pytest.mark.parametrize("k,stride,padding,dilation", [
    (3, 1, 1, 1), (3, 2, 1, 1), (3, 1, 0, 1), (3, 1, 2, 2), (3, 1, 2, 1),
    (3, 2, 2, 2), (1, 1, 0, 1), (5, 1, 2, 1)])
def test_deform_conv_check_follows_jax(k, stride, padding, dilation):
    """The stride and padding clauses of `dcn_windowed_pallas_supported`
    (stride 1, a same-size output) on CUDA in bf16; its VMEM budget holds
    at this small shape."""
    x_shape, w_shape = (2, 24, 20, 16), (k, k, 16, 8)
    want = dcn_windowed_pallas_supported(x_shape, k, k, stride, 3, padding,
                                         dilation)
    args = (x_shape, w_shape, stride, padding, dilation)
    assert supports_deform_conv(*args, BF16, CUDA) == want
    assert not supports_deform_conv(*args, BF16, "cpu")
    assert not supports_deform_conv(*args, torch.float32, CUDA)


@pytest.mark.parametrize("x_shape,cout", [
    ((8, 768, 768, 512), 256),       # B·H·W·Cin·2 past 2^31
    ((8, 2048, 2048, 8), 300),       # B·H·W·Cout past 2^31
    ((8, 192, 192, 64), 64)])        # LORE's largest layer: within
def test_deform_conv_check_keeps_the_kernel_offsets_32_bit(x_shape, cout):
    want = x_shape == (8, 192, 192, 64)
    assert supports_deform_conv(x_shape, (3, 3, x_shape[-1], cout), 1, 1, 1,
                                BF16, CUDA) == want


# ------------------------------------------------------------ the modules


@pytest.fixture(scope="module")
def pair():
    """A depth-2, width-192 MGP-STR in f32 on both sides, the same weights;
    the head biases favour each head's EOS id."""
    jm = JMGPSTR(JConfig(vit=JViTConfig(**VIT), **VOCABS), policy=J_FP32)
    params = random_flax_tree(jm, jnp.zeros((1, 32, 128, 3)), seed=5)[
        "params"]
    for head, eos in (("char", 1), ("bpe", 2), ("wp", 102)):
        params[f"{head}_head"]["bias"][eos] += 3.0
    tm = MGPSTR(MGPSTRConfig(vit=ViTConfig(**VIT), **VOCABS),
                policy=FP32_POLICY, device="cpu")
    load_flax_params(tm, params)
    return jm, params, tm


def _engine(model, fused_decode):
    return infer.MGPSTRInference(model, TCharCodec(),
                                 input_dtype=torch.float32, device="cpu",
                                 fused_decode=fused_decode)


def test_mgp_str_attention_takes_the_plain_path_on_cpu(pair, monkeypatch):
    """On the CPU every encoder layer takes `attention` on q, k, v, as the
    JAX module takes its einsum branch there, and the logits agree in
    f32."""
    jm, params, tm = pair
    calls = []

    def spy(q, k, v, mask=None, scale=None):
        calls.append(tuple(q.shape))
        return layers_attention(q, k, v, mask, scale)

    def no_kernel(*args, **kwargs):
        raise AssertionError("fused_qkv_attention called on the CPU")

    layers_attention = layers.attention
    monkeypatch.setattr(layers, "attention", spy)
    monkeypatch.setattr(layers, "fused_qkv_attention", no_kernel)
    x = np.random.default_rng(6).uniform(-1, 1, (2, 32, 128, 3)).astype(
        np.float32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert calls == [(2, 257, 3, 64)] * 2
    for head in ("char", "bpe", "wp"):
        # f32 on both sides, the same einsum attention
        np.testing.assert_allclose(got[head].numpy(), np.asarray(want[head]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused_decode", ["never", "auto"])
def test_engine_matches_jax_without_fused_heads(pair, fused_decode):
    """`fused_decode="never"` fuses no head; neither does "auto" on the CPU
    (the check fails there): every head is decoded from its logits, as the
    JAX engine's `fused_decode="never"`."""
    jm, params, tm = pair
    images = np.random.default_rng(7).integers(0, 256, (5, 32, 128, 3),
                                               dtype=np.uint8)
    want = JInference(jm, params, CharCodec(), input_dtype=jnp.float32,
                      fused_decode="never")(images)
    before = dict(_kernels.LAUNCHES)
    engine = _engine(tm, fused_decode)
    got = engine(images)
    assert engine.fused_heads == () and dict(_kernels.LAUNCHES) == before
    for head in ("char", "bpe", "wp"):
        np.testing.assert_array_equal(got[f"{head}_ids"],
                                      np.asarray(want[f"{head}_ids"]))
        # f32 on both sides; the confidence is a product over positions
        np.testing.assert_allclose(got[f"{head}_conf"],
                                   np.asarray(want[f"{head}_conf"]),
                                   rtol=1e-4, atol=1e-6)
    assert (got["char_conf"] > 0).any()


def test_engine_fuses_the_heads_the_check_admits(pair, monkeypatch):
    """With the check made to pass as on the card, "auto" fuses the heads
    of padded width ≥ 1024 (BPE 1024, WordPiece 1152, not char's 128) and
    the model hands their tokens to `matmul_greedy_decode` (its plain
    version on the CPU); the ids agree with the unfused engine's."""
    _, _, tm = pair
    real = supports_fused_decode
    monkeypatch.setattr(
        infer, "supports_fused_decode",
        lambda dim, vocab, dtype, device: real(dim, vocab, BF16, CUDA))
    fused = _engine(tm, "auto")
    plain = _engine(tm, "never")
    assert fused.fused_heads == ("bpe", "wp") and plain.fused_heads == ()
    images = np.random.default_rng(8).integers(0, 256, (4, 32, 128, 3),
                                               dtype=np.uint8)
    got, want = fused(images), plain(images)
    for head in ("char", "bpe", "wp"):
        np.testing.assert_array_equal(got[f"{head}_ids"],
                                      want[f"{head}_ids"])
        np.testing.assert_allclose(got[f"{head}_conf"], want[f"{head}_conf"],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fused_decode", ["interpret", "always", ""])
def test_engine_rejects_other_fused_decode(pair, fused_decode):
    with pytest.raises(ValueError, match="fused_decode"):
        _engine(pair[2], fused_decode)


@pytest.mark.parametrize("seq", [1, 5, 7, 8, 17])
def test_encoder_block_path_by_sequence_length(monkeypatch, seq):
    """An encoder block with the check made to pass as on the card: below
    S = 8 the attention takes the plain path, from 8 on the fused one (its
    plain version here); both agree with the JAX block in f32."""
    dim, heads = 128, 2
    jb = JEncoderBlock(dim, heads, policy=J_FP32)
    x = np.random.default_rng(seq).standard_normal((2, seq, dim)).astype(
        np.float32)
    params = random_flax_tree(jb, jnp.asarray(x), seed=9)["params"]
    want = np.asarray(jax.jit(jb.apply)({"params": params}, jnp.asarray(x)))
    tb = load_flax_params(EncoderBlock(dim, heads, policy=FP32_POLICY),
                          params)
    real_check, real_fused = supports_fused_qkv, layers.fused_qkv_attention
    fused_calls = []

    def fused_spy(qkv, num_heads, scale=None, safe=True):
        fused_calls.append(tuple(qkv.shape))
        return real_fused(qkv, num_heads, scale, safe)

    monkeypatch.setattr(
        layers, "supports_fused_qkv",
        lambda s, d, h, dtype, device: real_check(s, d, h, BF16, CUDA))
    monkeypatch.setattr(layers, "fused_qkv_attention", fused_spy)
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    assert fused_calls == ([] if seq < 8 else [(2, seq, 3 * dim)])
    # f32 on both sides; the fused plain version and the einsum agree
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eligible", [False, True])
def test_deform_module_path(monkeypatch, eligible):
    """`DeformConv2d` calls the K3 wrapper only where its check passes (made
    to here for `eligible`), and the plain version otherwise; both agree
    with the JAX module's gather form in f32."""
    ci, co = 6, 5
    jm = JDeformConv2d(co, window_radius=None, policy=J_FP32)
    x = np.random.default_rng(10).standard_normal((1, 9, 11, ci)).astype(
        np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes)["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = load_flax_params(DeformConv2d(ci, co, policy=FP32_POLICY), params)
    calls = []
    real = deform_conv.deform_conv2d

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(deform_conv, "deform_conv2d", spy)
    monkeypatch.setattr(deform_conv, "supports_deform_conv",
                        lambda *args: eligible)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert calls == ([1] if eligible else [])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
