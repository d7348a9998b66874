"""The port's CUDA kernels against their plain versions, on a CUDA card,
and the modules' choice between a kernel and its plain path there.

These tests need a card and skip without one. On a machine with a card and
no JAX run them without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu_torch.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, FP32_POLICY)
from advancedliteratemachinery_tpu_torch.engine.infer import MGPSTRInference
from advancedliteratemachinery_tpu_torch.models import layers
from advancedliteratemachinery_tpu_torch.models.dla import (
    DLAConfig, DLASeg, DLASegConfig)
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.vit import ViTConfig
from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.attention import (
    fused_qkv_attention, fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_plain, fused_qkv_attention_plain, mha_short_seq,
    mha_short_seq_plain)
from advancedliteratemachinery_tpu_torch.ops.deform_conv import (
    DeformConv2d, DeformConvFunction, deform_conv2d, deform_conv2d_plain)
from advancedliteratemachinery_tpu_torch.ops.vocab_decode import (
    matmul_greedy_decode, matmul_greedy_decode_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


# K1's 64-row query tiles and 64-key chunks (a last chunk of at most 16
# keys takes the short form), on and off them; B·H = 15 heads, one block
# each
@pytest.mark.parametrize("B,S,H,safe", [
    (3, 17, 2, True), (3, 17, 2, False), (2, 64, 1, True),
    (4, 100, 3, False), (2, 257, 12, True), (1, 700, 2, True)] + [
    (3, S, 5, safe) for S in (1, 63, 64, 65, 129, 257, 320, 768)
    for safe in (True, False)])
def test_attention_kernel_matches_plain(gen, B, S, H, safe):
    qkv = torch.randn(B, S, 3 * H * 64, generator=gen,
                      device="cuda").bfloat16()
    before = _kernels.LAUNCHES["fused_qkv_attention"]
    out = fused_qkv_attention(qkv, H, safe=safe)
    assert _kernels.LAUNCHES["fused_qkv_attention"] == before + 1
    want = fused_qkv_attention_plain(qkv.float(), H, safe=safe)
    assert out.shape == (B, S, H * 64)
    # bf16 output rounding and bf16 probabilities before the product
    assert (out.float() - want).abs().max().item() <= 2e-2
    # no atomics: the same input gives the same bits
    assert torch.equal(out, fused_qkv_attention(qkv, H, safe=safe))


# the kernel's tiles: 128 token rows, 256 vocab columns, chunks of 2048
# columns merged in order; M and V on and off them, true_vocab inside the
# last tile, and BPE's and WordPiece's padded heads
@pytest.mark.parametrize("M,V,true_v", [
    (300, 1200, 1190), (1, 128, 100), (513, 2048, 2048), (127, 4100, 4097),
    (129, 2304, 2200), (1, 30592, 30522), (300, 50304, 50257)])
def test_vocab_kernel_matches_plain(gen, M, V, true_v):
    D = 768
    tok = torch.randn(M, D, generator=gen, device="cuda")
    w = torch.randn(V, D, generator=gen, device="cuda") * 0.05
    b = torch.randn(V, generator=gen, device="cuda") * 0.1
    # exact tie: column 70 copies column 5 and row 0 is steered onto them
    w[70] = w[5] = 0.1 * torch.sign(tok[0])
    b[70] = b[5]
    tok, w = tok.bfloat16(), w.bfloat16()
    ids, pmax = matmul_greedy_decode(tok, w, b, true_v)
    pids, ppmax = matmul_greedy_decode_plain(tok, w, b, true_v)
    assert int(ids[0]) == int(pids[0]) == 5
    logits = (tok.float() @ w.float().t() + b)[:, :true_v]
    top2 = logits.topk(2, dim=-1).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 1e-3
    assert not ((ids != pids) & ~near_tie).any()
    assert int(ids.max()) < true_v
    # f32 accumulation in another order; exp by the fast intrinsic
    torch.testing.assert_close(pmax, ppmax, rtol=1e-3, atol=0)


@pytest.mark.parametrize("j1,j2", [(2047, 2048), (255, 256), (2000, 4000)])
def test_vocab_kernel_tie_across_tiles_and_chunks(gen, j1, j2):
    """An exact tie between columns in two 256-column tiles or two
    2048-column chunks goes to the lower index, as in the plain version."""
    M, D, V = 130, 768, 4224
    tok = torch.randn(M, D, generator=gen, device="cuda")
    w = torch.randn(V, D, generator=gen, device="cuda") * 0.05
    b = torch.randn(V, generator=gen, device="cuda") * 0.1
    for row in (0, 129):                 # first and last token tile
        s = torch.sign(torch.randn(D, generator=gen, device="cuda")) * 0.5
        tok[row] = s
        w[j1] = w[j2] = 0.1 * s
        b[j2] = b[j1]
        ids, _ = matmul_greedy_decode(tok.bfloat16(), w.bfloat16(), b, V)
        pids, _ = matmul_greedy_decode_plain(tok.bfloat16(), w.bfloat16(),
                                             b, V)
        assert int(ids[row]) == int(pids[row]) == j1


def _dcn_inputs(gen, B, H, W, Cin, Cout, offset_scale):
    dev = "cuda"
    x = torch.randn(B, H, W, Cin, generator=gen, device=dev).bfloat16()
    off = (torch.randn(B, H, W, 9, 2, generator=gen, device=dev)
           * offset_scale).bfloat16()
    mask = torch.rand(B, H, W, 9, generator=gen, device=dev).bfloat16()
    mask[:, :2] = 0                                   # a zero mask
    w = (torch.randn(3, 3, Cin, Cout, generator=gen, device=dev)
         / (9 * Cin) ** 0.5).bfloat16()
    b = torch.randn(Cout, generator=gen, device=dev).bfloat16()
    return x, off, mask, w, b


# the kernel's tiles: 8 x 16 pixels, 64 input channels a stage, N = 64, 128
# or 256 output channels a block; pixels, Cin and Cout on and off them
@pytest.mark.parametrize("B,H,W,Cin,Cout,offset_scale", [
    (2, 13, 29, 40, 72, 2.0),        # pixels, Cin and Cout off every tile
    (1, 24, 24, 5, 7, 1.5),          # Cin off the 8-channel vectors
    (2, 48, 48, 64, 64, 15.0),       # ±40 px: many samples off the image
    (1, 9, 17, 200, 200, 2.0),       # 3 stages + 8 channels; N = 256
    (2, 24, 24, 512, 256, 2.0),      # LORE's 512 -> 256 layer, B = 2
    (1, 11, 7, 64, 300, 2.0),        # two column blocks of 256
    (3, 5, 3, 8, 128, 1.0)])         # 45 pixels: most of the tile idle
def test_deform_conv_kernel_matches_plain(gen, B, H, W, Cin, Cout,
                                          offset_scale):
    x, off, mask, w, b = _dcn_inputs(gen, B, H, W, Cin, Cout, offset_scale)
    before = _kernels.LAUNCHES["deform_conv"]
    out = deform_conv2d(x, off, mask, w, b)
    assert _kernels.LAUNCHES["deform_conv"] == before + 1
    want = deform_conv2d_plain(x.float(), off.float(), mask.float(),
                               w.float(), b.float())
    # the kernel rounds each sample to bf16 (the plain version here keeps
    # f32) and the output to bf16: relative to the output's RMS
    rms = want.pow(2).mean().sqrt()
    err = (out.float() - want).abs()
    assert out.shape == (B, H, W, Cout)
    assert (err.pow(2).mean().sqrt() / rms).item() <= 5e-3
    assert (err.max() / rms).item() <= 3e-2


@pytest.mark.parametrize("Cin,Cout", [(5, 7), (40, 72), (200, 200),
                                      (512, 256)])
def test_deform_conv_kernel_outside_gives_the_bias(gen, Cin, Cout):
    """Every sample wholly off the image: each output is exactly the
    bias (a zero sum, rounded, plus the bias in bf16)."""
    x, off, mask, w, b = _dcn_inputs(gen, 1, 10, 19, Cin, Cout, 1.0)
    out = deform_conv2d(x, torch.full_like(off, 1000.0), mask, w, b)
    assert torch.equal(out, b.expand_as(out))


def test_kernels_reject_unsupported_inputs(gen):
    with pytest.raises(ValueError):    # f32, not bf16
        fused_qkv_attention(torch.zeros(1, 4, 384, device="cuda"), 2)
    with pytest.raises(ValueError):    # head dim 32
        fused_qkv_attention(torch.zeros(1, 4, 192, device="cuda").bfloat16(),
                            2)
    with pytest.raises(ValueError):    # D not a multiple of 64
        matmul_greedy_decode(torch.zeros(4, 96, device="cuda").bfloat16(),
                             torch.zeros(128, 96, device="cuda").bfloat16(),
                             None, 128)
    x, off, mask, w, b = _dcn_inputs(gen, 1, 8, 8, 8, 8, 1.0)
    with pytest.raises(ValueError):    # stride 2
        deform_conv2d(x, off[:, :4, :4], mask[:, :4, :4], w, b, stride=2)
    with pytest.raises(ValueError):    # f32, not bf16
        deform_conv2d(x.float(), off.float(), mask.float(), w.float(), None)
    with pytest.raises(ValueError):    # not a same-size output
        deform_conv2d(x, off[:, 1:-1, 1:-1], mask[:, 1:-1, 1:-1], w, b,
                      padding=0)


def _check_bwd(gen, B, S, H, scale=None):
    D = H * 64
    qkv = torch.randn(B, S, 3 * D, generator=gen, device="cuda").bfloat16()
    dout = torch.randn(B, S, D, generator=gen, device="cuda").bfloat16()
    before = _kernels.LAUNCHES["fused_qkv_attention_bwd"]
    got = fused_qkv_attention_bwd(qkv, dout, H, scale)
    assert _kernels.LAUNCHES["fused_qkv_attention_bwd"] == before + 1
    # no atomics: the same input gives the same bits
    assert torch.equal(got, fused_qkv_attention_bwd(qkv, dout, H, scale))
    # the plain version rounds where the kernel does (qs, p, dS, output);
    # sums in another order may flip a rounding: relative to each output's
    # RMS (K4_RMS_TOL, K4_MAX_TOL); at S=1 dS is 0 and so are dq and dk
    want = fused_qkv_attention_bwd_plain(qkv, dout, H, scale).float()
    got = got.float()
    for i in range(3):
        w, g = want[..., i * D:(i + 1) * D], got[..., i * D:(i + 1) * D]
        rms = w.pow(2).mean().sqrt()
        if rms.item() == 0:
            assert not g.any()
            continue
        assert ((g - w).pow(2).mean().sqrt() / rms).item() <= 1e-2
        assert ((g - w).abs().max() / rms).item() <= 5e-2


# K4's 64-row tiles and chunks on and off them, its 16-row short last
# chunk (S = 16, 17, 272, 273), its longest sequence, and 1, 3 and 12 heads
@pytest.mark.parametrize("B,S,H", [(3, 17, 2), (2, 100, 3)] + [
    (B, S, H)
    for S in (1, 8, 16, 17, 63, 64, 65, 257, 272, 273, 320, 321, 700, 768)
    for B, H in ((3, 1), (2, 3), (1, 12))])
def test_attention_bwd_kernel_matches_plain(gen, B, S, H):
    _check_bwd(gen, B, S, H)


@pytest.mark.parametrize("B,S,H,scale", [
    (3, 17, 1, 0.2), (2, 257, 3, 0.1), (1, 768, 2, 0.3)])
def test_attention_bwd_kernel_other_scale(gen, B, S, H, scale):
    """A scale that is no power of two: q is scaled and rounded to bf16
    before the kernel reads it, as the plain version rounds it."""
    _check_bwd(gen, B, S, H, scale)


def test_attention_autograd_launches_k1_and_k4(gen):
    qkv = torch.randn(2, 33, 3 * 128, generator=gen,
                      device="cuda").bfloat16().requires_grad_()
    g = torch.randn(2, 33, 128, generator=gen, device="cuda").bfloat16()
    before = dict(_kernels.LAUNCHES)
    fused_qkv_attention(qkv, 2).backward(g)
    assert _kernels.LAUNCHES["fused_qkv_attention"] == before.get(
        "fused_qkv_attention", 0) + 1
    assert _kernels.LAUNCHES["fused_qkv_attention_bwd"] == before.get(
        "fused_qkv_attention_bwd", 0) + 1
    assert torch.equal(qkv.grad,
                       fused_qkv_attention_bwd(qkv.detach(), g, 2))


def _mha_inputs(gen, B, S, H, layout):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    if layout == "qkv":            # views of one projection
        return randn(B, S, 3, H, 64).unbind(2)
    if layout == "q+kv":           # three allocations, different strides
        return (randn(B, S, H, 64), *randn(B, S, 2, H, 64).unbind(2))
    if layout == "bhsd":           # [B, H, S, 64] through .transpose(1, 2)
        return tuple(randn(B, H, S, 64).transpose(1, 2) for _ in range(3))
    # "expand": k and v broadcast over the batch (batch stride 0)
    k, v = (randn(1, S, H, 64).expand(B, S, H, 64) for _ in range(2))
    return randn(B, S, H, 64), k, v


# K5 resident (a head's K and V in shared memory, S <= 320) and streamed
# (a 4-stage ring), each reading its operands in place
@pytest.mark.parametrize("B,S,H,layout", [
    (3, 17, 2, "qkv"), (2, 300, 3, "qkv"), (3, 257, 2, "expand"),
    (3, 640, 2, "expand")] + [
    (2, S, 3, layout) for S in (1, 64, 65, 257, 513, 640, 1024)
    for layout in ("qkv", "q+kv", "bhsd")])
def test_mha_kernel_matches_plain(gen, B, S, H, layout):
    q, k, v = _mha_inputs(gen, B, S, H, layout)
    before = _kernels.LAUNCHES["mha_short_seq"]
    out = mha_short_seq(q, k, v)
    assert _kernels.LAUNCHES["mha_short_seq"] == before + 1
    want = mha_short_seq_plain(q.float(), k.float(), v.float())
    # bf16 probabilities and output
    assert out.shape == (B, S, H, 64) and out.is_contiguous()
    assert (out.float() - want).abs().max().item() <= 2e-2
    # no atomics: the same input gives the same bits
    assert torch.equal(out, mha_short_seq(q, k, v))


def test_new_kernels_reject_unsupported_inputs(gen):
    qkv = torch.zeros(1, 4, 384, device="cuda").bfloat16()
    dout = torch.zeros(1, 4, 128, device="cuda").bfloat16()
    with pytest.raises(ValueError):    # f32, not bf16
        fused_qkv_attention_bwd(qkv.float(), dout.float(), 2)
    with pytest.raises(ValueError):    # dout of another shape
        fused_qkv_attention_bwd(qkv, dout[:, :3], 2)
    with pytest.raises(ValueError):    # S above 768
        fused_qkv_attention_bwd(torch.zeros(1, 769, 192, device="cuda")
                                .bfloat16(), torch.zeros(
                                    1, 769, 64, device="cuda").bfloat16(), 1)
    q = torch.zeros(1, 4, 2, 64, device="cuda").bfloat16()
    with pytest.raises(ValueError):    # f32, not bf16
        mha_short_seq(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):    # S above 1024
        long = torch.zeros(1, 1025, 1, 64, device="cuda").bfloat16()
        mha_short_seq(long, long, long)
    with pytest.raises(ValueError):    # head dim 32
        mha_short_seq(q[..., :32], q[..., :32], q[..., :32])
    odd = torch.zeros(1, 4, 2, 68, device="cuda").bfloat16()[..., :64]
    with pytest.raises(ValueError):    # rows not 16-byte aligned
        mha_short_seq(odd, odd, odd)
    with pytest.raises(ValueError):    # K5 has no backward
        mha_short_seq(q.requires_grad_(), q, q)


def test_kernels_without_backward_refuse_grad(gen):
    tok = torch.randn(4, 64, generator=gen, device="cuda").bfloat16()
    w = torch.randn(128, 64, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError):    # K2 would cut the graph
        matmul_greedy_decode(tok.requires_grad_(), w, None, 128)
    with torch.no_grad():
        matmul_greedy_decode(tok, w, None, 128)
    x, off, mask, wt, b = _dcn_inputs(gen, 1, 8, 8, 8, 8, 1.0)
    with pytest.raises(ValueError):    # K3 would cut the graph
        deform_conv2d(x, off, mask, wt.requires_grad_(), b)
    with torch.no_grad():
        deform_conv2d(x, off, mask, wt, b)


@pytest.mark.parametrize("B,H,W,Cin,Cout", [(2, 13, 29, 40, 72),
                                             (2, 48, 48, 64, 64)])
def test_deform_conv_function_forward_and_backward(gen, B, H, W, Cin, Cout):
    """DeformConvFunction under grad: the forward launches K3 once and
    agrees with the plain version; the backward launches nothing and is
    bit-equal to autograd of `deform_conv2d_plain` on the same bf16
    inputs for the same upstream gradient."""
    ins = _dcn_inputs(gen, B, H, W, Cin, Cout, 2.0)
    g = torch.randn(B, H, W, Cout, generator=gen, device="cuda").bfloat16()
    got = [t.clone().requires_grad_() for t in ins]
    before = _kernels.LAUNCHES["deform_conv"]
    out = DeformConvFunction.apply(*got)
    assert _kernels.LAUNCHES["deform_conv"] == before + 1
    out.backward(g)
    assert _kernels.LAUNCHES["deform_conv"] == before + 1
    want = deform_conv2d_plain(*[t.float() for t in ins])
    rms = want.pow(2).mean().sqrt()
    err = (out.float() - want).abs()
    assert (err.pow(2).mean().sqrt() / rms).item() <= 5e-3
    assert (err.max() / rms).item() <= 3e-2
    plain = [t.clone().requires_grad_() for t in ins]
    deform_conv2d_plain(*plain).backward(g)
    for a, b in zip(got, plain):
        assert a.grad.dtype == torch.bfloat16
        assert torch.equal(a.grad, b.grad)


def test_deform_conv_module_launches_or_raises_under_grad(gen):
    """DeformConv2d in bf16 on the card under grad goes through K3, and a
    bf16 CUDA input the kernel does not take raises rather than taking the
    plain version."""
    layer = DeformConv2d(8, 16, DEFAULT_POLICY).cuda()
    x = torch.randn(2, 12, 12, 8, generator=gen,
                    device="cuda").bfloat16().requires_grad_()
    before = _kernels.LAUNCHES["deform_conv"]
    layer(x).float().sum().backward()
    assert _kernels.LAUNCHES["deform_conv"] == before + 1
    assert x.grad is not None and layer.weight.grad is not None
    ins = _dcn_inputs(gen, 1, 6, 6, 8, 8, 1.0)
    with pytest.raises(ValueError):
        DeformConvFunction.apply(*ins[:3], ins[3][:, :2], ins[4])


class _PlainAttention(torch.autograd.Function):
    """K1 and K4's plain versions in f32 as one autograd Function."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale=None, safe=True):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return fused_qkv_attention_plain(qkv.float(), num_heads, scale,
                                         safe).to(qkv.dtype)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return (fused_qkv_attention_bwd_plain(
            qkv.float(), dout.float(), ctx.num_heads).to(qkv.dtype),
            None, None, None)


def test_attention_module_gradients_through_k1_and_k4(gen, monkeypatch):
    """`MultiHeadSelfAttention` in bf16 on the card takes K1 forward and K4
    backward (one launch each); its gradients agree with the same module
    with the attention swapped for the plain versions in f32, relative to
    each gradient's RMS (bf16 p and dS in the kernels)."""
    torch.manual_seed(0)
    mod = layers.MultiHeadSelfAttention(768, 12).cuda()
    x = torch.randn(4, 257, 768, generator=gen, device="cuda")
    g = torch.randn(4, 257, 768, generator=gen, device="cuda")

    def grads():
        mod.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        mod(xi).float().backward(g)
        return [xi.grad] + [p.grad for p in mod.parameters()]

    before = dict(_kernels.LAUNCHES)
    got = grads()
    for name in ("fused_qkv_attention", "fused_qkv_attention_bwd"):
        assert _kernels.LAUNCHES[name] == before.get(name, 0) + 1
    monkeypatch.setattr(
        layers, "fused_qkv_attention",
        lambda qkv, num_heads, scale=None, safe=True:
        _PlainAttention.apply(qkv, num_heads, scale, safe))
    want = grads()
    for a, b in zip(got, want):
        err = (a.float() - b.float()).pow(2).mean().sqrt()
        assert (err / b.float().pow(2).mean().sqrt()).item() <= 2e-2


def _rel(a, b):
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def test_f32_models_take_the_plain_paths(gen, monkeypatch):
    """MGP-STR and DLASeg under FP32_POLICY run on the card without a kernel
    launch and agree with the same weights on the CPU. TF32 is off for
    matmuls and for cuDNN's convs (on by default there), so both sides
    compute in f32 and differ only in summation order."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = MGPSTRConfig(vit=ViTConfig(embed_dim=192, depth=2, num_heads=3),
                       bpe_vocab_size=1000, wp_vocab_size=1100)
    gpu = MGPSTR(cfg, policy=FP32_POLICY, seed=1)
    cpu = MGPSTR(cfg, policy=FP32_POLICY, device="cpu", seed=1)
    x = torch.rand(3, 32, 128, 3, generator=torch.Generator().manual_seed(2))
    dla_cfg = DLASegConfig(dla=DLAConfig(), head_conv=32)
    dla = DLASeg(dla_cfg, policy=FP32_POLICY, seed=3)
    with torch.no_grad():        # offsets over several pixels
        for m in dla.modules():
            if hasattr(m, "conv_offset_mask"):
                m.conv_offset_mask.bias.normal_(0, 2, generator=gen)
    dla_cpu = DLASeg(dla_cfg, policy=FP32_POLICY, device="cpu")
    dla_cpu.load_state_dict(dla.state_dict())
    page = torch.randn(1, 96, 96, 3,
                       generator=torch.Generator().manual_seed(4))
    before = dict(_kernels.LAUNCHES)
    with torch.inference_mode():
        got = {k: v.cpu() for k, v in gpu(x.cuda()).items()}
        got_dla = {k: v.cpu() for k, v in dla(page.cuda()).items()}
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == before
    with torch.inference_mode():
        want, want_dla = cpu(x), dla_cpu(page)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-4, k
    for k in want_dla:
        assert _rel(got_dla[k], want_dla[k]) <= 1e-3, k


@pytest.mark.parametrize("fused_decode,k2", [("never", 0), ("auto", 2)])
def test_engine_fused_decode_on_card(gen, fused_decode, k2):
    """In bf16 on the card "auto" fuses the BPE and WordPiece heads through
    K2 (two launches a batch), "never" none; the encoder launches K1 in
    each of its layers either way, and the ids agree."""
    cfg = MGPSTRConfig(vit=ViTConfig(embed_dim=192, depth=2, num_heads=3),
                       bpe_vocab_size=1000, wp_vocab_size=1100)
    model = MGPSTR(cfg, policy=DEFAULT_POLICY, seed=5)
    images = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (4, 32, 128, 3), dtype=np.uint8)).cuda()
    engine = MGPSTRInference(model, CharCodec(), fused_decode=fused_decode)
    before = dict(_kernels.LAUNCHES)
    out = engine.run(images)
    torch.cuda.synchronize()
    after = dict(_kernels.LAUNCHES)
    launched = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert launched.get("vocab_greedy_decode", 0) == k2
    assert launched.get("fused_qkv_attention", 0) == 2
    ref = MGPSTRInference(model, CharCodec(), fused_decode="never").run(
        images)
    # near-ties may go either way between the kernel and the bf16 logits
    for head in ("char", "bpe", "wp"):
        same = (out[f"{head}_ids"] == ref[f"{head}_ids"]).float().mean()
        assert same.item() >= 0.95, head


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("family", ["mgp_str", "lore", "lister", "levocr"])
def test_golden_replays_on_card(gen, no_tf32, family):
    """tests/golden/{family}.pth through the port's loader and importer
    into the port's model in f32 on the card (TF32 off), against the
    committed outputs at the golden tolerance; chip_smoke.py holds the
    golden configurations and tolerances."""
    import os

    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch.engine import checkpoint as ck
    from advancedliteratemachinery_tpu_torch.models.lister import LISTER

    sd = ck.load_torch_state_dict(os.path.join(cs.GOLDEN_DIR,
                                               f"{family}.pth"))
    data = np.load(os.path.join(cs.GOLDEN_DIR, f"{family}.npz"))
    image = torch.from_numpy(data["in_image"]).cuda()
    with torch.inference_mode():
        if family == "mgp_str":
            model = MGPSTR(cs.GOLDEN_MGP_STR, policy=FP32_POLICY)
            ck.import_mgp_str(sd, model)
            got = model(image)
        elif family == "lore":
            model = DLASeg(cs.GOLDEN_DLASEG, policy=FP32_POLICY)
            ck.import_dla(sd, model)
            got = model(image)
        elif family == "lister":
            model = LISTER(cs.GOLDEN_LISTER, policy=FP32_POLICY)
            ck.import_lister(sd, model)
            got = model(image, torch.from_numpy(data["in_mask"]).cuda())[-1]
        else:
            model = cs.LevOCR(cs.GOLDEN_LEVOCR, policy=FP32_POLICY)
            ck.import_levocr(sd, model)
            got = model(image, torch.from_numpy(data["in_noised"]).cuda(),
                        torch.from_numpy(data["in_masked"]).cuda())
    tol = cs.GOLDEN_TOL[family]
    outs = [k[4:] for k in data.files if k.startswith("out_")]
    assert outs
    for name in outs:
        want = data[f"out_{name}"]
        np.testing.assert_allclose(
            got[name].float().cpu().numpy()[..., :want.shape[-1]], want,
            rtol=tol, atol=tol, err_msg=name)


def test_imported_engine_launches_k1_and_k2(gen):
    """A reference-layout MGP-STR checkpoint (chip_smoke's generator) at a
    kernel-eligible width through `import_mgp_str`: the bf16 engine runs
    K1 in each layer and K2 for the BPE and WordPiece heads, and never
    returns a padded id."""
    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch.engine import checkpoint as ck

    cfg = MGPSTRConfig(vit=ViTConfig(embed_dim=192, depth=2, num_heads=3),
                       bpe_vocab_size=1000, wp_vocab_size=1100)
    model = MGPSTR(cfg, policy=DEFAULT_POLICY, seed=5)
    ck.import_mgp_str(cs.reference_mgp_str_state(
        cfg, torch.Generator().manual_seed(7)), model)
    images = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (6, 32, 128, 3), dtype=np.uint8)).cuda()
    engine = MGPSTRInference(model, CharCodec())
    before = dict(_kernels.LAUNCHES)
    out = engine.run(images)
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0)
                for k, v in _kernels.LAUNCHES.items()
                if v != before.get(k, 0)}
    assert launched == {"fused_qkv_attention": 2, "vocab_greedy_decode": 2}
    for head, v in (("char", 38), ("bpe", 1000), ("wp", 1100)):
        assert int(out[f"{head}_ids"].max()) < v, head


def test_lister_engine_on_card_matches_cpu(gen):
    """LISTERInference in bf16 on the card against the same weights in f32
    on the CPU (FocalNet-tiny, iters 1): logits within chip_smoke's
    LISTER_RTOL (relative RMS), and no port kernel launched."""
    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch.engine.infer import (
        LISTERInference)
    from advancedliteratemachinery_tpu_torch.models.lister import (
        LISTER, LISTERConfig)
    from advancedliteratemachinery_tpu_torch.ops.image import normalize_crops

    cfg = LISTERConfig(variant="tiny", iters=1, max_ch=12)
    model = LISTER(cfg, seed=2)
    ref = LISTER(cfg, policy=FP32_POLICY, device="cpu")
    ref.load_state_dict(model.state_dict())
    images = np.random.default_rng(9).integers(0, 256, (4, 32, 128, 3),
                                               dtype=np.uint8)
    engine = LISTERInference(model)
    before = dict(_kernels.LAUNCHES)
    x = normalize_crops(torch.from_numpy(images), torch.float32)
    mask = torch.ones(x.shape[:3])
    with torch.inference_mode():
        got = engine.model(x.cuda().bfloat16(), mask.cuda().bfloat16())
        want = ref(x, mask)
    texts = engine.recognize(images)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == before
    for g, w in zip(got, want):
        assert _rel(g["logits"].float().cpu(), w["logits"]) <= cs.LISTER_RTOL
    assert len(texts) == 4 and all(h == "lister" for *_, h in texts)


def test_levocr_f32_on_card_matches_cpu(gen, no_tf32):
    """LevOCR under FP32_POLICY on the card (TF32 off) against the same
    weights on the CPU, at a small width (vision d 128, LevT d 128, two
    layers, two rounds), with the weights made readable by chip_smoke's
    `readable_levocr` (the CPU's rounds must delete, insert and fill): the
    vision logits within chip_smoke's LEVOCR_F32_RTOL (relative RMS), the
    final tokens equal, the scores within 1e-4, and no port kernel
    launched."""
    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch.models.abinet import (
        ABINetVisionConfig)
    from advancedliteratemachinery_tpu_torch.models.levocr import (
        LevOCR, LevOCRConfig)
    from advancedliteratemachinery_tpu_torch.ops.image import normalize_crops

    cfg = LevOCRConfig(d_model=128, heads=2, ffn=256, layers=2, max_iter=1,
                       vision=ABINetVisionConfig(d_model=128, ffn=256,
                                                 backbone_layers=1))
    model = LevOCR(cfg, policy=FP32_POLICY, seed=3)
    ref = LevOCR(cfg, policy=FP32_POLICY, device="cpu")
    ref.load_state_dict(model.state_dict())
    x = normalize_crops(torch.from_numpy(np.random.default_rng(10).integers(
        0, 256, (6, 32, 128, 3), dtype=np.uint8)), torch.float32)
    cs.readable_levocr(ref, x)
    model.load_state_dict(ref.state_dict())
    _, edits = cs.levocr_walk(ref, x)
    assert all(sum(r[k] for r in edits) > 0
               for k in ("deleted", "inserted", "filled")), edits
    before = dict(_kernels.LAUNCHES)
    with torch.inference_mode():
        got = model.refine(x.cuda())
        want = ref.refine(x)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == before
    assert _rel(got["vision_logits"].cpu(), want["vision_logits"]) <= \
        cs.LEVOCR_F32_RTOL
    assert torch.equal(got["tokens"].cpu(), want["tokens"])
    np.testing.assert_allclose(got["scores"].cpu().numpy(),
                               want["scores"].numpy(), rtol=1e-4, atol=1e-4)


def test_k4_many_pairs_repeat(gen):
    """K4 at the train shape (B=128, S=257, H=12) called 400 times on the
    same inputs, a call at another shape or K1 between each pair: every
    call gives the first call's bits (K4 adds no float atomically)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    qkv, dout = randn(128, 257, 3 * 768), randn(128, 257, 768)
    other = (randn(2, 700, 3 * 3 * 64), randn(2, 700, 3 * 64))
    ref = fused_qkv_attention_bwd(qkv, dout, 12)
    flags = []
    for i in range(200):
        if i % 2:
            fused_qkv_attention_bwd(*other, 3, 0.1)
        else:
            fused_qkv_attention(qkv, 12, safe=True)
        for _ in range(2):
            flags.append((fused_qkv_attention_bwd(qkv, dout, 12)
                          != ref).any())
    assert int(torch.stack(flags).sum()) == 0


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4", "k4_scaled",
                                    "k5"])
def test_kernels_write_every_element_of_poisoned_memory(gen, kernel):
    """Each kernel's output and scratch memory filled with 0xFF bytes (NaN
    in f32 and bf16, -1 in int32) before the call, through chip_smoke's
    `poisoned`: the output lands in the poisoned blocks and holds no
    non-finite element or out-of-range id, at shapes with partial last
    tiles (S=257 of 64-row tiles, a last vocab chunk, pixel rows off the
    tile)."""
    import chip_smoke as cs

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    if kernel == "k1":
        qkv = randn(3, 257, 3 * 128)
        fn = lambda: fused_qkv_attention(qkv, 2)
    elif kernel in ("k4", "k4_scaled"):
        qkv, dout = randn(3, 257, 3 * 192), randn(3, 257, 192)
        scale = 0.1 if kernel == "k4_scaled" else None
        fn = lambda: fused_qkv_attention_bwd(qkv, dout, 3, scale)
    elif kernel == "k5":
        q, k, v = randn(2, 257, 3, 3, 64).unbind(2)
        fn = lambda: mha_short_seq(q, k, v)
    elif kernel == "k2":
        tok, w, b = randn(129, 768), randn(2304, 768) * 0.05, randn(2304)
        fn = lambda: matmul_greedy_decode(tok, w, b, 2200)
    else:
        x, off = randn(2, 37, 40, 200), randn(2, 37, 40, 9, 2) * 2
        mask, wt = randn(2, 37, 40, 9).sigmoid(), randn(3, 3, 200, 100) * 0.05
        bias = randn(100)
        fn = lambda: deform_conv2d(x, off, mask, wt, bias)
    out, in_poison = cs.poisoned(fn)
    assert in_poison
    outs = out if isinstance(out, tuple) else (out,)
    if kernel == "k2":
        ids, pmax = outs
        assert bool(((ids >= 0) & (ids < 2200)).all())
        assert bool(((pmax > 0) & (pmax <= 1)).all())
    else:
        assert bool(torch.isfinite(outs[0]).all())
        assert torch.equal(outs[0], fn())


def omniparser_tiny():
    from advancedliteratemachinery_tpu_torch.models.omniparser import (
        OmniParserConfig)
    from advancedliteratemachinery_tpu_torch.models.swin import SwinConfig
    return OmniParserConfig(
        swin=SwinConfig(embed_dim=16, depths=(2, 2, 2, 2),
                        num_heads=(1, 2, 2, 2), window_size=7),
        d_model=64, nhead=2, dec_layers=2, dim_feedforward=128,
        max_position_embeddings=128, pt_seq_length=32, poly_length=8,
        rec_length=6, max_instances=8)


def test_omniparser_f32_on_card_matches_cpu(gen, no_tf32):
    """OmniParser under FP32_POLICY on the card (TF32 off) against the same
    weights on the CPU, at a small width (Swin embed 16, decoder d 64) on
    four 100 x 76 pages, with the weights made readable by chip_smoke's
    `readable_omniparser`: equal tokens, probabilities within chip_smoke's
    OMNI_F32_RTOL (relative RMS), and no port kernel launched."""
    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch.models.omniparser import (
        OmniParser)

    cfg = omniparser_tiny()
    ref = OmniParser(cfg, policy=FP32_POLICY, device="cpu", seed=2)
    pages = torch.randn(4, 100, 76, 3, generator=torch.Generator()
                        .manual_seed(0))
    cs.readable_omniparser(ref, pages, (0, 8))
    model = OmniParser(cfg, policy=FP32_POLICY)
    model.load_state_dict(ref.state_dict())
    before = dict(_kernels.LAUNCHES)
    for p in pages:
        with torch.inference_mode():
            got = model.infer_spotting(p[None].cuda())
            want = ref.infer_spotting(p[None])
        for k, w in want.items():
            if w.dtype == torch.float32:
                assert _rel(got[k].cpu(), w) <= cs.OMNI_F32_RTOL, k
            else:
                assert torch.equal(got[k].cpu(), w), k
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == before


def test_spotting_service_on_card(gen, no_tf32):
    """`SpottingService` on the card, 3 pages submitted at once, against
    the same model's infer_spotting on the card, page by page (f32)."""
    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch.engine.serving import (
        SpottingService)
    from advancedliteratemachinery_tpu_torch.models.omniparser import (
        OmniParser)

    cfg = omniparser_tiny()
    model = OmniParser(cfg, policy=FP32_POLICY, seed=2)
    pages = torch.randn(3, 100, 76, 3, generator=gen, device="cuda")
    cs.readable_omniparser(model, pages, (0, 8))
    with torch.inference_mode():
        want = [cs.spotting_summary(model.infer_spotting(p[None]),
                                    cfg.vocab()) for p in pages]
    svc = SpottingService(model, n_slots=2).start()
    try:
        got = svc([p.cpu().numpy() for p in pages], timeout=120)
    finally:
        svc.stop()
    for g, w in zip(got, want):
        assert g["points"].tolist() == w["points"]
        assert [list(p) for p in g["polygons"]] == w["polygons"]
        assert [list(r) for r in g["rec_tokens"]] == w["words"]


def test_image_ops_on_card_match_cpu(gen):
    """The pipelines' cv2-semantics image ops on the card against the CPU:
    the resize is integer arithmetic (equal bit for bit), the quad crops
    take float taps (within one uint8 level)."""
    from advancedliteratemachinery_tpu_torch.ops.image import (
        crop_quads_u8, resize_each_u8, resize_linear_u8)
    from advancedliteratemachinery_tpu_torch.pipelines.modules import (
        order_point)
    rng = np.random.default_rng(20)
    page = torch.from_numpy(rng.integers(0, 256, (300, 400, 3),
                                         dtype=np.uint8))
    for hw in ((32, 128), (640, 640), (512, 512), (150, 199), (301, 801)):
        assert torch.equal(resize_linear_u8(page[None].cuda(), hw).cpu(),
                           resize_linear_u8(page[None], hw)), hw
    # crops of their own sizes, resized together on the card, as the HTTP
    # server's batches are: each equal to its own resize on the CPU
    crops = [page[:h, :w].numpy() for h, w in ((24, 60), (47, 199),
                                                (32, 128), (5, 300))]
    got = resize_each_u8(crops, (32, 128), "cuda", batch=6)
    assert got.device.type == "cuda" and got.shape == (6, 32, 128, 3)
    for c, g in zip(crops, got.cpu()):
        assert torch.equal(g, resize_linear_u8(torch.from_numpy(c)[None],
                                               (32, 128))[0])
    assert not got[len(crops):].any()
    centers = rng.uniform(40, 260, (40, 1, 2))
    quads = np.stack([order_point(q) for q in (
        centers + rng.uniform(-40, 40, (40, 4, 2))).reshape(40, 8)])
    got = crop_quads_u8(page.cuda(), quads).cpu()
    want = crop_quads_u8(page, quads)
    assert got.shape == want.shape == (40, 32, 128, 3)
    assert (got.int() - want.int()).abs().max().item() <= 1


def test_mixed_size_crops_on_card_match_cpu_within_the_bound(gen):
    """64 quads on a 1240x1754 page, one 1200x40 line and one 40x600
    column among 100x30 words (some turned): the crops on the card equal
    the CPU's within one uint8 level, and the card memory they take stays
    under the host test's bound, 1024 bytes a pixel of Σ wᵢ·hᵢ (one
    canvas of the largest crop for every quad would hold 46M pixels)."""
    from advancedliteratemachinery_tpu_torch.ops.image import (
        crop_quads_u8, perspective_maps)
    rng = np.random.default_rng(0)
    page = torch.from_numpy(rng.integers(0, 256, (1754, 1240, 3),
                                         dtype=np.uint8))

    def rect(x, y, w, h, turn=0.0):
        c, s = np.cos(turn), np.sin(turn)
        pts = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
        return pts @ np.array([[c, s], [-s, c]]) + [x, y]

    quads = [rect(rng.uniform(0, 1110), rng.uniform(30, 1694), 100, 30,
                  rng.uniform(-0.2, 0.2) * (i % 4 == 0)) for i in range(62)]
    quads = np.asarray(quads + [rect(10, 20, 1200, 40),
                                rect(620, 40, 40, 600)], np.float32)
    sizes, _ = perspective_maps(quads)
    pixels = int((sizes[:, 0] * sizes[:, 1]).sum())
    gpu_page = page.cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = crop_quads_u8(gpu_page, quads)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    want = crop_quads_u8(page, quads)
    assert got.shape == want.shape == (64, 32, 128, 3)
    assert (got.cpu().int() - want.int()).abs().max().item() <= 1
    assert peak < 1024 * pixels, (peak, pixels)


def test_docxlayout_on_card(gen, no_tf32):
    """DocXLayout (DLA-v0 neck, no deformable conv) launches no port
    kernel in bf16 or f32, and in f32 on the card agrees with the CPU."""
    from advancedliteratemachinery_tpu_torch.models.docxlayout import (
        DocXLayout, DocXLayoutConfig)
    cfg = DocXLayoutConfig(dla=DLAConfig(channels=(8, 16, 32, 64, 64, 128)),
                           head_conv=32)
    page = torch.rand(1, 256, 192, 3, generator=torch.Generator()
                      .manual_seed(1))
    gpu = DocXLayout(cfg, policy=FP32_POLICY, seed=2)
    cpu = DocXLayout(cfg, policy=FP32_POLICY, device="cpu", seed=2)
    bf16 = DocXLayout(cfg, seed=2)
    before = dict(_kernels.LAUNCHES)
    with torch.inference_mode():
        got = {k: v.cpu() for k, v in gpu.infer(page.cuda()).items()}
        maps = {k: v.cpu() for k, v in gpu(page.cuda()).items()}
        bf16.infer(page.cuda())
        want, want_maps = cpu.infer(page), cpu(page)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == before
    for k in want_maps:
        assert _rel(maps[k], want_maps[k]) <= 1e-4, k
    assert torch.equal(got["detections"][..., 9], want["detections"][..., 9])
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-4, k


def test_document_pipelines_on_card_match_cpu(gen, no_tf32):
    """GeneralTextReading, TableParsing and DocumentStructurization in f32
    on the card (no launch) against the CPU on a seeded page: small
    models, the DB made readable by chip_smoke's `readable_db`."""
    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch.models.db import (
        DBConfig, DBDetector, make_db_detect_fn)
    from advancedliteratemachinery_tpu_torch.models.docxlayout import (
        DocXLayout, DocXLayoutConfig, make_layout_predict_fn)
    from advancedliteratemachinery_tpu_torch.models.lore import (
        LORE, LoreConfig, make_table_predict_fn)
    dla = DLAConfig(channels=(4, 8, 16, 16, 32, 32))
    lore_cfg = LoreConfig(
        backbone=DLASegConfig(dla=dla, head_conv=16, heads=(
            ("hm", 2), ("st", 8), ("wh", 8), ("ax", 16), ("cr", 16),
            ("reg", 2))), input_size=16, hidden_size=16, tsfm_layers=1,
        stacking_layers=1, num_heads=2)
    rec_cfg = MGPSTRConfig(vit=ViTConfig(embed_dim=64, depth=1,
                                         num_heads=1))
    page = cs.document_pages(1, (256, 192), seed=3)[0]
    results, launches = {}, {}
    for device in ("cuda", "cpu"):
        db = DBDetector(DBConfig(width=16, fpn_dim=32, head_dim=16),
                        policy=FP32_POLICY, device=device)
        cs.readable_db(db)
        lore = LORE(lore_cfg, policy=FP32_POLICY, device=device, seed=1)
        docx = DocXLayout(DocXLayoutConfig(dla=dla, head_conv=16),
                          policy=FP32_POLICY, device=device, seed=2)
        engine = MGPSTRInference(MGPSTR(rec_cfg, policy=FP32_POLICY,
                                        device=device, seed=3), CharCodec(),
                                 input_dtype=torch.float32, device=device)
        pipes = cs.doc_pipelines(engine, make_db_detect_fn(db),
                                 make_table_predict_fn(lore, input_size=128),
                                 make_layout_predict_fn(docx),
                                 device=device)
        before = dict(_kernels.LAUNCHES)
        results[device] = {n: cs.json_form(p(page)) for n, p in pipes.items()}
        launches[device] = dict(_kernels.LAUNCHES) == before
    assert launches["cuda"]
    assert len(results["cpu"]["reading"]["instances"]) > 5
    for name in results["cpu"]:
        assert cs.same_result(results["cuda"][name],
                              results["cpu"][name]) is None, name


def test_nms_on_card_matches_cpu(gen, no_tf32):
    """`ops/nms.py` on the card against the CPU: quad IoU within 1e-5 (the
    same float32 clipping), the NMS functions' keep masks equal."""
    from advancedliteratemachinery_tpu_torch.ops import nms
    rng = np.random.default_rng(21)
    centers = rng.uniform(20, 80, (40, 1, 2))
    quads = torch.from_numpy((centers + rng.uniform(-15, 15, (40, 4, 2))
                              ).astype(np.float32))
    rect = torch.sort(quads, dim=1).values        # convex: sorted corners
    rect = torch.stack([rect[:, 0], torch.stack([rect[:, 3, 0], rect[:, 0, 1]],
                                               -1), rect[:, 3],
                        torch.stack([rect[:, 0, 0], rect[:, 3, 1]], -1)], 1)
    got = nms.quad_iou(rect.cuda()[:, None], rect.cuda()[None]).cpu()
    want = nms.quad_iou(rect[:, None], rect[None])
    assert (got - want).abs().max().item() <= 1e-5 and (want > 0).sum() > 80
    boxes = rect.reshape(40, 8)
    scores = torch.linspace(1.0, 0.1, 40)
    for thr in (0.1, 0.3):
        assert torch.equal(nms.poly_nms(boxes.cuda(), scores.cuda(),
                                        thr).cpu(),
                           nms.poly_nms(boxes, scores, thr))
    assert (nms.soft_nms_scores(boxes.cuda(), scores.cuda()).cpu()
            - nms.soft_nms_scores(boxes, scores)).abs().max().item() <= 1e-5
    xyxy = torch.cat([rect.amin(1), rect.amax(1)], 1)
    s = torch.from_numpy(rng.permutation(40).astype(np.float32))
    assert torch.equal(nms.box_nms(xyxy.cuda(), s.cuda(), 0.3).cpu(),
                       nms.box_nms(xyxy, s, 0.3))


def test_align_collate_on_card_matches_cpu(gen):
    """The STR collates resize on the card bit for bit as on the CPU
    (cv2's integer arithmetic), keep-ratio and LISTER's mask too."""
    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch.data.str_dataset import (
        AlignCollate, ListerCollate)
    rng = np.random.default_rng(22)
    samples = [(cs.word_crop(rng, int(h), int(w)), "w") for h, w in zip(
        rng.integers(16, 97, 12), rng.integers(32, 385, 12))]
    for keep in (False, True):
        got, _ = AlignCollate(keep_ratio_with_pad=keep, device="cuda")(
            samples)
        want, _ = AlignCollate(keep_ratio_with_pad=keep, device="cpu")(
            samples)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    gb, gm, _ = ListerCollate(device="cuda")(samples)
    wb, wm, _ = ListerCollate(device="cpu")(samples)
    assert torch.equal(gb.cpu(), wb) and torch.equal(gm.cpu(), wm)


def test_eval_cli_on_card_matches_cpu(gen, no_tf32, tmp_path, capsys):
    """`create-lmdb` + `eval` at tiny width in f32: the card's JSON equals
    the CPU's (f32 launches no kernel), on sets labelled with the CPU
    engine's own strings, one altered."""
    import json

    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch import cli
    from advancedliteratemachinery_tpu_torch.eval.str_eval import (
        benchmark_all_eval)
    from advancedliteratemachinery_tpu_torch.models import mgp_str
    rng = np.random.default_rng(23)
    paths = []
    for i in range(10):
        h, w = int(rng.integers(16, 97)), int(rng.integers(32, 385))
        paths.append(str(tmp_path / f"c{i}.png"))
        with open(paths[-1], "wb") as f:
            f.write(cs.png_bytes(cs.word_crop(rng, h, w)))
    cfg = {"vit": {"embed_dim": 32, "depth": 2, "num_heads": 2},
           "bpe_vocab_size": 64, "wp_vocab_size": 64, "batch_max_length": 5}
    common = ["--variant", "tiny", "--batch-max-length", "6",
              "--batch-size", "4", "--config-json", json.dumps(cfg)]
    real = mgp_str.MGPSTR

    def f32(*a, **k):
        return real(*a, **{**k, "policy": FP32_POLICY})

    mgp_str.MGPSTR = f32
    try:
        gt = tmp_path / "gt.txt"
        gt.write_text("".join(f"{p}\tx\n" for p in paths))
        assert cli.main(["create-lmdb", str(gt), str(tmp_path / "a")]) == 0
        from argparse import Namespace
        engine = cli._rec_engine(Namespace(
            model="mgp_str", variant="tiny", device="cpu", torch_ckpt=None,
            batch_max_length=6, config_json=json.dumps(cfg)))
        seen = []

        def record(batch):
            out = engine.recognize(batch)
            seen.extend(t for t, _, _ in out)
            return out
        benchmark_all_eval(record, [str(tmp_path / "a")], max_length=6,
                           batch_size=4, device="cpu")
        seen[3] = "q" + seen[3][1:]
        gt.write_text("".join(f"{p}\t{s}\n" for p, s in zip(paths, seen)))
        assert cli.main(["create-lmdb", str(gt), str(tmp_path / "b")]) == 0
        capsys.readouterr()
        out = {}
        for device in ("cuda", "cpu"):
            before = dict(_kernels.LAUNCHES)
            assert cli.main(["eval", "--data", str(tmp_path / "b"),
                             "--device", device, *common]) == 0
            out[device] = json.loads(capsys.readouterr().out)
            assert dict(_kernels.LAUNCHES) == before
    finally:
        mgp_str.MGPSTR = real
    assert out["cuda"] == out["cpu"]
    assert out["cpu"]["total_samples"] == 10 and out["cpu"]["b"] < 1.0
