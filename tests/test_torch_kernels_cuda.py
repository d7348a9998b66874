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
    deform_conv2d, deform_conv2d_plain)
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
