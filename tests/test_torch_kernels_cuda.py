"""The port's CUDA kernels against their plain versions, on a CUDA card.

These tests need a card and skip without one. On a machine with a card and
no JAX run them without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.attention import (
    fused_qkv_attention, fused_qkv_attention_plain)
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


@pytest.mark.parametrize("B,S,H,safe", [
    (3, 17, 2, True), (3, 17, 2, False), (2, 64, 1, True),
    (4, 100, 3, False), (2, 257, 12, True), (1, 700, 2, True)])
def test_attention_kernel_matches_plain(gen, B, S, H, safe):
    qkv = torch.randn(B, S, 3 * H * 64, generator=gen,
                      device="cuda").bfloat16()
    before = _kernels.LAUNCHES["fused_qkv_attention"]
    out = fused_qkv_attention(qkv, H, safe=safe)
    assert _kernels.LAUNCHES["fused_qkv_attention"] == before + 1
    want = fused_qkv_attention_plain(qkv.float(), H, safe=safe)
    # bf16 output rounding and bf16 probabilities before the product
    assert (out.float() - want).abs().max().item() <= 2e-2


@pytest.mark.parametrize("M,V,true_v", [(300, 1200, 1190), (1, 128, 100),
                                        (513, 2048, 2048)])
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


@pytest.mark.parametrize("B,H,W,Cin,Cout,offset_scale", [
    (2, 13, 29, 40, 72, 2.0),        # pixels, Cin and Cout off every tile
    (1, 24, 24, 5, 7, 1.5),          # Cin off the 8-channel vectors
    (2, 48, 48, 64, 64, 15.0)])      # ±40 px: many samples off the image
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
