"""Drive the PyTorch/H100 port (`advancedliteratemachinery_tpu_torch`) on one
CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. build the CUDA kernels from `advancedliteratemachinery_tpu_torch/csrc/`;
2. fused-qkv attention kernel against its plain version, at the recognizer's
   shapes (B=256 and 512, S=257, D=768, H=12, safe and unsafe) and at odd
   small shapes (S = 17, 64, 100, 700, and 1, 63, 65, 129, 257, 320, 768
   on either side of its 64-row tiles and 16-key short last chunk, safe
   and unsafe); two calls on the same input must give the same bits; K1
   and K5 timed at S=272 and S=273, which differ only in the form of the
   last key chunk (16 keys: the short form; 17: the full one);
3. vocab matmul + greedy decode kernel against its plain version, at the
   BPE (V=50304, true 50257) and WordPiece (V=30592, true 30522) heads for
   256 and 512 crops and at shapes off its tiles (a single row, M = 127,
   129, 300, true_vocab inside the last tile), with crafted rows whose
   maximum is an exact tie, within a tile, across tiles and across a
   chunk boundary;
4. recognition only: MGP-STR-base at full width and depth (D=768, 12
   layers) with seeded random weights, B=256 crops/s and B=1 latency, an
   encoder check against a float32 run on the CPU, and `recognize()`;
5. end-to-end spotting, the first slice's main path: P=8 uint8 pages of
   640² → DB → box extraction → crop_rects → MGP-STR-base → greedy decode,
   with the page copy to the card inside the timed loop, as `bench.py`'s
   spotting stage; extraction is checked against the CPU on one page, and a
   torch.profiler trace of three more steps gives device time by kernel and
   the device's idle share;
6. modulated deformable conv kernel against its plain version, at the
   seven layer shapes of LORE's DLA neck at B=8 and 768² pages, at odd
   shapes (pixels, Cin and Cout off every tile: Cin 5, 8, 40, 200, 512,
   Cout 7, 72, 100, 128, 200, 256, 300) and with offsets of ±40 px,
   samples wholly outside the image, a zero mask and offsets beyond ±3;
7. LORE-TSR table structure, the second slice's main path: the full
   `LoreConfig()` (DLA-34 + DCN neck, six heads, Processor 4+4 layers) in
   bf16 with seeded random weights and its offset/mask convs re-seeded away
   from zero, `LORE.infer` on B=8 f32 pages of 768² as `bench.py`'s
   lore_tsr stage; head maps of one 256² page are checked against a float32
   run of the same weights on the CPU, with stage times and a profile;
   then the f32 models: MGP-STR-base, `MGPSTRInference` and LORE's
   `DLASeg` under FP32_POLICY on the card, which no kernel takes, must
   launch nothing and agree with the same weights in f32 on the CPU;
8. fused-qkv attention backward kernel (K4) against its plain version at
   S = 1, 8, 16, 17, 63, 64, 65, 257, 272, 273, 320, 321, 700, 768 (both
   sides of its 64-row tiles and of its 16-row short last chunk) with
   H = 1, 3, 12, and at a scale that is no power of two; two calls on the
   same input must give the same bits; timed at the train step's shape
   (B=128, S=257, H=12) and at B=16, S=768, beside the backward of
   `scaled_dot_product_attention`;
9. short-sequence MHA kernel (K5) on strided q/k/v views against its plain
   version at S = 17, 300, 1000, 257 (B=128) and 1024, and at S = 1, 64,
   65, 257, 513, 640, 1024 (both sides of its resident/streamed threshold)
   with q, k, v as views of one projection, as q plus views of a kv
   projection, and as [B, H, S, 64] tensors through `.transpose(1, 2)`;
   two calls on the same input must give the same bits;
10. MGP-STR-base training, the third slice's main path (`bench.py`'s
    train_bench setting: B=128, seeded uint8 crops and char/BPE/WordPiece
    ids, Adam at lr 1e-4 on a 1000-step cosine, clip 5.0, bf16 compute,
    f32 parameters): one step's gradients through K1/K4 against the same
    step with the attention swapped for the plain versions in f32, per
    parameter group; best of 3 repetitions of 10 steps of
    `make_mgp_str_train_step` (samples/s, the forward/backward/optimiser
    split, peak memory, model-FLOP utilisation, a profile); the loss must
    fall and stay finite;
11. `fit()` with `mgp_str_recipe_u8` on MGP-STR-base in a temporary
    directory: 4 steps saving every 2 and keeping 1; a restore of the last
    checkpoint equals the live state; a resume to step 6 against an
    uninterrupted 6-step run.

Launch counts are zeroed just before each main path and read just after:
every recognizer forward must launch the attention kernel 12 times and the
vocab kernel twice, every LORE forward the deformable conv kernel 16
times and nothing else, every train step the attention kernel and its
backward kernel 12 times each and nothing else, and the f32 models
nothing at all. Every time printed is this card's own, taken
with CUDA events or, end to end, with the host clock after a synchronize.
The second-to-last line is one JSON object `{"kernels": [...]}`; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.batches import (
    mgp_str_recipe_u8)
from advancedliteratemachinery_tpu_torch.engine.fit import (
    FitConfig, fit, restore_train_state)
from advancedliteratemachinery_tpu_torch.engine.infer import MGPSTRInference
from advancedliteratemachinery_tpu_torch.engine.train import (
    TrainState, make_mgp_str_train_step, make_optimizer, mgp_str_loss)
from advancedliteratemachinery_tpu_torch.models import layers
from advancedliteratemachinery_tpu_torch.models.db import DBConfig, DBDetector
from advancedliteratemachinery_tpu_torch.models.dla import DLASeg
from advancedliteratemachinery_tpu_torch.models.lore import LORE, LoreConfig
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.attention import (
    fused_qkv_attention, fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_plain, fused_qkv_attention_plain, mha_short_seq,
    mha_short_seq_plain)
from advancedliteratemachinery_tpu_torch.ops.cc_extract import (
    extract_boxes_device)
from advancedliteratemachinery_tpu_torch.ops.deform_conv import (
    DeformConv2d, deform_conv2d, deform_conv2d_plain)
from advancedliteratemachinery_tpu_torch.ops.image import (
    crop_rects, normalize_crops)
from advancedliteratemachinery_tpu_torch.ops.vocab_decode import (
    matmul_greedy_decode, matmul_greedy_decode_plain)

# published H100 SXM peaks (NVIDIA data sheet) for the roofline bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

K1_TOL = 2e-2          # bf16 output rounding and bf16 probabilities
K2_TIE_GAP = 1e-3      # rows whose plain top-2 logits are closer may differ
K2_PMAX_RTOL = 1e-3    # losing BPE's ragged last chunk moves pmax ~1.6e-3
ENCODER_RTOL = 5e-2    # bf16 through 12 layers vs float32, relative RMS
# K3 against its f32 plain version on the same bf16 inputs, relative to the
# output's RMS. The kernel rounds each sample to bf16 before the contraction
# and the output once more, each at most 2^-9 of the value: together ~2e-3
# of the RMS, and at the largest outputs (~5x the RMS) up to ~2e-2
K3_RMS_TOL = 5e-3
K3_MAX_TOL = 4e-2
LORE_RTOL = 5e-2       # bf16 DLA-34 + DCN neck vs float32, relative RMS
# the f32 models on the card (TF32 off for matmuls and cuDNN convs) against
# f32 on the CPU, relative RMS: the same arithmetic summed in other
# orders, through 12 layers (MGP-STR) or 34 layers and a neck (DLA); cuDNN
# may pick Winograd or FFT convs, whose f32 error is larger than a direct
# sum's
F32_RTOL = 1e-3
# K4 against its plain version on the same bf16 inputs, per output (dq, dk,
# dv), relative to the output's RMS. The plain version rounds where the
# kernel does (qs, p, dS, the output: bf16), in f32 summed in another order,
# so a rounding may flip by one bf16 ulp (2^-8 of an element). Against the
# plain version in f32 throughout (no bf16 rounding of p and dS) the RMS
# error is also held to K4_RMS_TOL; its largest error is only reported:
# dS sums to zero along a row, and where dq = dS k cancels, the bf16
# rounding of dS stands out against a small result.
K4_RMS_TOL = 1e-2
K4_MAX_TOL = 5e-2
# K4's sequence lengths: on both sides of its 64-row tiles and of a last
# chunk of at most 16 rows, up to its longest
K4_SEQS = (1, 8, 16, 17, 63, 64, 65, 257, 272, 273, 320, 321, 700, 768)
# one train step's gradients through K1/K4 against the same step with the
# attention swapped for the plain versions in f32, per parameter group,
# relative RMS: K1/K4 round p and dS to bf16 where the f32 plain versions
# do not (~2.4e-3 relative RMS at the attention), and the difference
# travels back through 12 bf16 layers
TRAIN_GRAD_RTOL = 2e-2

ATTN_SRC = "advancedliteratemachinery_tpu_torch/csrc/fused_qkv_attention.cu"
DECODE_SRC = "advancedliteratemachinery_tpu_torch/csrc/vocab_greedy_decode.cu"
DCN_SRC = "advancedliteratemachinery_tpu_torch/csrc/deform_conv.cu"
BWD_SRC = ("advancedliteratemachinery_tpu_torch/csrc/"
           "fused_qkv_attention_bwd.cu")
MHA_SRC = "advancedliteratemachinery_tpu_torch/csrc/mha_short_seq.cu"
# (B, H=W, Cin, Cout, layers per forward) of LORE's 16 DCN layers at 768²
DCN_PATH_SHAPES = ((8, 24, 512, 256, 1), (8, 48, 256, 256, 1),
                   (8, 48, 256, 128, 2), (8, 48, 256, 64, 1),
                   (8, 96, 128, 128, 2), (8, 96, 128, 64, 4),
                   (8, 192, 64, 64, 5))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_attention(B, S, H, safe, gen, time_it=True):
    D = H * 64
    qkv = torch.randn(B, S, 3 * D, generator=gen, device="cuda").bfloat16()
    out = fused_qkv_attention(qkv, H, safe=safe)
    again = fused_qkv_attention(qkv, H, safe=safe)
    qkv32 = qkv.float()
    want = fused_qkv_attention_plain(qkv32, H, safe=safe)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    rec = {"phase": "attention", "B": B, "S": S, "H": H, "safe": safe,
           "max_abs_err": err, "tol": K1_TOL,
           "repeat_equal": torch.equal(out, again)}
    require(out.shape == (B, S, D) and err <= K1_TOL and rec["repeat_equal"],
            f"fused_qkv_attention disagrees with its plain version: {rec}")
    if time_it:
        views = qkv.view(B, S, 3, H, 64).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in views)
        rec["ms"] = cuda_ms(lambda: fused_qkv_attention(qkv, H, safe=safe))
        rec["plain_ms"] = cuda_ms(
            lambda: fused_qkv_attention_plain(qkv32, H, safe=safe), iters=3)
        # yardsticks: SDPA on contiguous BHSD copies made outside the timed
        # window, and SDPA on strided views of qkv, the bytes K1 reads
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        rec["library_strided_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(*views))
        rec["bound_ms"], rec["bound_by"] = bound(
            B * S * 4 * D * 2, 4 * B * H * S * S * 64)
    emit(rec)
    return rec


def short_tail_probe(gen):
    """Whether the short form of the last key chunk pays: S=272 ends on a
    16-key chunk (Q K^T by m64n16k16, one P V step), S=273 on a 17-key one
    (the full m64n64k16 form); both have 5 query tiles and 5 chunks and
    differ by one key in bytes. K1 unsafe at B=256, K5 at B=128, H=12."""
    rec = {"phase": "attention_short_tail"}
    for S in (272, 273):
        qkv = torch.randn(256, S, 3 * 768, generator=gen,
                          device="cuda").bfloat16()
        rec[f"k1_ms_s{S}"] = cuda_ms(
            lambda: fused_qkv_attention(qkv, 12, safe=False), iters=20)
        q, k, v = qkv[:128].view(128, S, 3, 12, 64).unbind(2)
        rec[f"k5_ms_s{S}"] = cuda_ms(lambda: mha_short_seq(q, k, v),
                                     iters=20)
    emit(rec)


def rel_errors(got, want):
    """(RMS error, largest error), each over the RMS of `want`; both 0 when
    `got` equals an all-zero `want` (dq and dk at S=1, where dS is 0)."""
    err = (got.float() - want).abs()
    rms = want.pow(2).mean().sqrt().item()
    if rms == 0.0:
        return (0.0, 0.0) if err.max().item() == 0.0 else (np.inf, np.inf)
    return err.pow(2).mean().sqrt().item() / rms, err.max().item() / rms


def check_attention_bwd(B, S, H, gen, time_it=False, scale=None):
    """K4 against its plain version in f32 on the same bf16 inputs; two
    calls on the same input must give the same bits."""
    D = H * 64
    qkv = torch.randn(B, S, 3 * D, generator=gen, device="cuda").bfloat16()
    dout = torch.randn(B, S, D, generator=gen, device="cuda").bfloat16()
    got = fused_qkv_attention_bwd(qkv, dout, H, scale)
    again = fused_qkv_attention_bwd(qkv, dout, H, scale)
    want = fused_qkv_attention_bwd_plain(qkv, dout, H, scale).float()
    want32 = fused_qkv_attention_bwd_plain(qkv.float(), dout.float(), H,
                                           scale)
    torch.cuda.synchronize()
    rec = {"phase": "attention_bwd", "B": B, "S": S, "H": H, "scale": scale,
           "max_abs_err": (got.float() - want).abs().max().item(),
           "tol": [K4_RMS_TOL, K4_MAX_TOL],
           "repeat_equal": torch.equal(got, again)}
    for i, name in enumerate(("dq", "dk", "dv")):
        sl = slice(i * D, (i + 1) * D)
        rec[f"{name}_rel_rms_err"], rec[f"{name}_max_err_over_rms"] = (
            rel_errors(got[..., sl], want[..., sl]))
        rec[f"{name}_vs_f32"] = rel_errors(got[..., sl], want32[..., sl])
    require(got.shape == qkv.shape and rec["repeat_equal"] and all(
        rec[f"{n}_rel_rms_err"] <= K4_RMS_TOL
        and rec[f"{n}_max_err_over_rms"] <= K4_MAX_TOL
        and rec[f"{n}_vs_f32"][0] <= K4_RMS_TOL
        for n in ("dq", "dk", "dv")),
        f"fused_qkv_attention_bwd disagrees with its plain version: {rec}")
    if time_it:
        rec["ms"] = cuda_ms(lambda: fused_qkv_attention_bwd(qkv, dout, H),
                            iters=20)
        rec["plain_ms"] = cuda_ms(
            lambda: fused_qkv_attention_bwd_plain(qkv, dout, H), iters=3)
        # yardstick: SDPA's backward on strided views of the same q/k/v
        leaf = qkv.detach().requires_grad_()
        q, k, v = leaf.view(B, S, 3, H, 64).permute(2, 0, 3, 1, 4)
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        do = dout.view(B, S, H, 64).transpose(1, 2)
        rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o, leaf, do, retain_graph=True))
        rec["bound_ms"], rec["bound_by"] = bound(
            7 * B * S * D * 2, 10 * B * H * S * S * 64)
    emit(rec)
    return rec


def mha_inputs(B, S, H, gen, layout):
    """q, k, v [B, S, H, 64] bf16 read in place by K5: views of one
    [B, S, 3, H, 64] projection ("qkv"), a contiguous q beside views of a
    [B, S, 2, H, 64] kv projection ("q+kv"), or [B, H, S, 64] tensors
    through `.transpose(1, 2)` ("bhsd")."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    if layout == "qkv":
        return randn(B, S, 3, H, 64).unbind(2)
    if layout == "q+kv":
        return (randn(B, S, H, 64), *randn(B, S, 2, H, 64).unbind(2))
    return tuple(randn(B, H, S, 64).transpose(1, 2) for _ in range(3))


def check_mha(B, S, H, gen, time_it=False, layout="qkv"):
    """K5 against its plain version in f32 on the same bf16 inputs, read
    in place through their strides (`mha_inputs`)."""
    q, k, v = mha_inputs(B, S, H, gen, layout)
    out = mha_short_seq(q, k, v)
    again = mha_short_seq(q, k, v)
    f32 = [t.float() for t in (q, k, v)]
    want = mha_short_seq_plain(*f32)
    torch.cuda.synchronize()
    rec = {"phase": "mha_short_seq", "B": B, "S": S, "H": H,
           "layout": layout,
           "max_abs_err": (out.float() - want).abs().max().item(),
           "tol": K1_TOL, "repeat_equal": torch.equal(out, again)}
    rec["rel_rms_err"] = rel_errors(out, want)[0]
    require(out.shape == (B, S, H, 64) and rec["max_abs_err"] <= K1_TOL
            and rec["repeat_equal"],
            f"mha_short_seq disagrees with its plain version: {rec}")
    if time_it:
        rec["ms"] = cuda_ms(lambda: mha_short_seq(q, k, v))
        rec["plain_ms"] = cuda_ms(lambda: mha_short_seq_plain(*f32), iters=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt))
        rec["bound_ms"], rec["bound_by"] = bound(
            4 * B * S * H * 64 * 2, 4 * B * H * S * S * 64)
    emit(rec)
    return rec


def check_decode(M, V, true_v, gen, time_it=True, extra_pairs=()):
    D = 768
    tok = torch.randn(M, D, generator=gen, device="cuda")
    w = torch.randn(V, D, generator=gen, device="cuda") * 0.05
    b = torch.randn(V, generator=gen, device="cuda") * 0.1
    # crafted exact ties: columns j2 copy j1 (same tile, same chunk, other
    # chunk; `extra_pairs` more), and row i is steered onto its pair; the
    # lower index must win. As many pairs as there are rows and columns.
    pairs = [(j1, j2) for j1, j2 in ((3, 77), (200, 900),
                                     (1000, true_v - 60), *extra_pairs)
             if j1 < j2 < true_v][:M]
    for i, (j1, j2) in enumerate(pairs):
        s = torch.sign(torch.randn(D, generator=gen, device="cuda")) * 0.5
        tok[i] = s
        w[j1] = w[j2] = 0.1 * s
        b[j2] = b[j1]
    tok, w, b = tok.bfloat16(), w.bfloat16(), b.bfloat16()
    ids, pmax = matmul_greedy_decode(tok, w, b, true_v)
    pids, ppmax = matmul_greedy_decode_plain(tok, w, b, true_v)
    logits = (tok.float() @ w.float().t() + b.float())[:, :true_v]
    top2 = logits.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < K2_TIE_GAP
    del logits
    differ = ids != pids
    n_bad = int((differ & ~near).sum())
    pmax_err = (pmax - ppmax).abs()
    rec = {"phase": "vocab_decode", "M": M, "D": D, "V": V,
           "true_vocab": true_v, "near_tie_rows": int(near.sum()),
           "id_mismatches": int(differ.sum()), "id_mismatches_off_ties": n_bad,
           "tie_rows": [int(ids[i]) for i in range(len(pairs))],
           "max_abs_err": pmax_err.max().item(),
           "max_rel_err": (pmax_err / ppmax).max().item()}
    require(n_bad == 0, f"ids differ off near-ties: {rec}")
    require([j1 for j1, _ in pairs] == rec["tie_rows"]
            == [int(pids[i]) for i in range(len(pairs))],
            f"exact ties must go to the lower index: {rec}")
    require(rec["max_rel_err"] <= K2_PMAX_RTOL, f"pmax off: {rec}")
    if time_it:
        wt = w.t()
        rec["ms"] = cuda_ms(lambda: matmul_greedy_decode(tok, w, b, true_v))
        rec["plain_ms"] = cuda_ms(
            lambda: matmul_greedy_decode_plain(tok, w, b, true_v), iters=3)
        rec["library_ms"] = cuda_ms(lambda: torch.matmul(tok, wt))
        rec["bound_ms"], rec["bound_by"] = bound(
            M * D * 2 + V * D * 2 + V * 2 + M * 8, 2 * M * D * true_v)
    emit(rec)
    return rec


def check_deform_conv(B, H, W, Cin, Cout, gen, case="normal",
                      time_it=False, time_plain=False):
    """K3 against its plain version in f32 on the same bf16 inputs.
    `case`: normal (offsets N(0, 2²) px), far (uniform ±40 px), beyond3
    (every offset 3-6 px), outside (every sample wholly off the image) or
    zero_mask; the last two must give exactly the bias."""
    dev = "cuda"
    x = torch.randn(B, H, W, Cin, generator=gen, device=dev).bfloat16()
    shape = (B, H, W, 9, 2)
    if case == "far":
        off = torch.rand(shape, generator=gen, device=dev) * 80 - 40
    elif case == "beyond3":
        off = (torch.sign(torch.randn(shape, generator=gen, device=dev))
               * (3 + 3 * torch.rand(shape, generator=gen, device=dev)))
    elif case == "outside":
        off = torch.full(shape, 1000.0, device=dev)
    else:
        off = torch.randn(shape, generator=gen, device=dev) * 2
    off = off.bfloat16()
    mask = torch.rand(B, H, W, 9, generator=gen, device=dev).bfloat16()
    if case == "zero_mask":
        mask.zero_()
    w = (torch.randn(3, 3, Cin, Cout, generator=gen, device=dev)
         / (9 * Cin) ** 0.5).bfloat16()
    b = torch.randn(Cout, generator=gen, device=dev).bfloat16()
    out = deform_conv2d(x, off, mask, w, b)
    f32 = [t.float() for t in (x, off, mask, w, b)]
    want = deform_conv2d_plain(*f32)
    torch.cuda.synchronize()
    err = (out.float() - want).abs()
    rms = want.pow(2).mean().sqrt().item()
    rec = {"phase": "deform_conv", "B": B, "H": H, "W": W, "Cin": Cin,
           "Cout": Cout, "case": case, "max_abs_err": err.max().item(),
           "rel_rms_err": err.pow(2).mean().sqrt().item() / rms,
           "max_err_over_rms": err.max().item() / rms,
           "tol": [K3_RMS_TOL, K3_MAX_TOL]}
    require(out.shape == (B, H, W, Cout)
            and rec["rel_rms_err"] <= K3_RMS_TOL
            and rec["max_err_over_rms"] <= K3_MAX_TOL,
            f"deform_conv disagrees with its plain version: {rec}")
    if case in ("outside", "zero_mask"):
        require(torch.equal(out, b.expand_as(out)),
                f"deform_conv must give exactly the bias: {rec}")
    if time_it:
        rec["ms"] = cuda_ms(lambda: deform_conv2d(x, off, mask, w, b))
        xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        # the yardstick: DCN at zero offsets and a unit mask is this conv
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv2d(xc, wc, b, padding=1))
        rec["bound_ms"], rec["bound_by"] = bound(
            2 * (x.numel() + off.numel() + mask.numel() + w.numel()
                 + b.numel() + B * H * W * Cout),
            2 * B * H * W * 9 * Cin * Cout)
    if time_plain:
        rec["plain_ms"] = cuda_ms(lambda: deform_conv2d_plain(*f32), iters=3)
    emit(rec)
    return rec


def counted(fn):
    """Run `fn` with every launch count zeroed just before; return its
    result and the counts read just after."""
    torch.cuda.synchronize()
    _kernels.LAUNCHES.clear()
    result = fn()
    torch.cuda.synchronize()
    return result, dict(_kernels.LAUNCHES)


def require_counts(counts, forwards, path):
    want = {"fused_qkv_attention": 12 * forwards,
            "vocab_greedy_decode": 2 * forwards}
    require(counts == want, f"{path}: launches {counts}, expected {want}")


def rec_only(engine, images):
    """bench.py rec_only_bench + latency_bench on the port."""
    dev_images = torch.from_numpy(images).cuda()
    engine.run(dev_images)["char_ids"].cpu()            # warm up
    iters = 20

    def loop():
        t0 = time.perf_counter()
        for _ in range(iters):
            out = engine.run(dev_images)
        out["char_ids"].cpu()
        return len(images) * iters / (time.perf_counter() - t0)

    crops_s, counts = counted(loop)
    require_counts(counts, iters, "rec-only")
    one = dev_images[:1]
    engine.run(one)["char_ids"].cpu()
    lats = []
    for _ in range(60):
        t0 = time.perf_counter()
        engine.run(one)["char_ids"].cpu()
        lats.append((time.perf_counter() - t0) * 1e3)
    rec = {"phase": "rec_only", "batch": len(images), "crops_per_s": crops_s,
           "p50_ms_b1": float(np.percentile(lats, 50)),
           "p99_ms_b1": float(np.percentile(lats, 99)), "launches": counts}
    emit(rec)
    return rec


def check_encoder(engine, cfg, images):
    """The card's bf16 encoder (through the attention kernel) against a
    float32 run of the same seeded weights on the CPU, on two crops."""
    ref = MGPSTR(cfg, policy=FP32_POLICY, device="cpu", seed=0)
    x = normalize_crops(torch.from_numpy(images[:2]), torch.float32)
    with torch.inference_mode():
        want = ref.encoder(x)
        got = engine.model.encoder(x.cuda().bfloat16()).float().cpu()
    err = ((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    rec = {"phase": "encoder_vs_cpu_f32", "rel_rms_err": err.item(),
           "tol": ENCODER_RTOL}
    emit(rec)
    require(bool(torch.isfinite(got).all()) and err.item() <= ENCODER_RTOL,
            f"encoder disagrees with the CPU reference: {rec}")


def e2e_spotting(engine):
    """bench.py e2e_spotting_bench on the port; the main path."""
    P, PH, PW, K, iters = 8, 640, 640, 64, 10
    det = DBDetector(DBConfig(), seed=1)
    with torch.no_grad():   # background ≈ sigmoid(-8), still data-dependent
        det.prob_up2.weight.fill_(1e-4)
        det.prob_up2.bias.fill_(-8.0)
    template = torch.zeros(PH, PW, device="cuda")
    for r in range(8):
        for c in range(8):
            x0, y0 = 16 + c * 76, 24 + r * 74
            template[y0:y0 + 20, x0:x0 + 64] = 1.0
    rng = np.random.default_rng(0)
    pages_np = [rng.integers(0, 256, (P, PH, PW, 3), dtype=np.uint8)
                for _ in range(iters)]

    @torch.inference_mode()
    def spot_step(pages_u8, stages=None):
        mark = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        mark[0].record()
        prob = torch.maximum(det(pages_u8)["prob"][..., 0], template)
        mark[1].record()
        quads, _, valid = extract_boxes_device(prob, max_boxes=K)
        mark[2].record()
        crops = crop_rects(pages_u8, quads, out_hw=(32, 128))
        mark[3].record()
        out = dict(engine._decode_all(crops.reshape(P * K, 32, 128, 3)))
        mark[4].record()
        out["n_valid"] = valid.sum()
        if stages is not None:
            stages.append(mark)
        return out

    pages0 = torch.from_numpy(pages_np[0]).cuda()
    out0 = spot_step(pages0)
    n0 = int(out0["n_valid"])
    require(n0 >= P * K // 2, f"extraction found only {n0} boxes")
    require(out0["char_ids"].shape == (P * K, 26)
            and bool(torch.isfinite(out0["char_conf"]).all()),
            "recognizer output malformed")

    # extraction on the card against the same function on the CPU
    with torch.inference_mode():
        prob = torch.maximum(det(pages0[:1])["prob"][..., 0], template)
        gq, gs, gv = extract_boxes_device(prob, max_boxes=K)
        cq, cs, cv = extract_boxes_device(prob.cpu(), max_boxes=K)
    q_err = (gq.cpu() - cq).abs().max().item()
    emit({"phase": "extract_vs_cpu", "valid": int(gv.sum()),
          "max_abs_quad_err": q_err})
    require(torch.equal(gv.cpu(), cv) and q_err <= 1e-2,
            "extraction on the card disagrees with the CPU")

    def timed_loop():
        t0 = time.perf_counter()
        outs = [spot_step(torch.from_numpy(p).cuda()) for p in pages_np]
        total = 0
        for o in outs:                        # drain: ids + box counts
            o["char_ids"].cpu()
            total += int(o["n_valid"])
        return total / (time.perf_counter() - t0)

    reps, counts = counted(lambda: [timed_loop() for _ in range(3)])
    require_counts(counts, 3 * iters, "e2e spotting")
    stages = []
    for p in pages_np[:3]:
        spot_step(torch.from_numpy(p).cuda(), stages)
    torch.cuda.synchronize()
    names = ("det", "extract", "crop", "recognize")
    stage_ms = {n: float(np.mean([m[i].elapsed_time(m[i + 1])
                                  for m in stages]))
                for i, n in enumerate(names)}
    rec = {"phase": "e2e_spotting", "pages": P, "page_hw": [PH, PW],
           "max_boxes": K, "valid_boxes_first_step": n0,
           "crops_per_s_reps": reps, "crops_per_s_best": max(reps),
           "stage_ms": stage_ms, "launches": counts,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    profile_steps("e2e_profile", [
        lambda p=p: spot_step(torch.from_numpy(p).cuda())["char_ids"].cpu()
        for p in pages_np[:3]])
    return rec, counts


def profile_steps(phase, steps, step_ms=None):
    """Device time by kernel name over a few steps (torch.profiler; each
    step ends in a copy to the host), and the share of their wall time in
    which no kernel or copy ran (the profiler's own overhead counts into
    the wall time). Given the unprofiled time of a step, also the share of
    that time the device was not busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in steps:
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()        # kernels and copies,
              if e.device_type == torch.autograd.DeviceType.CUDA  # not the
              and not e.is_user_annotation]    # ranges user code annotates
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]
    rec = {"phase": phase, "steps": len(steps),
           "wall_ms_per_step": wall_ms / len(steps),
           "device_busy_ms_per_step": busy_ms / len(steps),
           "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
           "top_device_ms_per_step": [
               [e.key[:90], e.self_device_time_total / 1e3 / len(steps)]
               for e in top],
           # the port's own kernels (declared in anonymous namespaces)
           "port_kernels_ms_per_step": [
               [e.key[:90], e.self_device_time_total / 1e3 / len(steps)]
               for e in device
               if e.key.removeprefix("void ").startswith("(anonymous namespace)")]}
    if step_ms is not None:
        rec["unprofiled_step_ms"] = step_ms
        rec["device_idle_share_unprofiled"] = (
            1.0 - busy_ms / len(steps) / step_ms)
    emit(rec)


def reseed_offsets(model, seed):
    """Spread every DCN's offsets over several pixels, a share of them
    beyond ±3, and its mask around 0.5. The JAX init zeroes the offset/mask
    conv, which would make every DCN a plain conv and hide a broken
    sampler."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConv2d):
                com = m.conv_offset_mask
                K = com.out_channels // 3
                com.weight.normal_(0, com.weight[0].numel() ** -0.5,
                                   generator=g)
                com.bias[:2 * K].normal_(0, 2.5, generator=g)
                com.bias[2 * K:].normal_(0, 1, generator=g)


def check_lore_vs_cpu(model):
    """Head maps of one 256² page: the card's bf16 model (through K3)
    against a float32 run of the same weights on the CPU (the plain DCN);
    also the share of DCN offsets beyond ±3 on that page."""
    ref = LORE(LoreConfig(), policy=FP32_POLICY, device="cpu")
    ref.load_state_dict(model.state_dict())
    x = torch.randn(1, 256, 256, 3, generator=torch.Generator().manual_seed(3))
    beyond, biggest = [], []

    def hook(mod, inp, _):
        com = mod.conv_offset_mask
        om = torch.nn.functional.conv2d(
            inp[0].permute(0, 3, 1, 2), com.weight.to(inp[0].dtype),
            com.bias.to(inp[0].dtype), padding=1)[:, :2 * 9].float()
        beyond.append((om.abs() > 3).float().mean().item())
        biggest.append(om.abs().max().item())

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, DeformConv2d)]
    with torch.inference_mode():
        got = {k: v.float().cpu() for k, v in model(x.cuda()).items()}
        want = ref(x)
    for h in handles:
        h.remove()
    errs = {k: ((got[k] - want[k]).pow(2).mean().sqrt()
                / want[k].pow(2).mean().sqrt()).item() for k in want}
    rec = {"phase": "lore_vs_cpu_f32", "page_hw": [256, 256],
           "rel_rms_err": errs, "tol": LORE_RTOL, "dcn_layers": len(beyond),
           "offsets_beyond_3_share": [min(beyond), max(beyond)],
           "offsets_max_abs": max(biggest)}
    emit(rec)
    require(all(bool(torch.isfinite(v).all()) for v in got.values())
            and max(errs.values()) <= LORE_RTOL,
            f"LORE head maps disagree with the CPU reference: {rec}")
    require(len(beyond) == 16 and min(beyond) > 0.0,
            f"every DCN must see offsets beyond ±3: {rec}")


def lore_tsr(model):
    """bench.py lore_tsr_bench on the port; the second slice's main path."""
    B, S, iters = 8, 768, 10
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(5)
    pages = torch.randn(B, S, S, 3, device="cuda", generator=gen)
    with torch.inference_mode():
        out = model.infer(pages)
    torch.cuda.synchronize()
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    require(shapes == {"detections": (B, cfg.top_k, 10),
                       "logic": (B, cfg.top_k, 4),
                       "raw_logic": (B, cfg.top_k, 4),
                       "scores": (B, cfg.top_k),
                       "corners": (B, cfg.corner_k, 8),
                       "corner_scores": (B, cfg.corner_k, 1)}
            and all(bool(torch.isfinite(v).all()) for v in out.values()),
            f"LORE.infer output malformed: {shapes}")

    @torch.inference_mode()
    def timed_loop():
        t0 = time.perf_counter()
        for _ in range(iters):
            o = model.infer(pages)
        o["logic"].cpu()
        return B * iters / (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    reps, counts = counted(lambda: [timed_loop() for _ in range(3)])
    require(counts == {"deform_conv": 16 * 3 * iters},
            f"LORE: launches {counts}, expected 16 deform_conv a forward")
    peak = torch.cuda.max_memory_allocated() / 1e9

    marks = []           # stage boundaries by CUDA events, on module hooks

    def mark(*_):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    handles = [model.backbone.register_forward_pre_hook(mark),
               model.backbone.register_forward_hook(mark),
               model.processor.register_forward_pre_hook(mark),
               model.processor.register_forward_hook(mark)]
    with torch.inference_mode():
        for _ in range(3):
            model.infer(pages)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    stage_ms = {n: float(np.mean([marks[4 * s + i].elapsed_time(
                    marks[4 * s + i + 1]) for s in range(3)]))
                for i, n in enumerate(("backbone_and_neck", "decode",
                                       "processor"))}
    rec = {"phase": "lore_tsr", "pages": B, "page_hw": [S, S],
           "pages_per_s_reps": reps, "pages_per_s_best": max(reps),
           "stage_ms": stage_ms, "launches": counts, "peak_mem_gb": peak}
    emit(rec)
    with torch.inference_mode():
        profile_steps("lore_profile",
                      [lambda: model.infer(pages)["logic"].cpu()] * 3,
                      step_ms=1e3 * B / max(reps))
    return rec, counts


def f32_models_phase():
    """MGP-STR-base (its encoder, heads and `MGPSTRInference`) and LORE's
    DLA-34 + DCN neck (`DLASeg`, offsets re-seeded) under FP32_POLICY on
    the card: no kernel takes f32, so every module must take its plain path
    (no launch at all) and agree with the same weights in f32 on the CPU."""
    cfg = MGPSTRConfig(variant="base")
    gpu = MGPSTR(cfg, policy=FP32_POLICY, seed=0)
    cpu = MGPSTR(cfg, policy=FP32_POLICY, device="cpu", seed=0)
    images = np.random.default_rng(4).integers(0, 256, (4, 32, 128, 3),
                                               dtype=np.uint8)
    x = normalize_crops(torch.from_numpy(images), torch.float32)

    @torch.inference_mode()
    def on_card(model, inp):
        return {k: v.float().cpu() for k, v in model(inp.cuda()).items()}

    got, counts = counted(lambda: on_card(gpu, x))
    with torch.inference_mode():
        want = cpu(x)
    errs = {f"mgp_str_{k}": rel_errors(got[k], want[k])[0] for k in want}

    gpu_engine = MGPSTRInference(gpu, CharCodec(), input_dtype=torch.float32)
    cpu_engine = MGPSTRInference(cpu, CharCodec(), input_dtype=torch.float32,
                                 device="cpu")
    u8 = torch.from_numpy(images)
    out, engine_counts = counted(lambda: {
        k: v.cpu() for k, v in gpu_engine.run(u8.cuda()).items()})
    ref = cpu_engine.run(u8)
    id_mismatches, conf_err = 0, 0.0
    for head in cfg.heads:
        # greedy ids may differ only where the CPU's top two logits nearly
        # tie (the two sum in other orders)
        logits = want[head][:, 1:, :cpu_engine.true_vocab[head]]
        top2 = logits.topk(2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) < K2_TIE_GAP
        differ = out[f"{head}_ids"] != ref[f"{head}_ids"]
        id_mismatches += int((differ & ~near).sum())
        conf_err = max(conf_err, (out[f"{head}_conf"]
                                  - ref[f"{head}_conf"]).abs().max().item())
    del gpu, cpu, gpu_engine, cpu_engine

    dla = DLASeg(LoreConfig().backbone, policy=FP32_POLICY, seed=0)
    reseed_offsets(dla, seed=8)
    dla_cpu = DLASeg(LoreConfig().backbone, policy=FP32_POLICY, device="cpu")
    dla_cpu.load_state_dict(dla.state_dict())
    page = torch.randn(1, 256, 256, 3,
                       generator=torch.Generator().manual_seed(6))
    got, dla_counts = counted(lambda: on_card(dla, page))
    with torch.inference_mode():
        want = dla_cpu(page)
    errs.update({f"dla_{k}": rel_errors(got[k], want[k])[0] for k in want})
    rec = {"phase": "f32_models", "rel_rms_err": errs, "tol": F32_RTOL,
           "engine_id_mismatches_off_ties": id_mismatches,
           "engine_conf_max_abs_err": conf_err,
           "launches": [counts, engine_counts, dla_counts]}
    emit(rec)
    require(counts == engine_counts == dla_counts == {},
            f"f32 models launched a kernel: {rec}")
    require(max(errs.values()) <= F32_RTOL and id_mismatches == 0
            and conf_err <= F32_RTOL,
            f"f32 models on the card disagree with the CPU: {rec}")
    del dla, dla_cpu
    torch.cuda.empty_cache()


class PlainAttention(torch.autograd.Function):
    """The plain versions of K1 and K4 in f32 on the card, as one autograd
    Function: the reference step of the train phase."""

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


def param_group(name):
    for key, group in ((".attn.qkv.", "qkv"), (".attn.proj.", "proj"),
                       (".mlp.", "mlp"), ("token_learner", "token_learners"),
                       ("_head.", "heads"), (".norm", "norms")):
        if key in name:
            return group
    return "embed"            # patch embedding, cls token, positions


def one_step_grads(model, loss_fn, batch):
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(batch, None)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def train_flops(cfg, B):
    """Products of one train step (forward + backward = 3 forwards)."""
    vit = cfg.vit_config()
    D, S, L, T = vit.embed_dim, vit.seq_len, vit.depth, cfg.max_tokens
    hidden = int(D * vit.mlp_ratio)
    layer = 2 * S * D * (3 * D + D + 2 * hidden) + 4 * S * S * D
    patch = 2 * vit.num_patches * vit.patch_size ** 2 * vit.in_chans * D
    learner = 2 * (2 * S * D * D // 8) + 2 * S * D * T + 2 * T * S * D
    heads = sum(2 * T * D * v + learner for v in cfg.head_sizes().values())
    return 3 * B * (L * layer + patch + heads)


def train_step_phase():
    """bench.py train_bench on the port: MGP-STR-base, B=128, bf16 compute
    and f32 parameters, Adam at lr 1e-4 on a cosine over 1000 steps, clip
    5.0; the third slice's main path."""
    B, T, iters = 128, 27, 10
    cfg = MGPSTRConfig(variant="base")
    model = MGPSTR(cfg, seed=0)
    rng = np.random.default_rng(0)
    host = {"images": rng.integers(0, 256, (B, 32, 128, 3), dtype=np.uint8),
            "char_ids": rng.integers(0, 38, (B, T)).astype(np.int32),
            "bpe_ids": rng.integers(0, 50257, (B, T)).astype(np.int32),
            "wp_ids": rng.integers(0, 30522, (B, T)).astype(np.int32)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    loss_fn, _ = mgp_str_recipe_u8(model)

    # (a) one step's gradients through K1/K4 against the same step with the
    # attention swapped for the plain versions in f32
    (loss, grads), counts = counted(
        lambda: one_step_grads(model, loss_fn, batch))
    require(counts == {"fused_qkv_attention": 12,
                       "fused_qkv_attention_bwd": 12},
            f"train step: launches {counts}, expected 12 K1 + 12 K4")
    require(all(bool(g.abs().sum() > 0) for g in grads.values()),
            "a parameter got a zero gradient")
    swapped = layers.fused_qkv_attention
    layers.fused_qkv_attention = (
        lambda qkv, num_heads, scale=None, safe=True:
        PlainAttention.apply(qkv, num_heads, scale, safe))
    try:
        ref_loss, ref = one_step_grads(model, loss_fn, batch)
    finally:
        layers.fused_qkv_attention = swapped
    num, den = {}, {}
    for n, g in grads.items():
        k = param_group(n)
        num[k] = num.get(k, 0.0) + (g - ref[n]).pow(2).sum().item()
        den[k] = den.get(k, 0.0) + ref[n].pow(2).sum().item()
    errs = {k: (num[k] / den[k]) ** 0.5 for k in num}
    rec = {"phase": "train_grads_vs_plain_attention", "loss": loss,
           "plain_loss": ref_loss, "rel_rms_err": errs,
           "tol": TRAIN_GRAD_RTOL, "launches": counts}
    emit(rec)
    require(max(errs.values()) <= TRAIN_GRAD_RTOL,
            f"train gradients disagree with the plain attention: {rec}")
    del grads, ref

    # (b)-(d) the timed loop of make_mgp_str_train_step on a repeated batch
    state = TrainState.create(model, make_optimizer(
        lr=1e-4, total_steps=1000, grad_clip=5.0))
    step = make_mgp_str_train_step(model, state)
    fbatch = {**batch, "images": normalize_crops(batch["images"])}
    losses = [step(fbatch)["loss"] for _ in range(2)]          # warm up
    torch.cuda.reset_peak_memory_stats()

    def timed_loop():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            losses.append(step(fbatch)["loss"])
        torch.cuda.synchronize()
        return B * iters / (time.perf_counter() - t0)

    reps, counts = counted(lambda: [timed_loop() for _ in range(3)])
    require(counts == {"fused_qkv_attention": 12 * 3 * iters,
                       "fused_qkv_attention_bwd": 12 * 3 * iters},
            f"train loop: launches {counts}, expected 12 K1 + 12 K4 a step")
    peak = torch.cuda.max_memory_allocated() / 1e9
    split = []                        # forward, backward, optimiser
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        out = mgp_str_loss(model(fbatch["images"]), fbatch)["loss"]
        ev[1].record()
        out.backward()
        ev[2].record()
        state.apply_gradients()
        ev[3].record()
        split.append(ev)
    torch.cuda.synchronize()
    split_ms = {n: float(np.mean([e[i].elapsed_time(e[i + 1])
                                  for e in split]))
                for i, n in enumerate(("forward", "backward", "optimizer"))}
    losses = [v.item() for v in losses]
    step_ms = 1e3 * B / max(reps)
    flops = train_flops(cfg, B)
    rec = {"phase": "train_step", "batch": B, "samples_per_s_reps": reps,
           "samples_per_s_best": max(reps), "step_ms": step_ms,
           "split_ms": split_ms, "tflop_per_step": flops / 1e12,
           "mfu": flops / (step_ms * 1e-3) / BF16_FLOP_PER_S,
           "peak_mem_gb": peak, "launches": counts,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses}
    emit(rec)
    require(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    require(np.mean(losses[-5:]) < np.mean(losses[:5]),
            f"the loss does not fall over {len(losses)} steps: {losses}")
    profile_steps("train_profile",
                  [lambda: step(fbatch)["loss"].item()] * 3, step_ms=step_ms)
    del state, step
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return rec, counts, host


def fit_phase(host):
    """fit() with mgp_str_recipe_u8 on MGP-STR-base: 4 steps saving every
    2 and keeping 1, then a restore of the last checkpoint into a fresh
    state equals the live one; a resume to step 6 equals an uninterrupted
    6-step run (the backward is deterministic)."""

    def batches():
        while True:
            yield host

    def run(total, ckpt_dir, resume=False):
        model = MGPSTR(MGPSTRConfig(variant="base"), seed=0)
        loss_fn, tx = mgp_str_recipe_u8(model)
        return fit(loss_fn, tx, model, batches(),
                   FitConfig(total_steps=total, log_interval=2,
                             save_interval=2, keep_last=1, ckpt_dir=ckpt_dir,
                             resume=resume), log_fn=lambda m: None)

    with tempfile.TemporaryDirectory() as tmp:
        a = os.path.join(tmp, "a")
        t0 = time.perf_counter()
        first = run(4, a)
        fit_s = time.perf_counter() - t0
        kept = sorted(d for d in os.listdir(a) if d.startswith("step_"))
        fresh = TrainState.create(MGPSTR(MGPSTRConfig(variant="base"),
                                         seed=1), first.state.tx)
        restore_train_state(os.path.join(a, "step_4"), fresh)
        params_equal = all(torch.equal(p, q) for p, q in zip(
            fresh.model.state_dict().values(),
            first.state.model.state_dict().values()))
        opt_equal = all(
            torch.equal(s[k], t[k].to(s[k].device)) for s, t in zip(
                fresh.optimizer.state.values(),
                first.state.optimizer.state.values()) for k in s)
        del fresh, first
        resumed = run(6, a, resume=True)
        straight = run(6, None)
        resume_diff = max((p - q).abs().max().item() for p, q in zip(
            resumed.state.model.state_dict().values(),
            straight.state.model.state_dict().values()))
        rec = {"phase": "fit", "steps": 4, "fit_s": fit_s, "kept": kept,
               "restore_params_equal": params_equal,
               "restore_opt_state_equal": opt_equal,
               "resumed_steps_run": resumed.steps_run,
               "resume_vs_uninterrupted_max_abs_diff": resume_diff,
               "last_metrics": straight.last_metrics}
        emit(rec)
    require(kept == ["step_4"] and params_equal and opt_equal
            and resumed.steps_run == 2,
            f"fit checkpoints malformed: {rec}")
    require(np.isfinite(straight.last_metrics["loss"]),
            f"fit loss not finite: {rec}")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    seconds = _kernels.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "wgmma" in ln]
             for n, log in _kernels.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": seconds, "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H in ((3, 17, 2), (2, 64, 1), (4, 100, 3), (2, 700, 2)):
        check_attention(B, S, H, True, gen, time_it=False)
    # both sides of the 64-row tiles, a 16-key short last chunk, S=768
    for S in (1, 63, 64, 65, 129, 257, 320, 768):
        for safe in (True, False):
            check_attention(3, S, 5, safe, gen, time_it=False)
    check_attention(256, 257, 12, True, gen)
    check_attention(256, 257, 12, False, gen)
    k1 = check_attention(512, 257, 12, False, gen)      # e2e: 8 x 64 crops
    k1_err = k1["max_abs_err"]
    short_tail_probe(gen)
    # rows and columns off the 128 x 256 tiles and 2048-column chunks, a
    # single row, true_vocab inside the last tile, ties across tiles and
    # across a chunk boundary
    k2_err = 0.0
    for M, V, true_v, extra in ((300, 1200, 1190, ()),
                                (127, 4100, 4097, ((255, 256), (2047, 2048))),
                                (129, 2304, 2200, ((2047, 2048),)),
                                (1, 30592, 30522, ())):
        k2_err = max(k2_err, check_decode(M, V, true_v, gen, time_it=False,
                                          extra_pairs=extra)["max_abs_err"])
    k2 = None
    for M in (6656, 13312):                               # 256 / 512 crops
        for V, true_v in ((50304, 50257), (30592, 30522)):
            rec = check_decode(M, V, true_v, gen)
            k2_err = max(k2_err, rec["max_abs_err"])
            if M == 13312 and V == 50304:
                k2 = rec
    torch.cuda.empty_cache()

    cfg = MGPSTRConfig(variant="base")
    vit = cfg.vit_config()
    require(vit.embed_dim == 768 and vit.depth == 12, "not MGP-STR-base")
    engine = MGPSTRInference(MGPSTR(cfg, seed=0), CharCodec())
    images = np.random.default_rng(0).integers(0, 256, (256, 32, 128, 3),
                                               dtype=np.uint8)
    check_encoder(engine, cfg, images)
    rec_only(engine, images)
    texts = engine.recognize(images[:4])
    emit({"phase": "recognize", "results": texts})
    require(len(texts) == 4 and all(0.0 <= c <= 1.0 for _, c, _ in texts),
            "recognize() output malformed")

    _, counts = e2e_spotting(engine)
    del engine
    torch.cuda.empty_cache()

    k3_err = 0.0
    # pixels off the 8 x 16 tiles, Cin off the 64-channel stages and the
    # 8-channel vectors, Cout at N = 64, 128, 256 and two column blocks
    for B, H, Cin, Cout, case in ((3, 13, 40, 72, "normal"),
                                  (2, 37, 200, 100, "normal"),
                                  (1, 24, 5, 7, "normal"),
                                  (1, 9, 200, 200, "normal"),
                                  (2, 24, 512, 256, "normal"),
                                  (1, 11, 64, 300, "normal"),
                                  (3, 5, 8, 128, "normal"),
                                  (2, 48, 64, 64, "far"),
                                  (2, 48, 64, 64, "beyond3"),
                                  (2, 48, 64, 64, "outside"),
                                  (1, 10, 5, 7, "outside"),
                                  (1, 10, 512, 256, "outside"),
                                  (2, 48, 64, 64, "zero_mask")):
        k3_err = max(k3_err, check_deform_conv(B, H, H + 3, Cin, Cout, gen,
                                               case)["max_abs_err"])
    path = []
    for B, H, Cin, Cout, n in DCN_PATH_SHAPES:
        rec = check_deform_conv(B, H, H, Cin, Cout, gen, time_it=True,
                                time_plain=H == 192)
        k3_err = max(k3_err, rec["max_abs_err"])
        path.append((n, rec))
    k3 = path[-1][1]                                    # 64 -> 64 at 192²
    emit({"phase": "deform_conv_per_forward", "layers": 16,
          **{key: sum(n * r[key] for n, r in path)
             for key in ("ms", "library_ms", "bound_ms")}})
    torch.cuda.empty_cache()

    lore = LORE(LoreConfig(), seed=0)
    require(lore.config.backbone.dla.channels[-1] == 512
            and lore.config.backbone.head_conv == 256
            and lore.config.hidden_size == 256, "not the full LoreConfig")
    reseed_offsets(lore, seed=7)
    check_lore_vs_cpu(lore)
    _, lore_counts = lore_tsr(lore)
    del lore
    torch.cuda.empty_cache()
    f32_models_phase()

    bwd_err = 0.0
    # both sides of the 64-row tiles and of a 16-row short last chunk, one
    # and two heads a block (an odd number of heads: B=3, H=1), and a scale
    # that is no power of two
    for S in K4_SEQS:
        for B, H in ((3, 1), (2, 3), (1, 12)):
            bwd_err = max(bwd_err,
                          check_attention_bwd(B, S, H, gen)["max_abs_err"])
    for B, S, H, scale in ((2, 257, 3, 0.1), (1, 768, 2, 0.3)):
        bwd_err = max(bwd_err, check_attention_bwd(
            B, S, H, gen, scale=scale)["max_abs_err"])
    k4 = check_attention_bwd(128, 257, 12, gen, time_it=True)
    k4_long = check_attention_bwd(16, 768, 12, gen, time_it=True)
    bwd_err = max(bwd_err, k4["max_abs_err"], k4_long["max_abs_err"])
    mha_err = 0.0
    for B, S, H in ((3, 17, 2), (2, 300, 3), (1, 1000, 2)):
        mha_err = max(mha_err, check_mha(B, S, H, gen)["max_abs_err"])
    # resident (S <= 320) and streamed, in each layout K5 reads in place
    for S in (1, 64, 65, 257, 513, 640, 1024):
        for layout in ("qkv", "q+kv", "bhsd"):
            mha_err = max(mha_err, check_mha(2, S, 3, gen, layout=layout)[
                "max_abs_err"])
    k5 = check_mha(128, 257, 12, gen, time_it=True)
    k5_long = check_mha(16, 1024, 12, gen, time_it=True)
    mha_err = max(mha_err, k5["max_abs_err"], k5_long["max_abs_err"])
    torch.cuda.empty_cache()

    _, train_counts, host = train_step_phase()
    fit_phase(host)
    torch.cuda.empty_cache()
    print(smi, flush=True)      # again beside the summary, for short tails
    emit({"kernels": [
        {"name": "fused_qkv_attention", "route": "cuda", "source": ATTN_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/attention.py:51",
         "launches": counts["fused_qkv_attention"], "max_abs_err": k1_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"],
         "library_strided_ms": k1["library_strided_ms"],
         "library": "scaled_dot_product_attention on contiguous BHSD "
                    "copies (library_ms) and on strided views of qkv "
                    "(library_strided_ms)",
         "shape": "B=512 S=257 D=768 H=12"},
        {"name": "vocab_greedy_decode", "route": "cuda", "source": DECODE_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/vocab_decode.py:39",
         "launches": counts["vocab_greedy_decode"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"],
         "shape": "M=13312 D=768 V=50304 (true 50257)"},
        {"name": "deform_conv", "route": "cuda", "source": DCN_SRC,
         "replaces":
             "advancedliteratemachinery_tpu/ops/deform_conv_pallas.py:36",
         "launches": lore_counts["deform_conv"], "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"],
         "library": "F.conv2d: the same layer at zero offsets, unit mask",
         "shape": "B=8 H=W=192 Cin=64 Cout=64"},
        {"name": "fused_qkv_attention_bwd", "route": "cuda",
         "source": BWD_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/attention.py:165",
         "launches": train_counts["fused_qkv_attention_bwd"],
         "max_abs_err": bwd_err, "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": k4["library_ms"],
         "library": "backward of scaled_dot_product_attention on strided "
                    "views of the same q/k/v",
         "shape": "B=128 S=257 D=768 H=12",
         "s768": {key: k4_long[key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "mha_short_seq", "route": "cuda", "source": MHA_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/attention.py:276",
         "launches": train_counts.get("mha_short_seq", 0),
         "main_path": "none: no path of the JAX package reaches it",
         "max_abs_err": mha_err, "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": k5["library_ms"],
         "library": "scaled_dot_product_attention on the same views",
         "shape": "B=128 S=257 H=12 hd=64, strided views of one projection",
         "s1024": {key: k5_long[key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
