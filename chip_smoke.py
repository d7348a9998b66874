"""Drive the PyTorch/H100 port (`advancedliteratemachinery_tpu_torch`) on one
CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. build the CUDA kernels from `advancedliteratemachinery_tpu_torch/csrc/`;
2. fused-qkv attention kernel against its plain version, at the recognizer's
   shapes (B=256 and 512, S=257, D=768, H=12, safe and unsafe) and at odd
   small shapes (S = 17, 64, 100, 700);
3. vocab matmul + greedy decode kernel against its plain version, at the
   BPE (V=50304, true 50257) and WordPiece (V=30592, true 30522) heads for
   256 and 512 crops and at one shape off the tiles, with crafted rows
   whose maximum is an exact tie;
4. recognition only: MGP-STR-base at full width and depth (D=768, 12
   layers) with seeded random weights, B=256 crops/s and B=1 latency, an
   encoder check against a float32 run on the CPU, and `recognize()`;
5. end-to-end spotting, the main path: P=8 uint8 pages of 640² → DB →
   box extraction → crop_rects → MGP-STR-base → greedy decode, with the
   page copy to the card inside the timed loop, as `bench.py`'s spotting
   stage; extraction is checked against the CPU on one page, and a
   torch.profiler trace of three more steps gives device time by kernel and
   the device's idle share.

Launch counts are zeroed just before each recognizer path and read just
after: every recognizer forward must launch the attention kernel 12 times
and the vocab kernel twice. Every time printed is this card's own, taken
with CUDA events or, end to end, with the host clock after a synchronize.
The second-to-last line is one JSON object `{"kernels": [...]}`; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from advancedliteratemachinery_tpu_torch.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.infer import MGPSTRInference
from advancedliteratemachinery_tpu_torch.models.db import DBConfig, DBDetector
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.attention import (
    fused_qkv_attention, fused_qkv_attention_plain)
from advancedliteratemachinery_tpu_torch.ops.cc_extract import (
    extract_boxes_device)
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

ATTN_SRC = "advancedliteratemachinery_tpu_torch/csrc/fused_qkv_attention.cu"
DECODE_SRC = "advancedliteratemachinery_tpu_torch/csrc/vocab_greedy_decode.cu"


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
    qkv32 = qkv.float()
    want = fused_qkv_attention_plain(qkv32, H, safe=safe)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    rec = {"phase": "attention", "B": B, "S": S, "H": H, "safe": safe,
           "max_abs_err": err, "tol": K1_TOL}
    require(out.shape == (B, S, D) and err <= K1_TOL,
            f"fused_qkv_attention disagrees with its plain version: {rec}")
    if time_it:
        q, k, v = (t.contiguous() for t in
                   qkv.view(B, S, 3, H, 64).permute(2, 0, 3, 1, 4))
        rec["ms"] = cuda_ms(lambda: fused_qkv_attention(qkv, H, safe=safe))
        rec["plain_ms"] = cuda_ms(
            lambda: fused_qkv_attention_plain(qkv32, H, safe=safe), iters=3)
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        rec["bound_ms"], rec["bound_by"] = bound(
            B * S * 4 * D * 2, 4 * B * H * S * S * 64)
    emit(rec)
    return rec


def check_decode(M, V, true_v, gen, time_it=True):
    D = 768
    tok = torch.randn(M, D, generator=gen, device="cuda")
    w = torch.randn(V, D, generator=gen, device="cuda") * 0.05
    b = torch.randn(V, generator=gen, device="cuda") * 0.1
    # crafted exact ties: columns j2 copy j1 (same tile, same chunk, other
    # chunk), and row i is steered onto its pair; the lower index must win
    pairs = [(3, 77), (200, 900), (1000, true_v - 60)]
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
    profile_steps(spot_step, pages_np[:3])
    return rec, counts


def profile_steps(step, pages_np):
    """Device time by kernel name over a few e2e steps (torch.profiler), and
    the share of their wall time in which no kernel or copy ran (the
    profiler's own overhead counts into the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in pages_np:
            step(torch.from_numpy(p).cuda())["char_ids"].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": "e2e_profile", "steps": len(pages_np),
          "wall_ms_per_step": wall_ms / len(pages_np),
          "device_busy_ms_per_step": busy_ms / len(pages_np),
          "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
          "top_device_ms_per_step": [
              [e.key[:90], e.self_device_time_total / 1e3 / len(pages_np)]
              for e in top]})


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
                 if "registers" in ln or "spill" in ln]
             for n, log in _kernels.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": seconds, "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H in ((3, 17, 2), (2, 64, 1), (4, 100, 3), (2, 700, 2)):
        check_attention(B, S, H, True, gen, time_it=False)
    check_attention(256, 257, 12, True, gen)
    check_attention(256, 257, 12, False, gen)
    k1 = check_attention(512, 257, 12, False, gen)      # e2e: 8 x 64 crops
    k1_err = k1["max_abs_err"]
    k2_err = check_decode(300, 1200, 1190, gen, time_it=False)[
        "max_abs_err"]                  # rows and columns off the tiles
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
    emit({"kernels": [
        {"name": "fused_qkv_attention", "route": "cuda", "source": ATTN_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/attention.py:51",
         "launches": counts["fused_qkv_attention"], "max_abs_err": k1_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"], "shape": "B=512 S=257 D=768 H=12"},
        {"name": "vocab_greedy_decode", "route": "cuda", "source": DECODE_SRC,
         "replaces": "advancedliteratemachinery_tpu/ops/vocab_decode.py:39",
         "launches": counts["vocab_greedy_decode"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"],
         "shape": "M=13312 D=768 V=50304 (true 50257)"},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
