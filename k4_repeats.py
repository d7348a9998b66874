"""Repeatability of K4, the fused-qkv attention backward, on the card.

K4 adds no float atomically, so two calls on the same inputs must give the
same bits. This script calls it in pairs at the MGP-STR-base train shape
(B=128, S=257, H=12) on fixed inputs and counts the calls whose bits
differ from a first reference call, with nothing, other K4 shapes (the
scaled-q path among them), or K1 and K5 launched before each pair. With
`--after-phases` it first runs `chip_smoke.py`'s f32-model,
reference-checkpoint and LISTER phases, to leave the card as the smoke
leaves it before its K4 checks. One JSON line a case; exits 1 when any
call differs. Needs one H100:

    python3 k4_repeats.py [--pairs 400] [--after-phases]
"""

import argparse
import json
import subprocess
import sys
import time

import torch

from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.attention import (
    fused_qkv_attention, fused_qkv_attention_bwd, mha_short_seq)


def where(a, b, H):
    """Which of dq, dk, dv differ, and in which batches, rows and heads."""
    B, S, _ = a.shape
    D = H * 64
    d = (a.float() - b.float()).abs()
    out = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        x = d[..., i * D:(i + 1) * D].reshape(B, S, H, 64)
        nz = x.nonzero()
        if len(nz):
            out[name] = {"n": len(nz), "max": x.max().item(),
                         "batches": sorted(set(nz[:, 0].tolist()))[:8],
                         "rows": sorted(set(nz[:, 1].tolist()))[:32],
                         "heads": sorted(set(nz[:, 2].tolist()))[:12]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=400)
    ap.add_argument("--after-phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_repeats: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build()
    if args.after_phases:
        import chip_smoke
        chip_smoke.f32_models_phase()
        chip_smoke.reference_checkpoints()
        chip_smoke.lister_phase()

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S, H):
        D = H * 64
        return (torch.randn(B, S, 3 * D, generator=gen,
                            device="cuda").bfloat16(),
                torch.randn(B, S, D, generator=gen, device="cuda").bfloat16())

    big = inputs(128, 257, 12)
    ref = fused_qkv_attention_bwd(*big, 12)
    others = [(inputs(1, 768, 2), 2, 0.3), (inputs(2, 257, 3), 3, 0.1),
              (inputs(3, 63, 1), 1, None), (inputs(1, 768, 12), 12, None)]
    k1_in = torch.randn(512, 257, 3 * 768, generator=gen,
                        device="cuda").bfloat16()

    def other_k4(i):
        for (qkv, dout), H, scale in others:
            fused_qkv_attention_bwd(qkv, dout, H, scale)

    def k1_k5(i):
        fused_qkv_attention(k1_in, 12, safe=bool(i % 2))
        q, k, v = k1_in[:128].view(128, 257, 3, 12, 64).unbind(2)
        mha_short_seq(q, k, v)

    def synced(i):
        other_k4(i)
        torch.cuda.synchronize()

    total = 0
    for label, before in (("nothing", lambda i: None),
                          ("other K4 shapes", other_k4),
                          ("K1 and K5", k1_k5),
                          ("other K4 shapes, then a sync", synced)):
        t0 = time.perf_counter()
        bad = []
        for i in range(args.pairs):
            before(i)
            pair = (fused_qkv_attention_bwd(*big, 12),
                    fused_qkv_attention_bwd(*big, 12))
            for j, got in enumerate(pair):
                if not torch.equal(got, ref):
                    bad.append({"pair": i, "call": j,
                                "differs": where(got, ref, 12)})
        total += len(bad)
        print(json.dumps({"before_each_pair": label, "pairs": args.pairs,
                          "calls_differing": len(bad), "first": bad[:3],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
