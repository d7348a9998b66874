"""Repeatability of K4, the fused-qkv attention backward, on the card.

K4 adds no float atomically, so two calls on the same inputs must give the
same bits. Needs one H100. Modes:

    python3 k4_repeats.py [--pairs 1000] [--after-phases]
        `chip_smoke.py`'s K4 stress (`k4_stress`): K4 in pairs at the
        MGP-STR-base train shape (B=128, S=257, H=12) on fixed inputs,
        each call's bits against a first call's, each call on output and
        statistics memory filled with 0xFF bytes first (NaN wherever K4
        leaves an element unwritten), with nothing, other K4 shapes (the
        scaled-q path among them), K1 and K5, or another shape and a
        synchronize before each pair, beside a side stream of matmuls.
        With `--after-phases` it first runs `chip_smoke.py`'s f32-model,
        reference-checkpoint and LISTER phases. One JSON line.
    python3 k4_repeats.py --fresh 12 --pairs 100
        the same in 12 fresh processes, one after another (the first calls
        of a process on a cold card), and their sum.
    python3 k4_repeats.py --sass [--out k4.sass]
        disassembles the built library (`cuobjdump -sass`) and lists every
        instruction that writes a register holding an A fragment of an
        `HGMMA` (wgmma with A in registers) before a `WARPGROUP.DEPBAR`
        that covers that HGMMA's commit group, along every control path.
    python3 k4_repeats.py --time [--root DIR]
        K4's time at the train shape (CUDA events, 5 x 20 calls, the
        best); with `--root` the package is imported from DIR (a copy of
        another tree), so two trees compare in one call.

Every mode prints the card's name and power limit first; the counting
modes exit 1 when any call differs or holds a non-finite element,
`--sass` when any hazard is found.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time


# ---------------- SASS: A-fragment registers of HGMMA in flight ----------

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_REG = re.compile(r"^R(\d+)$")
_NO_DEST = ("ST", "RED", "BAR", "BRA", "EXIT", "RET", "WARPGROUP", "SYNCS",
            "UTMA", "NOP", "CALL", "BSSY", "BSYNC", "WARPSYNC", "MEMBAR",
            "FENCE", "DEPBAR", "YIELD", "ERRBAR", "CCTL", "UBLKCP")


def _parse(line):
    m = _INSN.search(line)
    if not m:
        return None
    text = m.group(2).strip()
    pred = None
    if text.startswith("@"):
        pred, text = text.split(None, 1)
    op, _, rest = text.partition(" ")
    ops = [o.strip() for o in rest.split(",")] if rest else []
    return {"addr": int(m.group(1), 16), "pred": pred, "op": op,
            "ops": ops, "text": m.group(2).strip()}


def _width(op):
    if op.startswith("HGMMA"):
        return int(re.search(r"64x(\d+)x", op).group(1)) // 2
    if ".128" in op or ".M88.4" in op or ".MT88.4" in op:
        return 4
    if ".64" in op or ".WIDE" in op or ".M88.2" in op or ".MT88.2" in op:
        return 2
    return 1


def _dest(ins):
    """The general registers an instruction writes (first operand)."""
    op, ops = ins["op"], ins["ops"]
    if op.startswith(_NO_DEST) or not ops:
        return set()
    first = ops[0]
    if op.startswith("SHFL") and len(ops) > 1:
        first = ops[1]
    m = _REG.match(first)
    if not m:
        return set()
    base = int(m.group(1))
    return set(range(base, base + _width(op)))


def sass_hazards(sass: str):
    """Per function: every RS HGMMA and, along each control path from it,
    the instructions that write one of its four A registers before a
    `WARPGROUP.DEPBAR.LE gsb0, N` with at least N commit groups issued
    after its own (a group is closed by the HGMMA that carries `gsb0`)."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is not None:
            ins = _parse(line)
            if ins:
                cur.append(ins)
    report = {}
    for name, code in funcs.items():
        at = {ins["addr"]: i for i, ins in enumerate(code)}
        rs, found = 0, []
        for i, ins in enumerate(code):
            if not (ins["op"].startswith("HGMMA") and len(ins["ops"]) > 1
                    and _REG.match(ins["ops"][1])):
                continue
            rs += 1
            a0 = int(_REG.match(ins["ops"][1]).group(1))
            regs = set(range(a0, a0 + 4))
            closed = "gsb0" in ins["ops"]
            # (index, newer groups, own group closed)
            stack, seen = [(i + 1, 0, closed)], set()
            while stack:
                j, newer, closed = stack.pop()
                if j >= len(code) or (j, min(newer, 4), closed) in seen:
                    continue
                seen.add((j, min(newer, 4), closed))
                x = code[j]
                if x["op"].startswith("WARPGROUP.DEPBAR"):
                    n = int(x["ops"][-1], 16) if x["ops"] else 0
                    if closed and newer >= n:
                        continue               # covered on this path
                w = _dest(x) & regs
                if w and not x["op"].startswith("HGMMA"):
                    found.append({"hgmma": hex(ins["addr"]),
                                  "hgmma_text": ins["text"],
                                  "writer": hex(x["addr"]),
                                  "writer_text": x["text"],
                                  "groups_after": newer})
                    continue
                if x["op"].startswith("HGMMA") and "gsb0" in x["ops"]:
                    if closed:
                        newer += 1
                    closed = True
                succ = []
                if x["op"].startswith("BRA"):
                    t = re.search(r"0x([0-9a-f]+)", x["text"])
                    if t and int(t.group(1), 16) in at:
                        succ.append(at[int(t.group(1), 16)])
                    if x["pred"] is not None:
                        succ.append(j + 1)
                elif not (x["op"].startswith(("EXIT", "RET"))
                          and x["pred"] is None):
                    succ.append(j + 1)
                stack.extend((s, newer, closed) for s in succ)
        report[name] = {"rs_hgmma": rs, "hazards": len(found),
                        "first": found[:6]}
    return report


def sass_mode(out_path):
    from advancedliteratemachinery_tpu_torch.ops import _kernels

    _kernels.build(["fused_qkv_attention_bwd"])
    lib = _kernels._lib_path("fused_qkv_attention_bwd")
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            f.write(sass)
    report = sass_hazards(sass)
    log = _kernels.BUILD_LOG.get("fused_qkv_attention_bwd", "")
    print(json.dumps({"sass": report, "lib": lib.name, "ptxas": [
        ln for ln in log.splitlines()
        if "wgmma" in ln or "spill" in ln or "registers" in ln]}),
        flush=True)
    return 1 if any(r["hazards"] for r in report.values()) else 0


# ---------------- the calls ----------------

def pairs_mode(args):
    import torch

    from advancedliteratemachinery_tpu_torch.ops import _kernels

    _kernels.build()
    import chip_smoke
    if args.after_phases:
        chip_smoke.f32_models_phase()
        chip_smoke.reference_checkpoints()
        chip_smoke.lister_phase()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = chip_smoke.k4_stress(gen, args.pairs)
    print(json.dumps(rec), flush=True)
    return 1 if rec["calls_differing"] or rec["calls_nonfinite"] else 0


def fresh_mode(args):
    t0 = time.perf_counter()
    calls, differing, nonfinite, failed = 0, 0, 0, 0
    for k in range(args.fresh):
        cmd = [sys.executable, os.path.abspath(__file__), "--pairs",
               str(args.pairs)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        for ln in p.stdout.splitlines():
            if ln.startswith("{"):
                rec = json.loads(ln)
                calls += rec["calls"]
                differing += rec["calls_differing"]
                nonfinite += rec["calls_nonfinite"]
        failed += p.returncode not in (0, 1)
        if p.returncode not in (0, 1):
            print(p.stdout[-2000:], p.stderr[-2000:], flush=True)
    print(json.dumps({"fresh_processes": args.fresh, "calls": calls,
                      "calls_differing": differing,
                      "calls_nonfinite": nonfinite,
                      "processes_failed": failed,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if differing or nonfinite or failed else 0


def time_mode():
    import torch

    from advancedliteratemachinery_tpu_torch.ops.attention import (
        fused_qkv_attention_bwd)

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(128, 257, 3 * 768, generator=gen,
                      device="cuda").bfloat16()
    dout = torch.randn(128, 257, 768, generator=gen, device="cuda").bfloat16()
    for _ in range(3):
        fused_qkv_attention_bwd(qkv, dout, 12)
    best = float("inf")
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(20):
            fused_qkv_attention_bwd(qkv, dout, 12)
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / 20)
    import advancedliteratemachinery_tpu_torch as pkg
    print(json.dumps({"k4_ms_b128_s257": best,
                      "package": os.path.dirname(pkg.__file__)}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=1000)
    ap.add_argument("--after-phases", action="store_true")
    ap.add_argument("--fresh", type=int, default=0)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--root", default="")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("k4_repeats: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.sass:
        return sass_mode(args.out)
    if args.time:
        return time_mode()
    if args.fresh:
        return fresh_mode(args)
    return pairs_mode(args)


if __name__ == "__main__":
    sys.exit(main())
