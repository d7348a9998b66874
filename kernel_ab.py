"""K1-K5's times on the card in two trees of this repo, alternated in one
call, so that a change's effect on a kernel can be told from the card's
noise. Needs one H100.

    python3 kernel_ab.py --roots OLD NEW [--rounds 2] [--out FILE]

Each root is a checkout of the repo (a directory holding `chip_smoke.py`
and the port's package). For every round it runs OLD, NEW, NEW, OLD, each
in a process of its own that imports the package and `chip_smoke.py` from
that root, builds its kernels there, and times K1-K5 at the shapes of
`PERF.md`'s kernel table with `chip_smoke.py`'s own checks (CUDA events,
the mean of 10 calls after 2, each check against its plain version first).
Prints the card's name and power limit, one JSON line a process, and a
last JSON line with each kernel's times by root and the change of NEW's
mean over OLD's.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

# (name, check, arguments after `gen`): PERF.md's kernel table
SHAPES = (
    ("K1 B=512 S=257 unsafe", "check_attention", (512, 257, 12, False), {}),
    ("K2 M=13312 V=50304", "check_decode", (13312, 50304, 50257), {}),
    ("K3 B=8 192x192 64->64", "check_deform_conv", (8, 192, 192, 64, 64),
     {"time_it": True}),
    ("K4 B=128 S=257", "check_attention_bwd", (128, 257, 12),
     {"time_it": True}),
    ("K4 B=16 S=768", "check_attention_bwd", (16, 768, 12),
     {"time_it": True}),
    ("K5 B=128 S=257", "check_mha", (128, 257, 12), {"time_it": True}),
    ("K5 B=16 S=1024", "check_mha", (16, 1024, 12), {"time_it": True}),
)


def time_one(root: str) -> dict:
    """K1-K5's times with the package and smoke of `root`."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from advancedliteratemachinery_tpu_torch.ops import _kernels
    for mod in (cs, _kernels):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} imported from {mod.__file__}, "
                               f"not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = {}
    for name, check, args, kwargs in SHAPES:
        with contextlib.redirect_stdout(io.StringIO()):
            rec = getattr(cs, check)(*args, gen, **kwargs)
        ms[name] = rec["ms"]
        torch.cuda.empty_cache()
    return {"root": root, "ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="also write the last line's JSON here")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_one(args.one)), flush=True)
        return 0
    if not args.roots:
        ap.error("--roots OLD NEW is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    old, new = (os.path.abspath(r) for r in args.roots)
    runs = {old: [], new: []}
    for _ in range(args.rounds):
        for root in (old, new, new, old):
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", root], capture_output=True,
                               text=True, timeout=900)
            if p.returncode != 0:
                print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
                return 1
            rec = json.loads(p.stdout.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            runs[root].append(rec["ms"])
    summary = {}
    for name, *_ in SHAPES:
        a = [r[name] for r in runs[old]]
        b = [r[name] for r in runs[new]]
        summary[name] = {"old_ms": a, "new_ms": b,
                         "new_over_old": (sum(b) / len(b)) / (sum(a) / len(a))
                         - 1.0}
    line = json.dumps({"old": old, "new": new, "kernels": summary})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
