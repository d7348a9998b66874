"""Where `ccocr-collect --model pipeline` spends its time on one thread
and on four threads sharing one card. Needs one H100.

    python3 collect_profile.py [--out FILE]

Builds `chip_smoke.py`'s CC-OCR tree (the docxchain phase's 16 page
files: two JPEGs, fourteen PNGs) and the CLI's reading pipeline
(MGP-STR-base, DB, host box extraction) with the smoke's readable
weights, runs it once to warm up, then runs `collect_predictions` over the
tree at each setting of SETTINGS:

- workers 1, 2 and 4, each thread decoding its page file when it comes
  (1 and 4 again last, for the spread between runs);
- workers 4 with the interpreter's switch interval at 0.1 ms and at 20 ms
  instead of 5 ms (how often a thread waiting for the GIL makes the
  holder hand it over);
- workers 1 and 4 with torch's intra-op threads at 1 (no thread pool per
  worker on the host's cores);
- workers 4 with one page decoded at a time (a lock around the file
  decode, as `ccocr-collect --model pipeline` runs), the rest of the
  pipeline still on four threads.

For each setting it prints one JSON line: pages/s; the process's CPU
seconds in user and in kernel mode and its voluntary and involuntary
context switches (`getrusage`); each stage's wall and thread-CPU seconds
summed over the pages (file decode; detection: DB on the card and the
host box extraction; recognition: crops and MGP-STR on the card); and
where the worker threads stood, sampled every 5 ms from
`sys._current_frames()` (the innermost frame, and the innermost frame of
the port's package). Every setting's responses must equal the first's.
Prints the card's name and power limit first and a summary JSON line
last.
"""

import argparse
import collections
import json
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time
from argparse import Namespace

import torch

import chip_smoke as cs

# (name, workers, switch interval s or None, torch threads or None, one
# page decoded at a time); the default settings run again last, for the
# spread between runs
SETTINGS = (("w1", 1, None, None, False), ("w2", 2, None, None, False),
            ("w4", 4, None, None, False),
            ("w4_switch_0.1ms", 4, 1e-4, None, False),
            ("w4_switch_20ms", 4, 2e-2, None, False),
            ("w1_torch_threads_1", 1, None, 1, False),
            ("w4_torch_threads_1", 4, None, 1, False),
            ("w4_decode_locked", 4, None, None, True),
            ("w1_again", 1, None, None, False),
            ("w4_again", 4, None, None, False))
STAGES = ("decode", "detection", "recognition")
PKG = os.sep + "advancedliteratemachinery_tpu_torch" + os.sep


class StageClock:
    """Wall and thread-CPU seconds of each stage, summed over calls from
    every thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.wall = dict.fromkeys(STAGES, 0.0)
        self.cpu = dict.fromkeys(STAGES, 0.0)

    def wrap(self, stage, fn, lock=None):
        """`fn` timed into `stage`; while `lock[0]` is set, called under
        that lock (its wait counted in the stage's wall time)."""
        def timed(*a, **k):
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                if lock and lock[0]:
                    with lock[0]:
                        return fn(*a, **k)
                return fn(*a, **k)
            finally:
                w, c = time.perf_counter() - w0, time.thread_time() - c0
                with self.lock:
                    self.wall[stage] += w
                    self.cpu[stage] += c
        return timed


class Sampler(threading.Thread):
    """Every `period` s, the innermost frame of each thread but this one
    and the main thread (when the pool runs the pages), tallied."""

    def __init__(self, period=5e-3):
        super().__init__(daemon=True)
        self.period, self.stop = period, threading.Event()
        self.inner, self.port = collections.Counter(), collections.Counter()
        self.skip = {threading.main_thread().ident}
        self.samples = 0

    def run(self):
        me = threading.get_ident()
        while not self.stop.wait(self.period):
            frames = sys._current_frames()
            for tid, frame in frames.items():
                if tid == me or tid in self.skip:
                    continue
                self.samples += 1
                self.inner[where(frame)] += 1
                f = frame
                while f is not None and PKG not in f.f_code.co_filename:
                    f = f.f_back
                self.port[where(f) if f else "(outside the package)"] += 1


def where(frame):
    code = frame.f_code
    return (f"{os.path.basename(code.co_filename)}:{code.co_name}:"
            f"{frame.f_lineno}")


def pipeline_model_fn(cli):
    """The CLI's `--model pipeline` callable (`cli._pipeline_model_fn`)
    built from the same parts, but with the file decode outside its lock,
    so that a setting chooses whether threads decode at once."""
    from advancedliteratemachinery_tpu_torch.pipelines.document import (
        GeneralTextReading)
    from advancedliteratemachinery_tpu_torch.pipelines.modules import (
        TextDetection)
    sub = Namespace(model="mgp_str", variant="base", device="cuda",
                    torch_ckpt=None, batch_max_length=25, det_thresh=0.3)
    pipe = GeneralTextReading(TextDetection(cli._db_detect_fn(sub)),
                              cli._recognition(sub, cli._rec_engine(sub)))

    def model_fn(image_path, question):
        out = pipe(cli._load_image(image_path))
        return "\n".join(inst.get("text", "")
                          for inst in out.get("instances", []))
    return model_fn


def run_setting(collect, index, base, out, model_fn, clock, workers):
    clock.reset()
    sampler = Sampler()
    if workers == 1:
        sampler.skip = set()
    sampler.start()
    r0, t0 = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
    stats = collect(index, base_dir=base, output_dir=out, model_fn=model_fn,
                    model_name="p", workers=workers, resume=False)
    seconds = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    sampler.stop.set()
    sampler.join()
    usage = {"user_s": r1.ru_utime - r0.ru_utime,
             "system_s": r1.ru_stime - r0.ru_stime,
             "voluntary_switches": r1.ru_nvcsw - r0.ru_nvcsw,
             "involuntary_switches": r1.ru_nivcsw - r0.ru_nivcsw}
    return stats, seconds, usage, sampler


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("collect_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from advancedliteratemachinery_tpu_torch import cli
    from advancedliteratemachinery_tpu_torch.eval.ccocr_harness import (
        collect_predictions)
    from advancedliteratemachinery_tpu_torch.ops import _kernels
    from advancedliteratemachinery_tpu_torch.pipelines import (
        file_loading, modules)
    _kernels.build()

    clock = StageClock()
    saved = (file_loading.load_image, modules.TextDetection.__call__,
             modules.TextRecognition.__call__)
    decode_lock = [None]
    file_loading.load_image = clock.wrap("decode", saved[0], decode_lock)
    modules.TextDetection.__call__ = clock.wrap("detection", saved[1])
    modules.TextRecognition.__call__ = clock.wrap("recognition", saved[2])
    default_switch, default_threads = sys.getswitchinterval(), \
        torch.get_num_threads()
    rows, first = [], None
    try:
        with tempfile.TemporaryDirectory() as tmp, cs.PatchedCLI():
            pages = cs.ccocr_pages("doc") + cs.ccocr_pages("table")
            index_path = cs.ccocr_tree(tmp, "pages", "multi_scene_ocr", pages)
            with open(index_path) as f:
                index = json.load(f)
            base = os.path.dirname(os.path.dirname(index_path))
            model_fn = pipeline_model_fn(cli)
            run_setting(collect_predictions, index, base,
                        os.path.join(tmp, "warm"), model_fn, clock, 1)
            for name, workers, switch, threads, locked in SETTINGS:
                decode_lock[0] = threading.Lock() if locked else None
                sys.setswitchinterval(switch or default_switch)
                torch.set_num_threads(threads or default_threads)
                out = os.path.join(tmp, name)
                stats, seconds, usage, sampler = run_setting(
                    collect_predictions, index, base, out, model_fn, clock,
                    workers)
                sys.setswitchinterval(default_switch)
                torch.set_num_threads(default_threads)
                resp = cs.ccocr_responses(os.path.join(out, "p", "pages"))
                first = resp if first is None else first
                row = {"setting": name, "workers": workers,
                       "switch_interval_s": switch or default_switch,
                       "torch_threads": threads or default_threads,
                       "decode_locked": locked,
                       "pages": stats["pages"]["ok"],
                       "pages_per_s": stats["pages"]["ok"] / seconds,
                       "collect_s": seconds, "process": usage,
                       "stage_wall_s": dict(clock.wall),
                       "stage_thread_cpu_s": dict(clock.cpu),
                       "equal_to_first": resp == first,
                       "samples": sampler.samples,
                       "top_frames": sampler.inner.most_common(12),
                       "top_port_frames": sampler.port.most_common(12)}
                print(json.dumps(row), flush=True)
                rows.append(row)
                if not (row["equal_to_first"] and stats["pages"]["ok"]
                        == stats["pages"]["total"] == len(pages)):
                    print(f"collect_profile: {name} lost or changed pages",
                          file=sys.stderr)
                    return 1
    finally:
        (file_loading.load_image, modules.TextDetection.__call__,
         modules.TextRecognition.__call__) = saved
    summary = {"card": card, "torch_threads_default": default_threads,
               "cpu_count": os.cpu_count(),
               "pages_per_s": {r["setting"]: r["pages_per_s"] for r in rows},
               "process": {r["setting"]: r["process"] for r in rows},
               "stage_wall_s_per_page": {
                   r["setting"]: {s: r["stage_wall_s"][s] / r["pages"]
                                  for s in STAGES} for r in rows},
               "stage_thread_cpu_s_per_page": {
                   r["setting"]: {s: r["stage_thread_cpu_s"][s] / r["pages"]
                                  for s in STAGES} for r in rows}}
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
