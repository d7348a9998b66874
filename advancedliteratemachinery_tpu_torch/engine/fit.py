"""End-to-end training driver: batches → train step → eval cadence →
checkpoints (port of `advancedliteratemachinery_tpu/engine/fit.py`, single
process and single device).

One `fit()` composes a recipe's `(loss_fn, tx)` with a model, a batch
iterator, periodic evaluation and save/best/resume, as the reference wires
by hand in every project (MGP-STR train_final_dist.py:31-238: the iteration
loop, valInterval validation with best-accuracy tracking, periodic
checkpoints, a plain-text `log_train.txt`).

The checkpoint format is the port's own and is not compatible with the JAX
package's Orbax checkpoints: each checkpoint is a directory holding one
`torch.save` file of the step, the model's state dict and the optimiser's
state dict. A directory is written under a temporary sibling name and
renamed into place, so a kill mid-write never leaves a half-written
`step_N`; named slots (`best`) go through `{name}.new` → `{name}.old` so
that the previous slot survives until its replacement is in place.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import signal
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from advancedliteratemachinery_tpu_torch.core.device import resolve_device
from advancedliteratemachinery_tpu_torch.engine.batches import (
    prefetch_batches, to_device)
from advancedliteratemachinery_tpu_torch.engine.train import (
    OptimizerConfig, TrainState, make_train_step)
from advancedliteratemachinery_tpu_torch.utils.metrics import (
    MetricLogger, nan_guard)

_STEP_DIR = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"


@dataclasses.dataclass
class FitConfig:
    total_steps: int = 10_000
    log_interval: int = 100
    val_interval: int = 0          # 0 = never (reference valInterval)
    save_interval: int = 0         # 0 = final only (reference saves every 5e3)
    ckpt_dir: Optional[str] = None
    resume: bool = False
    seed: int = 0
    best_key: str = "accuracy"     # metric maximized for the `best` ckpt
    profile_dir: Optional[str] = None  # torch.profiler trace output
    profile_steps: int = 5         # steps traced (after a warm-up step)
    prefetch: int = 2              # batches kept ahead on a loader thread
    #                                (0 = fetch inline)
    keep_last: int = 3             # step_N checkpoints retained (0 = all)
    handle_sigterm: bool = True    # preemption: save + stop on SIGTERM


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: List[Dict[str, float]]  # one entry per validation
    best_metric: Optional[float]
    steps_run: int
    last_metrics: Optional[Dict[str, float]] = None  # last logged step


# ---------------- checkpoint layout ----------------


def latest_checkpoint_step(ckpt_dir: Optional[str]) -> Optional[int]:
    """Newest `step_N` under ckpt_dir, or None."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_DIR.match(d))]
    return max(steps) if steps else None


def save_train_state(ckpt_dir: str, state: TrainState, step: int,
                     name: Optional[str] = None) -> str:
    """Save to `{ckpt_dir}/step_{step}` (or `{ckpt_dir}/{name}`) and return
    the path. The payload goes into a `*.tmp-<pid>` sibling first and is
    renamed into place; a named slot is committed to `{name}.new`, the
    previous slot moved to `{name}.old`, the new one renamed in, and only
    then the old one deleted (`restore_train_state` falls back to
    `{name}.old` for the window between the two renames)."""
    path = os.path.abspath(os.path.join(ckpt_dir, name or f"step_{step}"))
    target = path if name is None else f"{path}.new"
    tmp = f"{target}.tmp-{os.getpid()}"
    for stale in (tmp, target):        # left by a crashed save
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)
    torch.save({"step": state.step, "params": state.model.state_dict(),
                "opt_state": state.optimizer.state_dict()},
               os.path.join(tmp, STATE_FILE))
    os.rename(tmp, target)
    if name is not None:
        old = f"{path}.old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(target, path)
        if os.path.exists(old):
            shutil.rmtree(old)
    return path


def gc_checkpoints(ckpt_dir: Optional[str], keep_last: int) -> None:
    """Delete all but the newest `keep_last` step_N checkpoints. Named slots
    (best/...) are untouched; keep_last <= 0 keeps everything."""
    if keep_last <= 0 or not ckpt_dir or not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := _STEP_DIR.match(d)))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint written by `save_train_state` into `state` (its
    model and optimiser, in place) and return it. Falls back to
    `{path}.old` when `path` is missing (the rename window of a named-slot
    save interrupted between its two renames)."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(f"{path}.old"):
        path = f"{path}.old"
    # onto the host: load_state_dict copies each tensor to its parameter's
    # device and leaves Adam's step counts on the host, as a fresh optimiser
    # keeps them
    got = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                     weights_only=True)
    state.model.load_state_dict(got["params"])
    state.optimizer.load_state_dict(got["opt_state"])
    state.step = int(got["step"])
    return state


# ---------------- the driver ----------------


def fit(loss_fn: Callable, tx: OptimizerConfig, model: nn.Module,
        batches: Iterator[Dict[str, np.ndarray]], cfg: FitConfig, *,
        eval_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None,
        log_fn: Callable[[str], None] = print,
        device: Union[str, torch.device, None] = None) -> FitResult:
    """Run the training loop on `device` (the GPU unless `device="cpu"`),
    where `model` must already live.

    loss_fn/tx: a recipe pair (engine.recipes, engine.batches) built on
    `model`. batches: an iterator of host numpy batch dicts. eval_fn(state)
    -> metrics dict; called every cfg.val_interval steps and once at the
    end; its cfg.best_key entry drives the `best` checkpoint. Dropout draws
    from a generator seeded from (cfg.seed, step), so a resumed run repeats
    an uninterrupted one."""
    device = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != device.type or device.index not in (None, where.index):
        raise ValueError(f"model lives on {where}, not {device}")
    state = TrainState.create(model, tx)
    step_fn = make_train_step(loss_fn, state)

    start_step = 0
    if cfg.resume and cfg.ckpt_dir:
        latest = latest_checkpoint_step(cfg.ckpt_dir)
        if latest is not None:
            restore_train_state(os.path.join(cfg.ckpt_dir, f"step_{latest}"),
                                state)
            start_step = state.step
            log_fn(f"[fit] resumed from step_{latest} (step={start_step})")

    if cfg.prefetch:
        batches = prefetch_batches(batches, cfg.prefetch, device)
    else:
        batches = (to_device(b, device) for b in batches)

    log_file = None
    if cfg.ckpt_dir:
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
        log_file = open(os.path.join(cfg.ckpt_dir, "log_train.txt"), "a")

    def _log(msg: str) -> None:
        log_fn(msg)
        if log_file:
            log_file.write(msg + "\n")
            log_file.flush()

    # Preemption hook: SIGTERM requests a final checkpoint at the next step
    # boundary instead of dying mid-save.
    preempted = {"flag": False}
    prev_sigterm = None
    if cfg.handle_sigterm and cfg.ckpt_dir:

        def _on_sigterm(signum, frame):
            preempted["flag"] = True

        try:
            prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not the main thread (e.g. test harness)
            prev_sigterm = None

    logger = MetricLogger(print_fn=_log)
    history: List[Dict[str, float]] = []
    best: Optional[float] = None
    generator = torch.Generator(device=device)

    def _run_eval(step_no: int) -> None:
        nonlocal best
        if eval_fn is None:
            return
        metrics = eval_fn(state)
        history.append({"step": float(step_no), **metrics})
        _log(f"[fit] step {step_no} val: " + "  ".join(
            f"{k}={v:.4f}" for k, v in metrics.items()))
        score = metrics.get(cfg.best_key)
        if (score is not None and (best is None or score > best)
                and cfg.ckpt_dir):
            best = score
            save_train_state(cfg.ckpt_dir, state, step_no, name="best")
            _log(f"[fit] step {step_no}: new best {cfg.best_key}={score:.4f}")

    def _sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.time()
    step_no = start_step
    last_metrics: Optional[Dict[str, float]] = None
    prof: Any = None
    try:
        for step_no in range(start_step + 1, cfg.total_steps + 1):
            if cfg.profile_dir and step_no == start_step + 2:
                # skip the first (warm-up) step, then trace profile_steps
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.start()
                _log(f"[fit] tracing steps {step_no}.."
                     f"{step_no + cfg.profile_steps - 1} → "
                     f"{cfg.profile_dir}")
            batch = next(batches)
            generator.manual_seed(cfg.seed * 2 ** 32 + step_no)
            metrics = step_fn(batch, generator)
            if prof is not None and (
                    step_no >= start_step + 1 + cfg.profile_steps):
                _sync()
                prof.stop()
                os.makedirs(cfg.profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(cfg.profile_dir, "trace.json"))
                prof = None

            if step_no % cfg.log_interval == 0 or step_no == cfg.total_steps:
                host = {k: float(v) for k, v in metrics.items()}
                last_metrics = host
                nan_guard(host.get("loss", 0.0), step_no)
                logger.update(**host)
                _log(f"[fit] step {step_no}/{cfg.total_steps} "
                     f"({time.time() - t0:.1f}s)  {logger}")
            if cfg.val_interval and step_no % cfg.val_interval == 0:
                _run_eval(step_no)
            if (cfg.save_interval and cfg.ckpt_dir
                    and step_no % cfg.save_interval == 0):
                save_train_state(cfg.ckpt_dir, state, step_no)
                gc_checkpoints(cfg.ckpt_dir, cfg.keep_last)
            if preempted["flag"]:
                save_train_state(cfg.ckpt_dir, state, step_no)
                _log(f"[fit] SIGTERM: saved step_{step_no}, stopping")
                break

        if not preempted["flag"]:
            if cfg.val_interval == 0 or step_no % cfg.val_interval != 0:
                _run_eval(step_no)
            if cfg.ckpt_dir and (cfg.save_interval == 0
                                 or step_no % cfg.save_interval != 0):
                save_train_state(cfg.ckpt_dir, state, step_no)
                gc_checkpoints(cfg.ckpt_dir, cfg.keep_last)
    finally:
        if prof is not None:
            prof.stop()
        if log_file:
            log_file.close()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)

    return FitResult(state=state, history=history, best_metric=best,
                     steps_run=step_no - start_step,
                     last_metrics=last_metrics)
