"""The port's training driver (engine/fit.py, engine/batches.py) on the CPU
with a small MGP-STR: checkpoint cadence and keep-last, exact resume, the
`best` slot and its `.old` fallback, the SIGTERM save-and-stop hook, the
train log, the profiler trace, the non-finite loss guard and the
prefetcher's error relay."""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu_torch.engine.batches import (
    mgp_str_recipe_u8, prefetch_batches)
from advancedliteratemachinery_tpu_torch.engine.fit import (
    FitConfig, TrainState, fit, latest_checkpoint_step, restore_train_state)
from advancedliteratemachinery_tpu_torch.engine.train import make_optimizer
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.vit import ViTConfig

torch.set_num_threads(2)

# dropout and stochastic depth on, so that resume must reseed them
CFG = MGPSTRConfig(vit=ViTConfig(embed_dim=128, depth=2, num_heads=2,
                                 dropout=0.1, drop_path=0.1),
                   bpe_vocab_size=300, wp_vocab_size=200)
TX = make_optimizer(lr=1e-3, total_steps=20, grad_clip=1.0)


def _model():
    return MGPSTR(CFG, device="cpu", seed=0)


def _batches(n=None):
    """The same uint8 batch over and over (n times, or for ever)."""
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (2, 32, 128, 3), dtype=np.uint8),
             "char_ids": rng.integers(1, 38, (2, 27)).astype(np.int32),
             "bpe_ids": rng.integers(1, 300, (2, 27)).astype(np.int32),
             "wp_ids": rng.integers(1, 200, (2, 27)).astype(np.int32)}
    i = 0
    while n is None or i < n:
        yield batch
        i += 1


def _fit(model, cfg, **kw):
    loss_fn, _ = mgp_str_recipe_u8(model)
    return fit(loss_fn, TX, model, _batches(), cfg, log_fn=lambda m: None,
               device="cpu", **kw)


def _steps(d):
    return sorted(n for n in os.listdir(d) if n.startswith("step_"))


def test_save_interval_keep_last_and_log(tmp_path):
    d = str(tmp_path / "run")
    res = _fit(_model(), FitConfig(total_steps=5, log_interval=2,
                                   save_interval=2, keep_last=2, ckpt_dir=d))
    assert res.steps_run == 5 and res.state.step == 5
    assert _steps(d) == ["step_4", "step_5"]      # 2 collected, 5 final
    assert latest_checkpoint_step(d) == 5
    log = open(os.path.join(d, "log_train.txt")).read()
    assert "[fit] step 2/5" in log and "[fit] step 5/5" in log
    assert np.isfinite(res.last_metrics["loss"])


def test_resume_repeats_uninterrupted_run(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _fit(_model(), FitConfig(total_steps=4, save_interval=2, ckpt_dir=a))
    resumed = _fit(_model(), FitConfig(total_steps=6, save_interval=2,
                                       ckpt_dir=a, resume=True))
    assert resumed.steps_run == 2
    straight = _fit(_model(), FitConfig(total_steps=6, ckpt_dir=b))
    got, want = resumed.state, straight.state
    assert got.step == want.step == 6
    for (n, p), q in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(p, q), n
    for s, t in zip(got.optimizer.state.values(),
                    want.optimizer.state.values()):
        assert torch.equal(s["exp_avg_sq"], t["exp_avg_sq"])


def test_best_slot_and_old_fallback(tmp_path):
    d = str(tmp_path / "run")
    scores = iter([0.1, 0.5, 0.3])
    res = _fit(_model(), FitConfig(total_steps=3, val_interval=1,
                                   ckpt_dir=d),
               eval_fn=lambda state: {"accuracy": next(scores)})
    assert res.best_metric == 0.5
    assert [h["step"] for h in res.history] == [1.0, 2.0, 3.0]
    assert sorted(os.listdir(d)) == ["best", "log_train.txt", "step_3"]
    state = TrainState.create(_model(), TX)
    assert restore_train_state(os.path.join(d, "best"), state).step == 2
    # a save interrupted between its two renames leaves only best.old
    os.rename(os.path.join(d, "best"), os.path.join(d, "best.old"))
    state = TrainState.create(_model(), TX)
    assert restore_train_state(os.path.join(d, "best"), state).step == 2


def test_sigterm_saves_and_stops(tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers need the main thread")
    d = str(tmp_path / "run")

    def batches():
        for i, b in enumerate(_batches()):
            if i == 1:                      # delivered during step 2
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    model = _model()
    loss_fn, _ = mgp_str_recipe_u8(model)
    res = fit(loss_fn, TX, model, batches(),
              FitConfig(total_steps=10, ckpt_dir=d, prefetch=0),
              log_fn=lambda m: None, device="cpu")
    assert res.steps_run == 2 and _steps(d) == ["step_2"]
    assert "SIGTERM: saved step_2" in open(
        os.path.join(d, "log_train.txt")).read()


def test_profile_trace_written(tmp_path):
    p = str(tmp_path / "prof")
    _fit(_model(), FitConfig(total_steps=3, profile_dir=p, profile_steps=1))
    assert os.path.getsize(os.path.join(p, "trace.json")) > 0


def test_non_finite_loss_stops(tmp_path):
    model = _model()
    loss_fn, _ = mgp_str_recipe_u8(model)

    def nan_loss(batch, generator):
        loss, m = loss_fn(batch, generator)
        return loss * float("nan"), {**m, "loss": loss * float("nan")}

    with pytest.raises(FloatingPointError):
        fit(nan_loss, TX, model, _batches(), FitConfig(total_steps=2),
            log_fn=lambda m: None, device="cpu")


def test_prefetch_reraises_source_error():
    def source():
        yield from _batches(1)
        raise RuntimeError("reader failed")

    it = prefetch_batches(source(), 2, "cpu")
    first = next(it)
    assert first["images"].dtype == torch.uint8
    with pytest.raises(RuntimeError, match="reader failed"):
        next(it)
