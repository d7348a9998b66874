"""The port's `utils/profiling.py` and `core/registry.py` with the CLI's
`models [--cost]`, on the CPU: the registries hold the port's components
under the JAX package's names (a subset of them; the families not ported
yet are named here; the JAX modules the JAX command's imports leave out
are imported), `flops_estimate` counts 2 x the multiply-adds of the
matmuls and convolutions that MGP-STR's config implies (the JAX function
reads XLA's cost analysis, which also counts elementwise work), `models
--cost` prints them in the JAX format, `StepTimer` times and summarises
as the JAX one, and `trace` writes a Chrome trace."""

import json

import pytest
import torch

from advancedliteratemachinery_tpu import cli as jcli
# every JAX module that registers a component, whatever else the process
# has imported: the JAX `models` command lists what is imported
from advancedliteratemachinery_tpu.codecs import seq_codec  # noqa: F401
from advancedliteratemachinery_tpu.models import gem, lvtr  # noqa: F401
from advancedliteratemachinery_tpu.core import registry as jregistry
from advancedliteratemachinery_tpu.utils import profiling as jprofiling
from advancedliteratemachinery_tpu_torch import cli
from advancedliteratemachinery_tpu_torch.core import registry
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.vit import (
    VIT_VARIANTS, ViTConfig)
from advancedliteratemachinery_tpu_torch.utils import profiling

torch.set_num_threads(2)

# the JAX package's registered models the port has not ported yet
UNPORTED_MODELS = {"fid_web", "gem", "geolayoutlm", "lvtr",
                   "lvtr_dalle_unet", "trcg", "vgt", "vlpt_std", "webrpg"}


def registered(capsys, main):
    capsys.readouterr()
    assert main(["models"]) == 0
    lines = capsys.readouterr().out.splitlines()
    return {line.split(":")[0]: set(line.split(":", 1)[1].strip()
                                    .split(", ")) for line in lines}


def test_registries_hold_the_ported_components_under_jax_names(capsys):
    got = registered(capsys, cli.main)
    want = registered(capsys, jcli.main)
    assert got.keys() == want.keys() == {"models", "codecs", "modules"}
    assert got["models"] | UNPORTED_MODELS == want["models"]
    assert not got["models"] & UNPORTED_MODELS
    assert got["codecs"] == want["codecs"]
    assert got["modules"] == want["modules"]
    assert got["models"] == set(registry.MODELS)
    assert registry.MODELS.get("omniparser").__module__.startswith(
        "advancedliteratemachinery_tpu_torch")
    with pytest.raises(KeyError, match="already registered"):
        registry.MODELS.register("lister")(object)
    with pytest.raises(KeyError, match="unknown model 'vgt'"):
        registry.MODELS.get("vgt")
    assert set(jregistry.MODELS) >= set(registry.MODELS)


def mgp_str_macs(cfg: MGPSTRConfig) -> int:
    """Multiply-adds of MGP-STR's matmuls and convolutions at B=1 on a
    32x128 crop, from its config: patch embedding; per block qkv, QKᵀ, AV,
    the projection and the MLP; per head the TokenLearner's grouped
    pointwise pair (8 groups), selection, token pooling and the vocabulary
    head."""
    v = cfg.vit_config()
    D, S, N, P = v.embed_dim, v.seq_len, v.num_patches, v.patch_size
    T, G = cfg.max_tokens, 8
    block = (S * D * 3 * D + 2 * S * S * D + S * D * D
             + 2 * S * D * int(v.mlp_ratio * D))
    heads = sum(2 * S * D * (D // G) + S * D * T + T * S * D + T * D * V
                for V in cfg.head_sizes().values())
    return N * D * P * P * v.in_chans + v.depth * block + heads


def test_flops_estimate_is_twice_the_configs_multiply_adds():
    cfg = MGPSTRConfig(vit=ViTConfig(embed_dim=64, depth=2, num_heads=2),
                       bpe_vocab_size=300, wp_vocab_size=200)
    model = MGPSTR(cfg, policy=FP32_POLICY, device="cpu")
    x = torch.zeros((1, 32, 128, 3))
    assert profiling.flops_estimate(model, x) == 2 * mgp_str_macs(cfg)
    assert profiling.flops_estimate(lambda a: a + 1, x) is None


def test_models_cost_prints_the_jax_line(capsys):
    capsys.readouterr()
    assert cli.main(["models", "--cost", "mgp_str", "--variant", "tiny",
                     "--device", "cpu"]) == 0
    line = capsys.readouterr().out.splitlines()[-1]
    cfg = MGPSTRConfig(variant="tiny")
    n = sum(p.numel() for p in MGPSTR(cfg, device="cpu").parameters())
    assert line == (f"cost[mgp_str-tiny]: params={n / 1e6:.2f}M  "
                    f"fwd={2 * mgp_str_macs(cfg) / 1e9:.2f} GFLOPs "
                    f"(B=1 32x128)")
    assert VIT_VARIANTS["tiny"].embed_dim == 192
    assert cli.main(["models", "--cost", "abinet", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == (
        "cost: unsupported model 'abinet' (mgp_str, lister)")


def test_step_timer_matches_jax(monkeypatch):
    summaries = []
    for mod, sync in ((profiling, torch.ones(2)), (jprofiling, None)):
        ticks = iter([0.0, 0.25, 1.0, 1.5])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.StepTimer()
        t.start("a")
        assert t.stop("a", *[sync][:sync is not None]) == 0.25
        with t.stage("b", sync_on=sync):
            pass
        summaries.append((t.summary(), t.report()))
    assert summaries[0] == summaries[1]
    assert summaries[0][0] == {"a": 0.25, "b": 0.5}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
