"""The port's train engine (engine/train.py, models' train-mode layers)
against the JAX package's at a small size: a depth-2, width-128 MGP-STR
(2 heads of 64) with BPE/WordPiece vocabs of 300/200 padded to 384/256,
the same weights carried across by engine/convert."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from advancedliteratemachinery_tpu.core.precision import (
    DEFAULT_POLICY as J_DEFAULT, FP32_POLICY as J_FP32)
from advancedliteratemachinery_tpu.engine import train as jtrain
from advancedliteratemachinery_tpu.models.mgp_str import (
    MGPSTR as JMGPSTR, MGPSTRConfig as JConfig)
from advancedliteratemachinery_tpu.models.vit import ViTConfig as JViTConfig
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, FP32_POLICY)
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict, load_flax_params)
from advancedliteratemachinery_tpu_torch.engine.recipes import RECIPES
from advancedliteratemachinery_tpu_torch.engine.train import (
    clip_by_global_norm, cross_entropy_ignore_pad, make_optimizer,
    mgp_str_loss)
from advancedliteratemachinery_tpu_torch.models.layers import (
    DropPath, Dropout)
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.vit import ViTConfig
from test_torch_mgp_str import FAST_COMPILE, random_flax_tree

torch.set_num_threads(2)

VIT = dict(embed_dim=128, depth=2, num_heads=2)
VOCABS = dict(bpe_vocab_size=300, wp_vocab_size=200)   # padded 384, 256
B, T = 4, 27


@pytest.fixture(scope="module")
def flax_pair():
    jm = JMGPSTR(JConfig(vit=JViTConfig(**VIT), **VOCABS), policy=J_FP32)
    params = random_flax_tree(jm, jnp.zeros((1, 32, 128, 3)))["params"]
    return jm, params


def _port(params, policy=FP32_POLICY):
    tm = MGPSTR(MGPSTRConfig(vit=ViTConfig(**VIT), **VOCABS), policy=policy,
                device="cpu")
    return load_flax_params(tm, params)


def _batch(seed):
    """Normalised images and targets with pad (0) positions."""
    rng = np.random.default_rng(seed)
    ids = {k: rng.integers(1, n, (B, T)).astype(np.int32)
           for k, n in (("char_ids", 38), ("bpe_ids", 300), ("wp_ids", 200))}
    for v in ids.values():
        v[:, 12 + seed % 5:] = 0
    return {"images": rng.uniform(-1, 1, (B, 32, 128, 3)).astype(np.float32),
            **ids}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_loss_and_grads(jm, params, batch):
    def loss_fn(p):
        out = jm.apply({"params": p}, batch["images"])
        m = jtrain.mgp_str_loss(out, batch)
        return m["loss"], m
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   compiler_options=FAST_COMPILE)(params)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 384)).astype(np.float32)
    logits[..., 300:] += 4.0      # padded columns weigh in the softmax
    targets = rng.integers(0, 300, (3, 5)).astype(np.int32)
    targets[0] = 0
    want = jtrain.cross_entropy_ignore_pad(jnp.asarray(logits),
                                           jnp.asarray(targets))
    got = cross_entropy_ignore_pad(torch.from_numpy(logits),
                                   torch.from_numpy(targets))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    all_pad = cross_entropy_ignore_pad(torch.from_numpy(logits),
                                       torch.zeros(3, 5, dtype=torch.int32))
    assert all_pad.item() == 0.0


def test_mgp_str_loss_matches_jax():
    rng = np.random.default_rng(1)
    out = {k: rng.standard_normal((B, T, n)).astype(np.float32)
           for k, n in (("char", 38), ("bpe", 384), ("wp", 256))}
    batch = _batch(1)
    want = jtrain.mgp_str_loss({k: jnp.asarray(v) for k, v in out.items()},
                               {k: jnp.asarray(v) for k, v in batch.items()})
    got = mgp_str_loss({k: torch.from_numpy(v) for k, v in out.items()},
                       _torch_batch(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 7])
def test_schedule_matches_optax(warmup):
    total, lr = 40, 3e-4
    tx = make_optimizer(lr=lr, total_steps=total, warmup_steps=warmup)
    sched = (optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)
             if warmup else optax.cosine_decay_schedule(lr, total))
    for count in range(total + 5):
        # optax computes in f32 (cos near pi/2 and the product round)
        np.testing.assert_allclose(tx.schedule(count), float(sched(count)),
                                   rtol=1e-5, atol=lr * 1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_matches_optax(max_norm):
    """Below the norm the gradients are scaled to it; above, untouched."""
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (7,), (2, 2, 5))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(norm.item(), np.sqrt(sum(
        (g.astype(np.float64) ** 2).sum() for g in grads)), rtol=1e-6)
    for g, w, orig in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
        if max_norm > norm.item():
            assert np.array_equal(g.numpy(), orig)


def _count_nodes(fn, name):
    seen, stack, n = set(), [fn], 0
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        n += type(f).__name__ == name
        stack.extend(nf for nf, _ in f.next_functions)
    return n


def test_one_step_loss_and_gradients_fp32(flax_pair):
    jm, params = flax_pair
    batch = _batch(3)
    (jloss, _), jgrads = _jax_loss_and_grads(jm, params, batch)
    tm = _port(params)
    tb = _torch_batch(batch)
    loss_fn, tx = RECIPES["mgp_str"](tm)
    assert tx == make_optimizer(lr=1e-4, total_steps=2_000_000,
                                grad_clip=5.0)     # the JAX recipe's
    loss, _ = loss_fn(tb, None)
    # on the CPU every encoder layer's attention takes the plain einsum
    # path, as the JAX module's does (its fused-qkv check fails there), so
    # the kernels' autograd Function is nowhere in the graph
    assert _count_nodes(loss.grad_fn, "FusedQKVAttentionBackward") == 0
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = flax_state_dict(tm, jax.tree.map(np.asarray, jgrads))
    for name, p in tm.named_parameters():
        assert p.grad is not None, name          # no gradient was cut
        w = want[name].numpy()
        # f32 on both sides, summed in other orders
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_bf16_step_close_to_jax(flax_pair):
    """bf16 compute on both sides (f32 parameters): both take the einsum
    attention on the CPU, and bf16 sums run in other orders."""
    jm32, params = flax_pair
    jm = JMGPSTR(jm32.config, policy=J_DEFAULT)
    batch = _batch(4)
    (jloss, _), jgrads = _jax_loss_and_grads(jm, params, batch)
    tm = _port(params, DEFAULT_POLICY)
    tb = _torch_batch(batch)
    loss = mgp_str_loss(tm(tb["images"]), tb)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    want = flax_state_dict(tm, jax.tree.map(np.asarray, jgrads))
    num = sum(((p.grad - want[n]) ** 2).sum() for n, p in
              tm.named_parameters())
    den = sum((want[n] ** 2).sum() for n, _ in tm.named_parameters())
    assert (num / den).sqrt().item() <= 5e-2


def test_dropout_and_droppath():
    x = torch.ones(64, 3, 5)
    gen = torch.Generator().manual_seed(0)
    for layer in (Dropout(0.25), DropPath(0.25)):
        layer.eval()
        assert layer(x, gen) is x                 # eval mode: identity
        layer.train()
        assert type(layer)(0.0).train()(x) is x   # rate 0: identity
        with pytest.raises(ValueError):           # no generator to draw from
            layer(x)
        y = layer(x, torch.Generator().manual_seed(1))
        assert torch.equal(y, layer(x, torch.Generator().manual_seed(1)))
        assert set(y.unique().tolist()) <= {0.0, torch.tensor(1 / 0.75).item()}
        assert 0.6 < (y > 0).float().mean().item() < 0.9
    y = DropPath(0.5).train()(x, gen)
    per_sample = y.reshape(64, -1)
    assert (per_sample == per_sample[:, :1]).all()   # whole samples dropped
    assert set(per_sample[:, 0].tolist()) == {0.0, 2.0}
    y = Dropout(0.5).train()(x, gen)
    assert not (y.reshape(64, -1) == y.reshape(64, -1)[:, :1]).all()
