"""MGP-STR port (models/layers, vit, mgp_str, engine/infer, engine/convert)
against the JAX package at a small size: a depth-2, width-192 ViT with small
BPE/WordPiece vocabs, the same weights carried across by engine/convert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu.core.precision import (
    DEFAULT_POLICY as J_DEFAULT, FP32_POLICY as J_FP32)
from advancedliteratemachinery_tpu.engine.infer import (
    MGPSTRInference as JInference)
from advancedliteratemachinery_tpu.models.mgp_str import (
    MGPSTR as JMGPSTR, MGPSTRConfig as JConfig)
from advancedliteratemachinery_tpu.models.vit import (
    ViTConfig as JViTConfig, VisionTransformer as JViT)
from advancedliteratemachinery_tpu_torch.codecs.char_codec import (
    CharCodec as TCharCodec)
from advancedliteratemachinery_tpu_torch.core.precision import (
    DEFAULT_POLICY, FP32_POLICY)
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict, load_flax_params)
from advancedliteratemachinery_tpu_torch.engine.infer import MGPSTRInference
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.vit import (
    ViTConfig, VisionTransformer)

torch.set_num_threads(2)
# how the port's tests compile the JAX reference they hold the port to:
# without LLVM's backend optimizations, so that it compiles in a fraction
# of the time and its arithmetic is the op-by-op arithmetic (no
# multiply-adds contracted into FMAs)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def fast_jit(fn, *args, **static):
    """The JAX package's `jax.jit` function `fn` lowered for `args` (and
    its static arguments `static`) and compiled with FAST_COMPILE → the
    compiled function, called with `args` alone."""
    return fn.lower(*args, **static).compile(FAST_COMPILE)


def fast_engine(engine, weights, images):
    """A JAX inference engine whose jitted `_run(weights, images_u8)` is
    compiled with FAST_COMPILE for `images`' shape."""
    engine._run = fast_jit(engine._run, weights, jnp.asarray(images))
    return engine


VIT = dict(embed_dim=192, depth=2, num_heads=3)
VOCABS = dict(bpe_vocab_size=1000, wp_vocab_size=1100)   # padded 1024, 1152


def flax_zeros(module: torch.nn.Module) -> dict:
    """The flax variables (`params`, and `batch_stats` where there is
    BatchNorm) of the JAX twin of the port's `module`, as zeros: each
    parameter under its flax path, by the inverse of engine/convert.py
    (conv OIHW → kernel HWIO, Linear weight → kernel [in, out], Embedding
    weight → embedding, a norm's weight → scale, BatchNorm running
    stats → mean, var). The port's submodules carry the flax names;
    flax's `apply` refuses a tree that lacks one of its model's
    parameters or gives one another shape, and the outputs' parity shows
    the port reads no other. So this stands in for tracing
    `jax.eval_shape(model.init)`, which takes seconds on the CPU; the
    tree, and so a seeded fill, is the same."""
    tree: dict = {}
    params = dict(module.named_parameters())
    for key, v in module.state_dict().items():
        path, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        mod = module.get_submodule(path)
        shape, coll = tuple(v.shape), "params"
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            if leaf == "num_batches_tracked":
                continue
            coll, leaf = {"weight": ("params", "scale"),
                          "bias": ("params", "bias"),
                          "running_mean": ("batch_stats", "mean"),
                          "running_var": ("batch_stats", "var")}[leaf]
        elif key not in params:
            continue                    # a buffer with no flax twin
        elif leaf == "weight" and len(shape) == 4:
            leaf, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
        elif isinstance(mod, torch.nn.Embedding):
            leaf = "embedding"
        elif leaf == "weight" and isinstance(mod, torch.nn.Linear):
            leaf, shape = "kernel", shape[::-1]
        elif leaf == "weight" and isinstance(mod, (
                torch.nn.LayerNorm, torch.nn.GroupNorm)):
            leaf = "scale"
        node = tree.setdefault(coll, {})
        for part in path.split(".") if path else ():
            node = node.setdefault(part, {})
        node[leaf] = np.zeros(shape, np.float32)
    return tree


def random_flax_tree(model, *example_args, seed=0, like=None):
    """A flax variable tree for `model` filled from a numpy seed, without
    running its (slow, on the CPU) init: kernels N(0, 1/fan_in), biases and
    BatchNorm means N(0, 0.1-0.3), norm scales near 1, BatchNorm variances
    in [0.5, 2], embeddings N(0, 0.02). With `like` (the port's twin of
    `model`) the tree's shapes come from it (`flax_zeros`) instead of from
    tracing `model.init`."""
    shapes = (flax_zeros(like) if like is not None else jax.eval_shape(
        model.init, jax.random.PRNGKey(0), *example_args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        elif name == "var":
            n = rng.uniform(0.5, 2.0, s.shape)
        elif name in ("bias", "mean"):
            n = (0.1 if name == "bias" else 0.3) * n
        else:                                     # cls_token, pos_embed
            n = 0.02 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 128, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, port model) sharing one set of weights. The head
    biases favour each head's EOS id so that confidences are non-zero."""
    jm = JMGPSTR(JConfig(vit=JViTConfig(**VIT), **VOCABS), policy=J_FP32)
    tm = MGPSTR(MGPSTRConfig(vit=ViTConfig(**VIT), **VOCABS),
                policy=FP32_POLICY, device="cpu")
    params = random_flax_tree(jm, like=tm)["params"]
    for head, eos in (("char", 1), ("bpe", 2), ("wp", 102)):
        params[f"{head}_head"]["bias"][eos] += 3.0
    load_flax_params(tm, params)
    return jm, params, tm


def test_logits_and_decode_tokens_match(pair):
    jm, params, tm = pair
    x = np.random.default_rng(1).uniform(-1, 1, (3, 32, 128, 3)).astype(
        np.float32)
    apply = jax.jit(jm.apply, static_argnames="decode_tokens",
                    compiler_options=FAST_COMPILE)
    want = apply({"params": params}, jnp.asarray(x))
    want_tok = apply({"params": params}, jnp.asarray(x), decode_tokens=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        got_tok = tm(torch.from_numpy(x), decode_tokens=True)
    for head, width in (("char", 38), ("bpe", 1024), ("wp", 1152)):
        assert got[head].shape == (3, 27, width)
        # f32 on both sides; 1e-4 covers summation-order differences
        np.testing.assert_allclose(got[head].numpy(), np.asarray(want[head]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got_tok[head].numpy(),
                                   np.asarray(want_tok[head]),
                                   rtol=1e-4, atol=1e-4)


def test_inference_engine_matches(pair):
    jm, params, tm = pair
    images = _images(6)
    jeng = JInference(jm, params, CharCodec(), input_dtype=jnp.float32,
                      fused_decode="never")
    want = fast_engine(jeng, jeng.params, images)(images)
    engine = MGPSTRInference(tm, TCharCodec(), input_dtype=torch.float32,
                             device="cpu")
    got = engine(images)
    assert set(got) == set(want)
    for head in ("char", "bpe", "wp"):
        np.testing.assert_array_equal(got[f"{head}_ids"],
                                      np.asarray(want[f"{head}_ids"]))
        np.testing.assert_allclose(got[f"{head}_conf"],
                                   np.asarray(want[f"{head}_conf"]),
                                   rtol=1e-4, atol=1e-6)
    assert (got["char_conf"] > 0).any()   # the EOS bias makes EOS appear
    texts = engine.recognize(images)
    assert [t[0] for t in texts] == [
        s.split("[s]")[0] for s in TCharCodec().decode(got["char_ids"])]


def test_bf16_encoder_features_close():
    """One bf16 check: the encoder in the default policy (bf16 compute,
    tanh GELU) on both sides. bf16 rounds at different places in the two
    frameworks, so the bound is relative: 3e-2 of the features' RMS."""
    jv = JViT(JViTConfig(**VIT), policy=J_DEFAULT)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 128, 3)).astype(
        np.float32)
    tv = VisionTransformer(ViTConfig(**VIT), policy=DEFAULT_POLICY)
    params = random_flax_tree(jv, seed=3, like=tv)["params"]
    want = np.asarray(jax.jit(jv.apply, compiler_options=FAST_COMPILE)(
        {"params": params}, jnp.asarray(x)), np.float32)
    load_flax_params(tv, params)
    with torch.no_grad():
        got = tv(torch.from_numpy(x)).float().numpy()
    err = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))
    assert err < 3e-2, err


def test_convert_rejects_mismatched_trees(pair):
    _, params, tm = pair
    bad = dict(params)
    bad["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        flax_state_dict(tm, bad)
    bad = {k: v for k, v in params.items() if k != "wp_head"}
    with pytest.raises(KeyError, match="missing"):
        flax_state_dict(tm, bad)
    bad = dict(params, char_head={"kernel": np.zeros((192, 40), np.float32),
                                  "bias": np.zeros((40,), np.float32)})
    with pytest.raises(ValueError, match="char_head.weight"):
        flax_state_dict(tm, bad)
