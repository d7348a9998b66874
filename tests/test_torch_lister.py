"""LISTER port (models/focalnet, models/lister, engine/infer
`LISTERInference`, engine/convert) against the JAX package on the CPU at a
tiny size (FocalNet embed 8, one block a stage; decoder width 64, 2 heads,
window 5, max_ch 6), with iters 0 and 1, the same numpy-seeded weights
carried across by engine/convert; float32 on both sides. The FocalNet
features come from the same compiled JAX run as LISTER's outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.engine.infer import (
    LISTERInference as JInference)
from advancedliteratemachinery_tpu.models import focalnet as jfocal
from advancedliteratemachinery_tpu.models import lister as jlister
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict, load_flax_params)
from advancedliteratemachinery_tpu_torch.engine.infer import LISTERInference
from advancedliteratemachinery_tpu_torch.models import lister
from advancedliteratemachinery_tpu_torch.models.focalnet import (
    FocalNet, FocalNetConfig, downsample_mask)
from test_torch_mgp_str import FAST_COMPILE

torch.set_num_threads(2)

FOCAL = dict(embed_dim=8, depths=(1, 1, 1, 1), layerscale_value=0.1)
LISTER_KW = dict(max_ch=6, nhead=2, window_size=5)
TOL = dict(rtol=1e-5, atol=1e-5)      # f32 on both sides, other sum orders


def configs(iters):
    jfocal.FOCALNET_VARIANTS.setdefault("torch_port_tiny",
                                        jfocal.FocalNetConfig(**FOCAL))
    j = jlister.LISTERConfig(variant="torch_port_tiny", iters=iters,
                             **LISTER_KW)
    t = lister.LISTERConfig(iters=iters, focalnet=FocalNetConfig(**FOCAL),
                            **LISTER_KW)
    return j, t


def random_params(shapes, seed):
    """Kernels N(0, 1/fan_in), biases N(0, 0.1²), norm scales near 1, the
    navigator N(0, 1/C), everything else (gammas, eos_emb, kv_pos_bias)
    N(0, 0.3²)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        elif name == "bias":
            n = 0.1 * n
        elif name == "weight":
            n = n / np.sqrt(s.shape[0])
        else:
            n = 0.3 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def jax_run():
    """One compiled JAX LISTER run with iters 1 on 3 crops of 32x64, the
    third with its right 24 columns padded out, with the encoder's
    features from the same run: its first decode is what the iters 0 model
    gives on the same encoder and decoder weights (the refinement only
    adds decodes), so both port models are held to this one run."""
    jcfg, _ = configs(1)
    jm = jlister.LISTER(jcfg, policy=J_FP32)
    x = np.random.default_rng(0).standard_normal((3, 32, 64, 3)).astype(
        np.float32)
    mask = np.ones((3, 32, 64), np.float32)
    mask[2, :, 40:] = 0.0
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask))
    params = random_params(shapes["params"], seed=2)
    want, state = jax.jit(lambda p, x, m: jm.apply(
        {"params": p}, x, m, capture_intermediates=lambda mod, n: (
            mod.name == "encoder" and n == "__call__")),
        compiler_options=FAST_COMPILE)(
        params, jnp.asarray(x), jnp.asarray(mask))
    want = jax.tree_util.tree_map(np.asarray, want)
    feats = jax.tree_util.tree_map(
        np.asarray, state["intermediates"]["encoder"]["__call__"][0])
    return params, want, feats, x, mask


def model_params(params, iters):
    """The flax tree of the iters-`iters` model: with iters 0 the decoder
    has no refinement modules."""
    if iters:
        return params
    dec = {k: v for k, v in params["decoder"].items()
           if k not in ("cntx_module", "merge_layer")}
    return {"encoder": params["encoder"], "decoder": dec}


def port_model(params, iters):
    tm = lister.LISTER(configs(iters)[1], policy=FP32_POLICY, device="cpu")
    return load_flax_params(tm, model_params(params, iters))


def test_focalnet_features_match(jax_run):
    params, _, (feat, fmask), x, mask = jax_run
    enc = FocalNet(FocalNetConfig(**FOCAL), policy=FP32_POLICY,
                   device="cpu")
    load_flax_params(enc, params["encoder"])
    with torch.no_grad():
        got, gmask = enc(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (3, 1, 16, 64)
    np.testing.assert_array_equal(gmask.numpy(), fmask)
    assert fmask[2].sum() < fmask[0].sum()      # padding reached the end
    np.testing.assert_allclose(got.numpy(), feat, **TOL)


@pytest.mark.parametrize("iters", [0, 1])
def test_lister_decodes_match(jax_run, iters):
    params, want, _, x, mask = jax_run
    tm = port_model(params, iters)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert len(got) == 1 + iters
    for g, w in zip(got, want):
        for key in ("logits", "char_feats", "char_maps", "nb_map"):
            assert g[key].shape == w[key].shape, key
            np.testing.assert_allclose(g[key].numpy(), w[key], **TOL,
                                       err_msg=key)
        np.testing.assert_array_equal(g["char_masks"].numpy(),
                                      w["char_masks"])
        # a lane that finished inside the walk: its later steps are masked
        assert (w["char_masks"][:, -1] == 0).any()
        assert (w["char_masks"][:, 0] == 1).all()


@pytest.mark.parametrize("iters", [0, 1])
def test_inference_engine_matches(jax_run, iters):
    """LISTERInference on uint8 crops: the same greedy ids as the JAX
    engine, confidences within 1e-5 (f32); strings through the port's
    EosSeqCodec."""
    params = model_params(jax_run[0], iters)
    jm = jlister.LISTER(configs(iters)[0], policy=J_FP32)
    tm = port_model(jax_run[0], iters)
    images = np.random.default_rng(3).integers(0, 256, (4, 32, 64, 3),
                                               dtype=np.uint8)
    jeng = JInference(jm, params, input_dtype=jnp.float32)
    want_ids, want_conf = (np.asarray(a) for a in jeng._run(
        jeng.params, jnp.asarray(images)))
    engine = LISTERInference(tm, input_dtype=torch.float32, device="cpu")
    ids, conf = engine.run(torch.from_numpy(images))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(conf.numpy(), want_conf, rtol=1e-5, atol=1e-7)
    got = engine.recognize(images)
    assert got == [(t, pytest.approx(c, rel=1e-5, abs=1e-7), h)
                   for t, c, h in jeng.recognize(images)]
    assert all(h == "lister" for *_, h in got)
    # the engine's copy is its own: the model it was given is untouched
    assert engine.model is not tm


def test_softmax_m1_and_mask_pooling_match():
    x = np.abs(np.random.default_rng(4).standard_normal((3, 7))).astype(
        np.float32) * 5
    np.testing.assert_allclose(
        lister.softmax_m1(torch.from_numpy(x), dim=-1).numpy(),
        np.asarray(jlister.softmax_m1(jnp.asarray(x), axis=-1)), **TOL)
    m = (np.random.default_rng(5).uniform(size=(2, 32, 64)) > 0.7).astype(
        np.float32)
    for out_hw in ((16, 32), (8, 64), (1, 16)):
        np.testing.assert_array_equal(
            downsample_mask(torch.from_numpy(m), out_hw).numpy(),
            np.asarray(jfocal.downsample_mask(jnp.asarray(m), out_hw)))


@pytest.mark.parametrize("iters", [0, 1])
def test_convert_carries_the_lister_tree(jax_run, iters):
    """engine/convert maps the JAX tree onto every tensor of the port's
    LISTER (the navigator's [C, C] weight and 0-d bias as they are)."""
    params = model_params(jax_run[0], iters)
    tm = lister.LISTER(configs(iters)[1], policy=FP32_POLICY, device="cpu")
    sd = flax_state_dict(tm, params)
    assert set(sd) == set(tm.state_dict())
    assert sd["decoder.neighbor_navigator.bias"].shape == ()
