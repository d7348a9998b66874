"""DCNv2 port (`ops/deform_conv.py`) against the JAX package on the CPU.

The port's `deform_conv2d` on a CPU tensor is its plain version, exact for
every offset. It is held against JAX `deform_conv2d` both with the windowed
dispatch `DeformConv2d` uses by default (`window_radius=3`: the shifted-
window sampler, its sparse correction for a few out-of-window samples and
its gather fallback for many) and with the gather formulation
(`window_radius=None`), and against the Pallas kernel in interpret mode.
Float32 on both sides: the tolerance covers summation order only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.ops.deform_conv import (
    DeformConv2d as JDeformConv2d, deform_conv2d as j_deform_conv2d)
from advancedliteratemachinery_tpu.ops.deform_conv_pallas import (
    dcn_windowed_pallas)
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.convert import (
    load_flax_params)
from advancedliteratemachinery_tpu_torch.ops.deform_conv import (
    DeformConv2d, deform_conv2d)
from test_torch_mgp_str import FAST_COMPILE, fast_jit, flax_zeros

torch.set_num_threads(2)

B, H, W, CI, CO = 2, 20, 24, 5, 7      # H off the TPU kernel's 8-row bands
TOL = dict(rtol=1e-4, atol=1e-4)       # f32 both sides, summation order


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, CI)).astype(np.float32)
    w = rng.standard_normal((3, 3, CI, CO)).astype(np.float32)
    m = rng.uniform(0.0, 1.0, (B, H, W, 9)).astype(np.float32)
    m[0, :3] = 0.0                                   # a zero mask
    bias = rng.standard_normal((CO,)).astype(np.float32)
    return rng, x, w, m, bias


def _offsets(rng, kind):
    shape = (B, H, W, 9, 2)
    if kind == "in_window":                 # |offset| < 3: the fast path
        return rng.uniform(-2.9, 2.9, shape).astype(np.float32)
    if kind == "some_beyond":               # ~10 % past ±3: sparse correction
        off = rng.uniform(-2.9, 2.9, shape)
        far = rng.random(shape[:-1]) < 0.1
        off[far] = rng.uniform(-8, 8, (int(far.sum()), 2))
        return off.astype(np.float32)
    if kind == "all_beyond":                # > 4096 offenders: gather fallback
        return (np.sign(rng.standard_normal(shape))
                * rng.uniform(3.5, 9, shape)).astype(np.float32)
    if kind == "off_image":                 # ±40 px: most samples outside
        return rng.uniform(-40, 40, shape).astype(np.float32)
    raise ValueError(kind)


def _port(x, off, m, w, bias, **kw):
    t = torch.from_numpy
    return deform_conv2d(t(x), t(off), t(m), t(w), t(bias), **kw).numpy()


@functools.lru_cache(maxsize=None)
def _j_dcn(radius):
    """The JAX `deform_conv2d` at `_inputs`' shapes and `window_radius`,
    compiled once with FAST_COMPILE."""
    rng, x, w, m, bias = _inputs()
    return fast_jit(j_deform_conv2d, x, _offsets(rng, "in_window"), m, w,
                    bias, window_radius=radius)


@pytest.mark.parametrize("kind", ["in_window", "some_beyond", "all_beyond",
                                  "off_image"])
@pytest.mark.parametrize("radius", [3, None])
def test_matches_jax(kind, radius):
    rng, x, w, m, bias = _inputs()
    off = _offsets(rng, kind)
    want = _j_dcn(radius)(x, off, m, w, bias)
    np.testing.assert_allclose(_port(x, off, m, w, bias), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("stride,padding,dilation", [(2, 1, 1), (1, 2, 2),
                                                     (1, 0, 1)])
def test_other_geometries_match_jax_gather(stride, padding, dilation):
    """The plain version takes any stride, padding and dilation (the kernel
    only stride 1 with a same-size output)."""
    rng, x, w, m, bias = _inputs(1)
    Ho = (H + 2 * padding - 2 * dilation - 1) // stride + 1
    Wo = (W + 2 * padding - 2 * dilation - 1) // stride + 1
    off = rng.uniform(-4, 4, (B, Ho, Wo, 9, 2)).astype(np.float32)
    m = m[:, :Ho, :Wo]
    want = j_deform_conv2d(x, off, m, w, bias, stride=stride,
                           padding=padding, dilation=dilation)
    got = _port(x, off, m, w, bias, stride=stride, padding=padding,
                dilation=dilation)
    assert got.shape == (B, Ho, Wo, CO)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_matches_pallas_kernel_interpret():
    """The TPU kernel itself, run in interpret mode, on in-window offsets
    (where it is exact without the caller's correction)."""
    rng, x, w, m, _ = _inputs(2)
    off = _offsets(rng, "in_window")
    want = dcn_windowed_pallas(x, off, m, w, radius=3, interpret=True)
    got = _port(x, off, m, w, np.zeros(CO, np.float32))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_wrapper_rejects_mismatched_shapes():
    _, x, w, m, bias = _inputs()
    off = np.zeros((B, H, W, 9, 2), np.float32)
    with pytest.raises(ValueError, match="do not fit"):
        _port(x, off[:, :-1], m, w, bias)
    with pytest.raises(ValueError, match="do not fit"):
        _port(x, off, m, w[:, :, :-1], bias)


def test_module_matches_jax_module():
    """`DeformConv2d` with flax weights carried over by `engine/convert`:
    the offset/mask conv is scaled so that about a third of the offsets lie
    beyond ±3, and the JAX module keeps its default window_radius=3."""
    jm = JDeformConv2d(CO, policy=J_FP32)
    x = np.random.default_rng(3).standard_normal((B, H, W, CI)).astype(
        np.float32)
    shapes = flax_zeros(DeformConv2d(CI, CO, policy=FP32_POLICY))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes)["params"]
    params["conv_offset_mask"]["kernel"] *= 0.5
    want = np.asarray(jax.jit(jm.apply, compiler_options=FAST_COMPILE)(
        {"params": params}, jnp.asarray(x)))
    tm = load_flax_params(DeformConv2d(CI, CO, policy=FP32_POLICY), params)
    with torch.no_grad():
        om = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            tm.conv_offset_mask.weight, tm.conv_offset_mask.bias, padding=1)
        beyond = (om[:, :18].abs() > 3).float().mean().item()
        got = tm(torch.from_numpy(x)).numpy()
    assert 0.1 < beyond < 0.9, beyond
    np.testing.assert_allclose(got, want, **TOL)
