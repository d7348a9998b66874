"""Three steps of the port's MGP-STR train step against the JAX package's
`make_mgp_str_train_step` on a one-device mesh, at the small size of
`test_torch_train.py` (same weights, same batches): Adam with a clip that
acts, and AdamW with warm-up."""

import jax
import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu.engine import train as jtrain
from advancedliteratemachinery_tpu.parallel.mesh import create_mesh
from advancedliteratemachinery_tpu_torch.engine.convert import flax_state_dict
from advancedliteratemachinery_tpu_torch.engine.train import (
    TrainState, make_mgp_str_train_step, make_optimizer)
from test_torch_train import _batch, _port, _torch_batch, flax_pair  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("opt", [
    dict(lr=1e-3, total_steps=10, grad_clip=0.05),           # the clip acts
    dict(lr=1e-3, total_steps=10, grad_clip=5.0, weight_decay=0.01,
         warmup_steps=2)])
def test_three_steps_match_jax(flax_pair, opt):
    jm, params = flax_pair
    batches = [_batch(10 + i) for i in range(3)]
    jstate = jtrain.TrainState.create(params, jtrain.make_optimizer(**opt))
    jstep, _ = jtrain.make_mgp_str_train_step(
        jm, jstate, create_mesh(1, 1, 1, devices=jax.devices()[:1]),
        donate=False)
    tm = _port(params)
    state = TrainState.create(tm, make_optimizer(**opt))
    step = make_mgp_str_train_step(tm, state)
    key = jax.random.PRNGKey(0)
    for batch in batches:
        jstate, jm_out = jstep(jstate, batch, key)
        got = step(_torch_batch(batch))
        np.testing.assert_allclose(got["loss"].item(), float(jm_out["loss"]),
                                   rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    want = flax_state_dict(tm, jax.tree.map(np.asarray, jstate.params))
    bound = 0.05 * opt["lr"] * 3
    for name, p in tm.state_dict().items():
        # Adam's first steps move each weight by about ±lr whatever the
        # gradient's size, so agreement is measured in units of lr·steps
        err = np.abs(p.numpy() - want[name].numpy()).max()
        assert err <= bound, (name, err, bound)
