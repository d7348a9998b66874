"""DB detector port (models/db.py) against the JAX package: the same weights
and non-trivial BatchNorm statistics carried across by engine/convert; the
JAX model's space-to-depth stem against the port's plain 7x7/s2 conv."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.models.db import (
    DBConfig as JDBConfig, DBDetector as JDBDetector)
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.convert import (
    load_flax_params)
from advancedliteratemachinery_tpu_torch.models.db import DBConfig, DBDetector
from test_torch_mgp_str import random_flax_tree

torch.set_num_threads(2)

CFG = dict(width=8, fpn_dim=16, head_dim=8)


def test_prob_map_matches_jax():
    # inputs in [-1, 1] keep the random network's map off saturation
    pages = np.random.default_rng(0).uniform(-1, 1, (2, 64, 96, 3)).astype(
        np.float32)
    jm = JDBDetector(JDBConfig(**CFG), policy=J_FP32)
    # random weights and non-trivial BatchNorm statistics, so eval-mode BN
    # is really exercised
    variables = random_flax_tree(jm, jnp.asarray(pages[:1]))
    want = np.asarray(
        jax.jit(jm.apply)(variables, jnp.asarray(pages))["prob"])

    tm = DBDetector(DBConfig(**CFG), policy=FP32_POLICY, device="cpu")
    load_flax_params(tm, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(pages))["prob"].numpy()
    assert got.shape == (2, 64, 96, 1)
    assert ((want > 0.05) & (want < 0.95)).mean() > 0.5   # not saturated
    # f32 throughout; 1e-5 covers conv summation order over 20 layers
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
