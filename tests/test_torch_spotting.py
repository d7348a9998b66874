"""The slice end to end at a small size, JAX package against the port with
the same weights: uint8 pages → DB → box extraction → crop_rects →
depth-2 MGP-STR → greedy decode, as bench.py's spotting stage chains
them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from advancedliteratemachinery_tpu.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.engine.infer import (
    MGPSTRInference as JInference)
from advancedliteratemachinery_tpu.models.db import (
    DBConfig as JDBConfig, DBDetector as JDBDetector)
from advancedliteratemachinery_tpu.models.mgp_str import (
    MGPSTR as JMGPSTR, MGPSTRConfig as JConfig)
from advancedliteratemachinery_tpu.models.vit import ViTConfig as JViTConfig
from advancedliteratemachinery_tpu.ops.cc_extract import (
    extract_boxes_device as j_extract)
from advancedliteratemachinery_tpu.ops.image import crop_rects as j_crop
from advancedliteratemachinery_tpu_torch.codecs.char_codec import (
    CharCodec as TCharCodec)
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.convert import (
    load_flax_params)
from advancedliteratemachinery_tpu_torch.engine.infer import MGPSTRInference
from advancedliteratemachinery_tpu_torch.models.db import DBConfig, DBDetector
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.vit import ViTConfig
from advancedliteratemachinery_tpu_torch.ops.cc_extract import (
    extract_boxes_device)
from advancedliteratemachinery_tpu_torch.ops.image import crop_rects
from test_torch_mgp_str import FAST_COMPILE, VIT, VOCABS, random_flax_tree

torch.set_num_threads(2)

P, PH, PW, K = 2, 64, 96, 8
DB_CFG = dict(width=8, fpn_dim=16, head_dim=8)


def test_spotting_slice_matches():
    rng = np.random.default_rng(0)
    pages = rng.integers(0, 256, (P, PH, PW, 3), dtype=np.uint8)
    # as bench.py: the prob head is re-seeded so the background stays near
    # sigmoid(-8), and a word template is max-overlaid on the map
    template = np.zeros((PH, PW), np.float32)
    for r in range(3):
        for c in range(2):
            template[6 + 20 * r: 16 + 20 * r, 6 + 46 * c: 40 + 46 * c] = 1.0

    jdet = JDBDetector(JDBConfig(**DB_CFG), policy=J_FP32)
    dvars = random_flax_tree(jdet, jnp.zeros((1, PH, PW, 3)), seed=1)
    dvars["params"]["prob_up2"]["kernel"][...] = 1e-4
    dvars["params"]["prob_up2"]["bias"][...] = -8.0
    jrec = JMGPSTR(JConfig(vit=JViTConfig(**VIT), **VOCABS), policy=J_FP32)
    rparams = random_flax_tree(jrec, jnp.zeros((1, 32, 128, 3)),
                               seed=2)["params"]
    jengine = JInference(jrec, rparams, CharCodec(), input_dtype=jnp.float32,
                         fused_decode="never")

    prob = jnp.maximum(jax.jit(jdet.apply, compiler_options=FAST_COMPILE)(
        dvars, jnp.asarray(pages))
                       ["prob"][..., 0], template[None])
    jq, js, jv = j_extract(prob, max_boxes=K)
    crops = j_crop(jnp.asarray(pages), jq, dtype=jnp.float32)
    want = jax.jit(jengine._decode_all, compiler_options=FAST_COMPILE)(
        jengine.params, crops.reshape(P * K, 32, 128, 3))

    tdet = DBDetector(DBConfig(**DB_CFG), policy=FP32_POLICY, device="cpu")
    load_flax_params(tdet, dvars["params"], dvars["batch_stats"])
    trec = MGPSTR(MGPSTRConfig(vit=ViTConfig(**VIT), **VOCABS),
                  policy=FP32_POLICY, device="cpu")
    load_flax_params(trec, rparams)
    tengine = MGPSTRInference(trec, TCharCodec(), input_dtype=torch.float32,
                              device="cpu")
    pages_t = torch.from_numpy(pages)
    with torch.no_grad():
        tprob = torch.maximum(tdet(pages_t)["prob"][..., 0],
                              torch.from_numpy(template)[None])
    q, s, v = extract_boxes_device(tprob, max_boxes=K)
    tcrops = crop_rects(pages_t, q, dtype=torch.float32)
    got = tengine._decode_all(tcrops.reshape(P * K, 32, 128, 3))

    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert v.numpy().sum() == P * 6                # every template word
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-3)
    for head in ("char", "bpe", "wp"):
        np.testing.assert_array_equal(got[f"{head}_ids"].numpy(),
                                      np.asarray(want[f"{head}_ids"]))
        np.testing.assert_allclose(got[f"{head}_conf"].numpy(),
                                   np.asarray(want[f"{head}_conf"]),
                                   rtol=1e-4, atol=1e-6)
