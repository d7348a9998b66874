"""The port's LISTER baselines (`models/lister_baselines.py`:
CTCDecoder, ParallelAttention, RNNAttention and `ctc_greedy_loss`),
`codecs/seq_codec.py` `CtcCodec` and `models/lister.py`
`lister_greedy_decode` against the JAX package on the CPU. The heads take
one numpy-seeded flax tree (random, nonzero biases, the GRU's `ir`, `iz`,
`in` and `hn` among them), carried by engine/convert, whose names and
shapes must be those of the JAX modules' own init; float32 on both sides
on a 2 x 6 feature map with a mask that has holes: logits and attention
maps within 1e-5 relative (the same products summed in other orders), the
greedy RNN's fed-back ids equal, over 8 of its 26 steps. The loss is held
to `optax.ctc_loss` on that mask, its invalid frames inside the rows. One
jitted JAX run serves the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu.codecs import seq_codec as jseq
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.models import lister as jlister
from advancedliteratemachinery_tpu.models import lister_baselines as jb
from advancedliteratemachinery_tpu_torch.codecs import seq_codec
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.convert import (
    load_flax_params)
from advancedliteratemachinery_tpu_torch.models import lister
from advancedliteratemachinery_tpu_torch.models import lister_baselines as tb
from test_torch_mgp_str import FAST_COMPILE
from test_torch_omniparser import assert_close, flax_shapes, random_params

torch.set_num_threads(2)

B, Hf, Wf, C, NC, HID = 3, 2, 6, 16, 11, 12
STEPS = 8          # of the default 26, which both modules share
RTOL = 1e-5


def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, Hf, Wf, C)).astype(np.float32)
    mask = np.ones((B, Hf, Wf), np.float32)
    mask[0, :, 4:] = 0          # holes at the end of each row
    mask[1, 0, 5:] = 0
    mask[2, 1, :] = 0           # a whole row
    labels = np.zeros((B, 4), np.int32)
    lens = np.array([3, 4, 2], np.int32)
    for b in range(B):
        labels[b, :lens[b]] = rng.integers(1, NC, lens[b])
    labels[1, 1] = labels[1, 0]                     # a repeat
    targets = rng.integers(0, NC, (B, STEPS)).astype(np.int32)
    return x, mask, labels, lens, targets


@pytest.fixture(scope="module")
def run():
    """The port's three heads, a flax tree each, and one jitted JAX run:
    each head's outputs (the RNN greedy and teacher-forced), the CTC loss
    on the CTC head's logits, and each head's init shapes."""
    x, mask, labels, lens, targets = inputs()
    heads = {
        "ctc": (tb.CTCDecoder(NC, C, policy=FP32_POLICY, device="cpu"),
                jb.CTCDecoder(NC, policy=J_FP32)),
        "pat": (tb.ParallelAttention(NC, C, policy=FP32_POLICY,
                                     device="cpu"),
                jb.ParallelAttention(NC, policy=J_FP32)),
        "rnn": (tb.RNNAttention(NC, C, hidden_size=HID, num_steps=STEPS,
                                policy=FP32_POLICY, device="cpu"),
                jb.RNNAttention(NC, hidden_size=HID, num_steps=STEPS,
                                policy=J_FP32)),
    }
    params = {k: random_params(flax_shapes(port), seed=i)
              for i, (k, (port, _)) in enumerate(heads.items())}

    def fwd(params, x, mask, targets, labels, lens):
        out = {k: heads[k][1].apply({"params": params[k]}, x, mask)
               for k in ("ctc", "pat", "rnn")}
        out["rnn_tf"] = heads["rnn"][1].apply({"params": params["rnn"]},
                                              x, mask, targets)
        out["loss"] = jb.ctc_greedy_loss(out["ctc"]["logits"],
                                         out["ctc"]["mask"], labels, lens)
        return out

    out = jax.jit(fwd, compiler_options=FAST_COMPILE)(
        params, x, mask, targets, labels, lens)
    out = jax.tree.map(np.asarray, out)
    shapes = {k: jax.eval_shape(
        lambda m=m: m.init(jax.random.PRNGKey(0), x, mask))["params"]
        for k, (_, m) in heads.items()}
    ports = {k: load_flax_params(port, params[k])
             for k, (port, _) in heads.items()}
    return ports, params, shapes, out


def t(a):
    return torch.from_numpy(np.array(a))


def test_flax_names_and_shapes_are_the_jax_modules(run):
    _, params, shapes, _ = run
    assert (tb.RNNAttention(NC, C, device="cpu").num_steps
            == jb.RNNAttention(NC).num_steps == 26)
    for k in params:
        assert (jax.tree.map(np.shape, params[k])
                == jax.tree.map(lambda s: s.shape, shapes[k])), k
    gru = params["rnn"]["gru"]
    assert sorted(gru) == ["hn", "hr", "hz", "in", "ir", "iz"]
    assert all(("bias" in gru[n]) == (n not in ("hr", "hz")) for n in gru)
    assert all(np.abs(gru[n]["bias"]).min() > 0
               for n in ("ir", "iz", "in", "hn"))


def test_heads_match_jax(run):
    ports, _, _, out = run
    x, mask, _, _, targets = inputs()
    with torch.no_grad():
        ctc = ports["ctc"](t(x), t(mask))
        pat = ports["pat"](t(x), t(mask))
        rnn = ports["rnn"](t(x), t(mask))
        rnn_tf = ports["rnn"](t(x), t(mask), t(targets))
    assert_close(ctc["logits"], out["ctc"]["logits"], RTOL)
    np.testing.assert_array_equal(ctc["mask"], out["ctc"]["mask"])
    assert_close(pat["logits"], out["pat"]["logits"], RTOL)
    assert_close(pat["char_maps"], out["pat"]["char_maps"], RTOL)
    assert pat["h"] == Hf and pat["char_maps"].shape == (B, 26, Hf * Wf)
    # masked positions get no attention
    assert float(pat["char_maps"][0][:, t(mask[0].reshape(-1)) == 0]
                 .abs().max()) == 0.0
    assert_close(rnn["logits"], out["rnn"]["logits"], RTOL)
    assert_close(rnn_tf["logits"], out["rnn_tf"]["logits"], RTOL)
    fed = rnn["logits"].argmax(-1)
    np.testing.assert_array_equal(fed, out["rnn"]["logits"].argmax(-1))
    assert len(np.unique(fed)) > 2
    assert not np.allclose(rnn["logits"], rnn_tf["logits"])


def test_ctc_loss_matches_optax_on_a_mask_with_holes(run):
    _, _, _, out = run
    _, mask, labels, lens, _ = inputs()
    logits = t(out["ctc"]["logits"])
    flat = t(mask.reshape(B, -1))
    got = tb.ctc_greedy_loss(logits, flat, t(labels), t(lens))
    np.testing.assert_allclose(float(got), float(out["loss"]), rtol=1e-5)
    # the holes sit inside rows: F.ctc_loss on the unpacked prefix differs
    naive = torch.nn.functional.ctc_loss(
        torch.log_softmax(logits, -1).transpose(0, 1), t(labels).long(),
        flat.sum(1).long(), t(lens).long(), reduction="none").mean()
    assert abs(float(naive) - float(out["loss"])) > 1e-3


def test_ctc_codec_matches_jax():
    rng = np.random.default_rng(1)
    got, want = seq_codec.CtcCodec(), jseq.CtcCodec()
    assert got.itos == want.itos and got.num_classes == want.num_classes
    texts = ["", "a", "hello", "0aa9", "zz1"]
    for a, b in zip(got.encode(texts), want.encode(texts)):
        np.testing.assert_array_equal(a, b)
    ids = rng.integers(0, 4, (16, 12))      # blanks and repeats
    ids[:, ::3] = rng.integers(0, got.num_classes, (16, 4))
    assert got.decode(ids) == want.decode(ids)
    assert got.decode([[0, 3, 3, 0, 3, 1, 1]]) == ["cca"]


def test_greedy_decode_takes_the_first_of_tied_maxima():
    rng = np.random.default_rng(2)
    logits = rng.integers(0, 3, (4, 7, 5)).astype(np.float32)  # many ties
    masks = rng.random((4, 7)) > 0.3
    ids, m = lister.lister_greedy_decode(t(logits), t(masks))
    jids, jm = jlister.lister_greedy_decode(jnp.asarray(logits),
                                            jnp.asarray(masks))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(m, np.asarray(jm))
