"""The port's serving (engine/serving.py) on the CPU: `ContinuousBatcher`
(coalescing, padding, errors, bad shapes, concurrent producers),
`SpottingDecodeServer` with mixed-size budgets against the JAX server on
the same weights and requests (memories of 3 to 6 rows padded to 6,
prompts of 1 to 3 tokens), and `SpottingService` against the port's own
`OmniParser.infer_spotting`, page by page, for 3 pages submitted together
and for pages of two sizes served within one memory budget: the same
points, polygons and words up to EOS. The model is tiny (Swin embed 8,
decoder d 32, 2 layers) with its seeded weights made readable by
chip_smoke's `readable_omniparser`, so that the pages emit different
numbers of points and some words end by EOS. Every wait on a thread or a
Future has a timeout of its own."""

import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.engine import serving as jserving
from advancedliteratemachinery_tpu.models import omniparser as jomni
from advancedliteratemachinery_tpu.models import swin as jswin
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.convert import (
    load_flax_params)
from advancedliteratemachinery_tpu_torch.engine.serving import (
    ContinuousBatcher, SpottingDecodeServer, SpottingService)
from advancedliteratemachinery_tpu_torch.models import omniparser, swin
from test_torch_omniparser import flax_shapes, random_params

torch.set_num_threads(2)

WAIT_S = 60


def echo_sum(batch):
    # per-item result = sum of the item
    return [float(batch[i].sum()) for i in range(len(batch))]


class TestContinuousBatcher:
    def test_coalesces_and_returns_per_item(self):
        calls = []

        def infer(batch):
            calls.append(len(batch))
            return echo_sum(batch)

        b = ContinuousBatcher(infer, batch_size=4, item_shape=(2, 2))
        # queued before the worker starts, so they meet in one batch
        futs = [b.submit(np.full((2, 2), i, np.uint8)) for i in range(4)]
        b.start()
        try:
            out = [f.result(timeout=WAIT_S) for f in futs]
        finally:
            b.stop()
        assert out == [0.0, 4.0, 8.0, 12.0]
        assert calls == [4]  # one fused batch

    def test_partial_batch_padded(self):
        b = ContinuousBatcher(echo_sum, batch_size=8,
                              item_shape=(2, 2)).start()
        try:
            out = [b.submit(np.ones((2, 2), np.uint8)).result(
                timeout=WAIT_S)]
        finally:
            b.stop()
        assert out == [4.0]
        assert b.stats["padded_slots"] == 7

    def test_error_propagates(self):
        def broken(batch):
            raise RuntimeError("boom")

        b = ContinuousBatcher(broken, batch_size=2, item_shape=(1,)).start()
        try:
            fut = b.submit(np.zeros((1,), np.uint8))
            with pytest.raises(RuntimeError, match="boom"):
                fut.result(timeout=WAIT_S)
        finally:
            b.stop()

    def test_bad_shape_rejected(self):
        b = ContinuousBatcher(echo_sum, batch_size=2, item_shape=(2, 2))
        with pytest.raises(ValueError):
            b.submit(np.zeros((3, 3), np.uint8))

    def test_concurrent_producers(self):
        b = ContinuousBatcher(echo_sum, batch_size=4,
                              item_shape=(1,)).start()
        results = {}

        def produce(i):
            results[i] = b.submit(np.full((1,), i, np.uint8)).result(
                timeout=WAIT_S)

        threads = [threading.Thread(target=produce, args=(i,))
                   for i in range(10)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
        finally:
            b.stop()
        assert not any(t.is_alive() for t in threads)
        assert results == {i: float(i) for i in range(10)}

    def test_jax_signature_uint8_items_and_the_wait(self):
        """The JAX batcher's defaults (max_wait_ms 5, uint8 items): a
        uint8 crop reaches infer_fn as uint8, and a partial batch waits
        max_wait_ms for co-travelers, which join it."""
        d = ContinuousBatcher(echo_sum, batch_size=2, item_shape=(1,))
        assert d.dtype == np.uint8 and d.max_wait == pytest.approx(0.005)
        seen = []

        def infer(batch):
            seen.append((batch.dtype, time.perf_counter()))
            return echo_sum(batch)

        b = ContinuousBatcher(infer, batch_size=4, item_shape=(2, 2),
                              max_wait_ms=300.0).start()
        try:
            t0 = time.perf_counter()
            first = b.submit(np.full((2, 2), 255, np.uint8))
            time.sleep(0.05)
            second = b.submit(np.full((2, 2), 1, np.uint8))
            out = [first.result(timeout=WAIT_S),
                   second.result(timeout=WAIT_S)]
        finally:
            b.stop()
        assert out == [1020.0, 4.0]          # 4 x 255: no wrap, no cast
        assert [dt for dt, _ in seen] == [np.uint8]
        assert seen[0][1] - t0 >= 0.29


CFG = omniparser.OmniParserConfig(
    swin=swin.SwinConfig(embed_dim=8, depths=(1, 1, 1, 1),
                         num_heads=(1, 2, 2, 2), window_size=4),
    d_model=32, nhead=2, dec_layers=2, dim_feedforward=64, num_bins=20,
    chars="ab", max_position_embeddings=64, pt_seq_length=16,
    poly_length=4, rec_length=5, max_instances=4)
POINTS = (1, 4)


@pytest.fixture(scope="module")
def spotted():
    """The readable tiny model, 3 pages, and infer_spotting's result on
    each."""
    model = omniparser.OmniParser(CFG, policy=FP32_POLICY, device="cpu",
                                  seed=4)
    pages = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 64, 48, 3)).astype(np.float32))
    readable = chip_smoke.readable_omniparser(model, pages, POINTS)
    with torch.no_grad():
        want = [chip_smoke.spotting_summary(
            model.infer_spotting(p[None]), CFG.vocab()) for p in pages]
    return model, pages, readable, want


def test_readable_weights_decode_something(spotted):
    """The chosen EOS lifts end the pages after different numbers of
    points, at most POINTS[1], as predicted from the masked decode, and
    some words end by EOS and others run to rec_length."""
    _, _, readable, want = spotted
    counts = [len(w["points"]) for w in want]
    assert counts == readable["points"]
    assert len(set(counts)) > 1
    assert all(1 <= n <= POINTS[1] for n in counts)
    ended = [e for w in want for e in w["ended"]]
    assert any(ended) and not all(ended)


@pytest.mark.parametrize("n_slots,encode_batch", [(4, 4), (1, 1)])
def test_service_matches_infer_spotting(spotted, n_slots, encode_batch):
    """3 pages submitted together: one batched encode (or one encode a
    page), a pt slot per page (or one pt slot and 4 poly and rec slots,
    all reused); every page gets infer_spotting's points, polygons and
    words up to EOS."""
    model, pages, _, want = spotted
    svc = SpottingService(model, device="cpu", n_slots=n_slots,
                          encode_batch=encode_batch).start()
    try:
        futs = [svc.submit(p.numpy()) for p in pages]
        got = [f.result(timeout=WAIT_S) for f in futs]
    finally:
        svc.stop()
    for g, w in zip(got, want):
        assert g["points"].tolist() == w["points"]
        assert [list(p) for p in g["polygons"]] == w["polygons"]
        assert [list(r) for r in g["rec_tokens"]] == w["words"]
    occ = svc.occupancy
    assert all(0.0 < o <= 1.0 for o in occ.values())
    assert svc.rec_server.stats["requests"] == sum(
        len(w["points"]) for w in want)


def test_service_needs_a_card_unless_told_cpu(spotted, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpottingService(spotted[0])


def test_service_serves_one_page_shape(spotted):
    """With a batched encoder (encode_batch > 1) the service serves the
    first page's shape: a page of another shape is refused at submit, as
    the JAX ContinuousBatcher refuses it. A decode server's memory budget
    latches from its first request: a shorter memory is padded and decodes
    as it does alone, and a longer one fails its own Future while the
    others are served."""
    model, pages, _, want = spotted
    svc = SpottingService(model, device="cpu", n_slots=2,
                          encode_batch=2).start()
    try:
        first = svc.submit(pages[0].numpy())
        with pytest.raises(ValueError, match="shape"):
            svc.submit(np.zeros((32, 48, 3), np.float32))
        assert first.result(timeout=WAIT_S)["points"].tolist() == (
            want[0]["points"])
        memory, mem_pos, mem_valid = svc.model.encode(pages[:1])
        prompt = np.asarray(
            svc.vocab.pt_prompt(svc.cfg.use_char_window_prompt), np.int32)
        srv = svc.pt_server
        assert srv.mem_len == memory.shape[1]
        short = srv.submit(memory[0, :4], mem_pos[0, :4], mem_valid[0, :4],
                           prompt)
        twice = [torch.cat([a[0], a[0]]) for a in (memory, mem_pos,
                                                    mem_valid)]
        long = srv.submit(*twice, prompt)
        with pytest.raises(ValueError, match="exceeds the server budget"):
            long.result(timeout=WAIT_S)
        again = srv.submit(memory[0], mem_pos[0], mem_valid[0], prompt)
        assert again.result(timeout=WAIT_S) == [
            t for xy in want[0]["points"] for t in xy]
        v, c = svc.vocab, svc.cfg
        ids = torch.arange(v.num_classes)
        coord = ids < c.num_bins
        with torch.no_grad():
            toks, _, fin = svc.model._decode_pt(
                memory[:, :4], mem_pos[:, :4], mem_valid[:, :4], 2,
                (coord | (ids == v.pt_eos_index), coord))
        alone = [int(t) for t, f in zip(toks[0], fin[0])
                 if not f and t != v.pt_eos_index]
        assert short.result(timeout=WAIT_S) == alone
    finally:
        svc.stop()


def test_service_serves_mixed_page_sizes(spotted):
    """encode_batch=1 and the larger page's memory length as mem_len:
    pages of two sizes, submitted at once, each get infer_spotting's
    result on that page alone; a page larger than the budget fails its
    own Future."""
    model, pages, _, want = spotted
    small = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (48, 48, 3)).astype(np.float32))
    with torch.no_grad():
        mem_len = model.encode(pages[:1])[0].shape[1]
        assert model.encode(small[None])[0].shape[1] < mem_len
        want_small = chip_smoke.spotting_summary(
            model.infer_spotting(small[None]), CFG.vocab())
    svc = SpottingService(model, device="cpu", n_slots=2, encode_batch=1,
                          mem_len=mem_len).start()
    try:
        mixed = [pages[0], small, pages[1]]
        futs = [svc.submit(p.numpy()) for p in mixed]
        got = [f.result(timeout=WAIT_S) for f in futs]
        big = svc.submit(np.zeros((96, 48, 3), np.float32))
        with pytest.raises(ValueError, match="exceeds the server budget"):
            big.result(timeout=WAIT_S)
    finally:
        svc.stop()
    for g, w in zip(got, [want[0], want_small, want[1]]):
        assert chip_smoke.served_equal(g, w)


# ---------------- the decode server's budgets against JAX ----------------

DEC_KW = dict(d_model=32, nhead=2, dim_feedforward=64, dec_layers=2,
              max_position_embeddings=64)
TINY_SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                 window_size=4)
EOS = 1


@pytest.fixture(scope="module")
def decoders():
    """One seeded flax tree in the JAX OmniParser (test_decode_server.py's
    decoder widths and vocabulary) and in the port's."""
    port = omniparser.OmniParser(
        omniparser.OmniParserConfig(swin=swin.SwinConfig(**TINY_SWIN),
                                    **DEC_KW),
        policy=FP32_POLICY, device="cpu")
    params = random_params(flax_shapes(port), seed=3)
    jm = jomni.OmniParser(jomni.OmniParserConfig(
        swin=jswin.SwinConfig(drop_path_rate=0.0, **TINY_SWIN),
        drop_path_rate=0.0, **DEC_KW), policy=J_FP32)
    return jm, params, load_flax_params(port, params)


def make_sized(seed, s, plen, nc):
    """test_decode_server.py's mixed-shape request."""
    r = np.random.default_rng(seed)
    memory = r.standard_normal((s, DEC_KW["d_model"])).astype(np.float32)
    mem_pos = r.standard_normal((s, DEC_KW["d_model"])).astype(np.float32)
    mem_valid = np.ones((s,), np.float32)
    prompt = r.integers(2, nc, (plen,)).astype(np.int32)
    return memory, mem_pos, mem_valid, prompt


def test_decode_server_budgets_match_jax(decoders):
    """test_decode_server.py's four requests of (mem_len, prompt_len)
    (6, 3), (4, 3), (6, 2) and (3, 1) through both servers with mem_len=6,
    max_prompt_len=3 and 2 slots: the same tokens; a memory of 9 rows
    fails with the JAX message."""
    jm, params, port = decoders
    nc = port.vocab_layout.num_classes
    pad = port.vocab_layout.padding_index
    max_steps = 8
    reqs = [make_sized(11, 6, 3, nc), make_sized(12, 4, 3, nc),
            make_sized(13, 6, 2, nc), make_sized(14, 3, 1, nc)]
    over = make_sized(15, 9, 3, nc)

    def serve(srv, wrap):
        srv.start()
        try:
            futs = [srv.submit(*wrap(r)) for r in reqs]
            out = [f.result(timeout=WAIT_S) for f in futs]
            with pytest.raises(ValueError,
                               match="exceeds the server budget"):
                srv.submit(*wrap(over)).result(timeout=WAIT_S)
        finally:
            srv.stop()
        return out

    want = serve(jserving.SpottingDecodeServer(
        jm, params, task="rec", n_slots=2, max_steps=max_steps, eos_id=EOS,
        pad_id=pad, mem_len=6, max_prompt_len=3), lambda r: r)
    got = serve(SpottingDecodeServer(
        port, "rec", lambda pos, logits: logits, 2, max_steps, EOS,
        mem_len=6, max_prompt_len=3),
        lambda r: (*map(torch.from_numpy, r[:3]), r[3]))
    assert got == want
    assert any(len(w) > 0 for w in want)


def test_divergences_name_the_first_differing_choice(spotted):
    """chip_smoke's `divergences` finds nothing where the service agrees
    with infer_spotting, and the first differing step of the points, or of
    each polygon and word row, where a result was changed; and
    `divergence_margin` reads the f32 gap between the two choices and the
    bf16 error there from teacher-forced passes."""
    model, pages, _, want = spotted
    v = CFG.vocab()
    with torch.no_grad():
        out = model.infer_spotting(pages[:1])
    served = {"points": np.asarray(want[0]["points"], np.int32),
              "polygons": [list(p) for p in want[0]["polygons"]],
              "rec_tokens": [list(w) for w in want[0]["words"]]}
    assert chip_smoke.divergences(served, out, v) == []

    moved = dict(served, points=served["points"].copy())
    moved["points"][1, 0] = (moved["points"][1, 0] + 1) % CFG.num_bins
    (d,) = chip_smoke.divergences(moved, out, v)
    assert (d["stage"], d["row"], d["step"]) == ("pt", 0, 2)
    assert d["prefix"] == want[0]["points"][0] and d["got"] == (
        moved["points"][1, 0])

    words = served["rec_tokens"]
    r = max(range(len(words)), key=lambda i: len(words[i]))
    assert len(words[r]) > 1
    cut = dict(served, rec_tokens=words[:r] + [words[r][:1]] + words[r + 1:])
    (d,) = chip_smoke.divergences(cut, out, v)
    assert (d["stage"], d["row"], d["step"], d["got"]) == (
        "rec", r, 1, v.rec_eos_index)
    poly = dict(served, polygons=[[p[0], (p[1] + 1) % CFG.num_bins] + p[2:]
                                  for p in served["polygons"]])
    found = chip_smoke.divergences(poly, out, v)
    assert [(d["stage"], d["row"], d["step"]) for d in found] == [
        ("poly", i, 1) for i in range(len(words))]

    bf16 = omniparser.OmniParser(CFG, device="cpu")
    bf16.load_state_dict(model.state_dict())
    for d in chip_smoke.divergences(moved, out, v) + found:
        m = chip_smoke.divergence_margin(d, pages[:1], bf16, model)
        assert m["f32_gap"] >= 0 and 0 < m["bf16_err"] < 1
