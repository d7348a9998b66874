"""The port's codecs (codecs/subword, codecs/seq_codec), crop ops
(ops/image `warp_quad_crops`, `resize_word_crops`) and the three-head
`MGPSTRInference.recognize()` against the JAX package on the CPU: the BPE
and WordPiece codecs on the mini vocabularies in tests/fixtures, the GPT-2
pre-tokenizer (a scanner over unicodedata here) against the JAX package's
`regex` pattern on drawn Unicode text, and `recognize()` on the golden
MGP-STR weights with all three codecs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import golden_common as G
import test_checkpoint_import as M
from advancedliteratemachinery_tpu.codecs import seq_codec as jseq
from advancedliteratemachinery_tpu.codecs import subword as jsub
from advancedliteratemachinery_tpu.codecs.char_codec import (
    CharCodec as JCharCodec)
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.engine.checkpoint import (
    import_mgp_str as j_import_mgp_str)
from advancedliteratemachinery_tpu.engine.infer import (
    MGPSTRInference as JInference)
from advancedliteratemachinery_tpu.models.mgp_str import (
    MGPSTR as JMGPSTR, MGPSTRConfig as JConfig)
from advancedliteratemachinery_tpu.models.vit import ViTConfig as JViTConfig
from advancedliteratemachinery_tpu.ops import image as jimage
from advancedliteratemachinery_tpu_torch.codecs import seq_codec, subword
from advancedliteratemachinery_tpu_torch.codecs.char_codec import CharCodec
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine.checkpoint import (
    import_mgp_str, load_torch_state_dict)
from advancedliteratemachinery_tpu_torch.engine.infer import MGPSTRInference
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.vit import ViTConfig
from advancedliteratemachinery_tpu_torch.ops import image as timage
from test_torch_mgp_str import fast_engine

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
BPE_FILES = (os.path.join(FIX, "mini_gpt2_vocab.json"),
             os.path.join(FIX, "mini_gpt2_merges.txt"))
WP_FILE = os.path.join(FIX, "mini_bert_vocab.txt")
CROP_TOL = dict(rtol=0, atol=1e-4)   # [-1, 1] outputs, f32 sums


def bpe_pair(**kw):
    return (subword.BpeCodec.from_files(*BPE_FILES, **kw),
            jsub.BpeCodec.from_files(*BPE_FILES, **kw))


def wp_pair(**kw):
    return (subword.WordpieceCodec.from_file(WP_FILE, **kw),
            jsub.WordpieceCodec.from_file(WP_FILE, **kw))


# letters, marks, Nl/No numbers, apostrophes, contractions and runs of
# (also non-ASCII) whitespace; code points unassigned in Python's Unicode
# tables are left out, as `regex` may know a newer Unicode
SPECIALS = ["Ⅻ", "²", "½", "'", "'s", "'t", "'re", "'ll", "'d", "'m", "'ve",
            " ", "  ", "\t", "\n", " \t ", "　", " ", "\x1c", "é",
            "é", "a", "Z", "7", "٣", "!", "?!"]
TEXT = st.lists(st.one_of(
    st.characters(exclude_categories=("Cs", "Cn")),
    st.sampled_from(SPECIALS)), max_size=24).map("".join)


@settings(max_examples=200, deadline=None)
@given(TEXT)
def test_pretokenizer_matches_the_regex_pattern(text):
    assert subword.gpt2_pretokenize(text) == jsub._GPT2_PAT.findall(text)


@pytest.mark.parametrize("text", [
    "", " ", "  \t\n ", "a  b", "x's 've'll", "Ⅻ²½ ½", "don't!!  ok ",
    "tab\tsep\x1cfs", "é é ٣٤"])
def test_pretokenizer_edge_cases(text):
    assert subword.gpt2_pretokenize(text) == jsub._GPT2_PAT.findall(text)


def test_bpe_codec_matches_jax():
    tc, jc = bpe_pair(batch_max_length=10)
    texts = ["lower", "lower newer wider", "low lowest", "dinner", "er"]
    np.testing.assert_array_equal(tc.encode(texts), jc.encode(texts))
    assert [tc.encode_text(t) for t in texts] == [jc.encode_text(t)
                                                  for t in texts]
    assert tc.bpe_ranks == jc.bpe_ranks
    with pytest.raises(KeyError):            # byte token outside the vocab
        tc.encode(["z"])
    ids = np.random.default_rng(0).integers(0, 30, (16, 12))
    assert tc.decode(ids) == jc.decode(ids)  # ids past the vocab give ''
    assert tc.decode(tc.encode(texts)) == jc.decode(jc.encode(texts))
    assert subword.bytes_to_unicode() == jsub.bytes_to_unicode()


def test_bpe_decode_prunes_at_hash():
    tc, jc = bpe_pair()
    tc.decoder[7] = jc.decoder[7] = "#"
    ids = np.array([[14, 15, 7, 16, 3], [7, 0, 0, 0, 0]])
    assert tc.decode(ids) == jc.decode(ids) == [" lower", ""]


def test_wordpiece_codec_matches_jax():
    tc, jc = wp_pair(batch_max_length=6)
    texts = ["unwanted running", "Want, lower!", "xyz", "wa un runn",
             "unwanted unwanted unwanted", ""]
    np.testing.assert_array_equal(tc.encode(texts), jc.encode(texts))
    enc = tc.encode(texts)
    assert (enc[:, 0] == tc.cls_id).all()
    assert enc[4, -1] == tc.sep_id            # truncation keeps [SEP]
    ids = np.random.default_rng(1).integers(0, 20, (16, 8))
    assert tc.decode(ids) == jc.decode(ids)
    assert tc.decode(enc) == jc.decode(enc)
    assert tc.decode(enc)[0] == "[CLS]unwantedrunning[SEP][PAD]"


def test_default_vocabs_are_not_downloaded(monkeypatch, tmp_path):
    monkeypatch.setattr(subword, "ASSETS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="gpt2_vocab.json"):
        subword.BpeCodec.default()
    with pytest.raises(FileNotFoundError, match="bert_base_uncased"):
        subword.WordpieceCodec.default()


def test_eos_seq_codec_matches_jax():
    tc, jc = seq_codec.EosSeqCodec(max_ch=8), jseq.EosSeqCodec(max_ch=8)
    texts = ["abc", "z9", "", "abcdefg"]
    for got, want in zip(tc.encode(texts), jc.encode(texts)):
        np.testing.assert_array_equal(got, want)
    assert tc.num_classes == jc.num_classes == 37
    ids = np.random.default_rng(2).integers(0, 37, (12, 8))
    assert tc.decode(ids) == jc.decode(ids)
    for codec in (tc, jc):
        with pytest.raises(ValueError):
            codec.encode(["abcdefgh"])


def _quads(kind, rng, P, K, H, W):
    """[P, K, 4, 2] corners (tl, tr, br, bl) in pixel-corner space."""
    x0 = rng.uniform(-8, W - 10, (P, K))
    y0 = rng.uniform(-6, H - 6, (P, K))
    w = rng.uniform(4, W / 2, (P, K))
    h = rng.uniform(3, H / 2, (P, K))
    if kind == "rect":
        dx, dy = np.zeros_like(w), np.zeros_like(h)
    elif kind == "parallelogram":
        dx, dy = 0.4 * h, 0.2 * w
    else:                                   # a quad that leaves the page
        q = np.stack([x0, y0], -1)[:, :, None] + rng.uniform(
            -20, 60, (P, K, 4, 2))
        return q.astype(np.float32)
    q = np.stack([np.stack([x0, y0], -1),
                  np.stack([x0 + w, y0 + dy], -1),
                  np.stack([x0 + w + dx, y0 + dy + h], -1),
                  np.stack([x0 + dx, y0 + h], -1)], axis=2)
    return q.astype(np.float32)


@pytest.mark.parametrize("kind", ["rect", "parallelogram", "quad"])
def test_warp_quad_crops_matches_jax(kind):
    rng = np.random.default_rng(3)
    pages = rng.integers(0, 256, (2, 40, 70, 3), dtype=np.uint8)
    quads = _quads(kind, rng, 2, 5, 40, 70)
    want = jimage.warp_quad_crops(jnp.asarray(pages), jnp.asarray(quads),
                                  (8, 24), jnp.float32)
    got = timage.warp_quad_crops(torch.from_numpy(pages),
                                 torch.from_numpy(quads), (8, 24),
                                 torch.float32)
    assert got.shape == (2, 5, 8, 24, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CROP_TOL)


@pytest.mark.parametrize("hw,out_hw,antialias", [
    ((40, 70), (32, 128), True), ((40, 70), (32, 128), False),
    ((64, 300), (32, 100), True), ((64, 300), (32, 100), False),
    ((9, 13), (32, 128), True)])
def test_resize_word_crops_matches_jax(hw, out_hw, antialias):
    crops = np.random.default_rng(4).integers(0, 256, (3, *hw, 3),
                                              dtype=np.uint8)
    want = jimage.resize_word_crops(jnp.asarray(crops), out_hw, jnp.float32,
                                    antialias)
    got = timage.resize_word_crops(torch.from_numpy(crops), out_hw,
                                   torch.float32, antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CROP_TOL)


def test_recognize_fuses_three_heads_as_jax():
    """tests/golden/mgp_str.pth into the JAX engine through the JAX
    importer and into the port's engine through the port's; `recognize()`
    with the char, BPE and WordPiece codecs must give the same (text, head)
    and confidences within 1e-5 (f32 on both sides). The head biases are
    moved so that the char and BPE heads emit their EOS with confidences
    close enough for the winner to change from crop to crop, and the
    heads favour tokens of the mini vocabularies. (The WordPiece head's EOS
    id, 102, lies past the golden's 64-entry head, so its confidence is 0,
    as in the JAX engine.)"""
    sd = load_torch_state_dict(os.path.join(G.GOLDEN_DIR, "mgp_str.pth"))
    sd["char_head.bias"][1] += 1.0
    sd["bpe_head.bias"][2] += 3.7
    sd["bpe_head.bias"][10:21] += 2.0
    sd["wp_head.bias"][4:13] += 2.5
    vit = dict(embed_dim=M.D, depth=M.DEPTH, num_heads=M.HEADS)
    vocab = dict(batch_max_length=M.T - 2, bpe_vocab_size=64,
                 wp_vocab_size=64)
    tm = MGPSTR(MGPSTRConfig(vit=ViTConfig(**vit), **vocab),
                policy=FP32_POLICY, device="cpu")
    import_mgp_str(sd, tm)
    jm = JMGPSTR(JConfig(variant="tiny", vit=JViTConfig(**vit), **vocab),
                 policy=J_FP32)
    import jax
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 128, 3)))["params"]
    params = j_import_mgp_str(
        {k: v.numpy() for k, v in sd.items()},
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    bpe_t, bpe_j = bpe_pair(batch_max_length=M.T - 2)
    wp_t, wp_j = wp_pair(batch_max_length=M.T - 2)
    images = np.random.default_rng(5).integers(0, 256, (12, 32, 128, 3),
                                               dtype=np.uint8)
    jeng = JInference(jm, params, JCharCodec(batch_max_length=M.T - 2),
                      bpe_j, wp_j, input_dtype=jnp.float32,
                      fused_decode="never")
    want = fast_engine(jeng, jeng.params, images).recognize(images)
    got = MGPSTRInference(tm, CharCodec(batch_max_length=M.T - 2), bpe_t,
                          wp_t, input_dtype=torch.float32,
                          device="cpu").recognize(images)
    assert [(t, h) for t, _, h in got] == [(t, h) for t, _, h in want]
    np.testing.assert_allclose([c for _, c, _ in got],
                               [c for _, c, _ in want], rtol=1e-5, atol=1e-7)
    assert {h for _, _, h in got} == {"char", "bpe"}, got
    assert all(0.0 <= c <= 1.0 for _, c, _ in got)


def test_recognize_fusion_on_shared_outputs_as_jax():
    """`recognize()`'s fusion alone, on one set of head outputs given to
    both engines: ids drawn over each head's whole width (ids past the mini
    vocabularies, [CLS], [SEP] and [PAD] included) and confidences drawn so
    that each of char, BPE and WordPiece wins some crops. The WordPiece
    branch (decode, then cut at '[SEP]') is held to the JAX engine's here;
    the golden test above cannot reach it, as its WordPiece EOS lies past
    the head. Strings, heads and confidences must be equal."""
    rng = np.random.default_rng(6)
    B, T = 48, M.T - 1
    out = {"char_ids": rng.integers(0, 38, (B, T)),
           "bpe_ids": rng.integers(0, 64, (B, T)),
           "wp_ids": rng.integers(0, 20, (B, T))}
    for h in ("char", "bpe", "wp"):
        out[f"{h}_ids"] = out[f"{h}_ids"].astype(np.int32)
        out[f"{h}_conf"] = rng.random(B).astype(np.float32)

    def engine(cls, char, bpe, wp):     # its recognize(), fed `out`
        eng = object.__new__(type("Fixed", (cls,), {
            "__call__": lambda self, images_u8: out}))
        eng.codec, eng.bpe_codec, eng.wp_codec = char, bpe, wp
        return eng

    bpe_t, bpe_j = bpe_pair(batch_max_length=M.T - 2)
    wp_t, wp_j = wp_pair(batch_max_length=M.T - 2)
    want = engine(JInference, JCharCodec(batch_max_length=M.T - 2), bpe_j,
                  wp_j).recognize(None)
    got = engine(MGPSTRInference, CharCodec(batch_max_length=M.T - 2),
                 bpe_t, wp_t).recognize(None)
    assert got == want
    assert {h for _, _, h in got} == {"char", "bpe", "wp"}
    raw = wp_t.decode(out["wp_ids"])
    assert any(h == "wp" and t and raw[i] != t and "[SEP]" in raw[i]
               for i, (t, _, h) in enumerate(got))
