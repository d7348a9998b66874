"""The port's checkpoint loader and importers (engine/checkpoint) on the
CPU: the loader's formats (.pth wrappers and DDP prefixes, bf16,
weights_only, .safetensors bitwise against the `safetensors` package, a
sharded index), each importer against the torch mirrors of the reference
math in the JAX package's import tests, each importer's state dict against
the JAX importer + engine/convert on the same checkpoint (exactly equal),
the DCN offset layout at offsets of several pixels against a plain DCNv2
written here, the errors, and the golden artifacts tests/golden/
{mgp_str,lore,lister}.pth replayed through the port alone at
`golden_common.TOLERANCES`."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import chip_smoke
import golden_common as G
import test_checkpoint_import as MGP
import test_dla_import as DLA
import test_focalnet_import as FN
import test_lister_import as LI
import test_lore_processor_import as PROC
from advancedliteratemachinery_tpu.core.precision import FP32_POLICY as J_FP32
from advancedliteratemachinery_tpu.engine import checkpoint as jck
from advancedliteratemachinery_tpu.models import focalnet as jfocal
from advancedliteratemachinery_tpu.models import lister as jlister
from advancedliteratemachinery_tpu.models.lore import (
    LoreConfig as JLoreConfig, LoreProcessor as JLoreProcessor)
from advancedliteratemachinery_tpu.models.mgp_str import (
    MGPSTR as JMGPSTR, MGPSTRConfig as JConfig)
from advancedliteratemachinery_tpu.models.vit import ViTConfig as JViTConfig
from advancedliteratemachinery_tpu_torch.core.precision import FP32_POLICY
from advancedliteratemachinery_tpu_torch.engine import checkpoint as ck
from advancedliteratemachinery_tpu_torch.engine.convert import (
    flax_state_dict)
from advancedliteratemachinery_tpu_torch.models.dla import (
    DLAConfig, DLASeg, DLASegConfig)
from advancedliteratemachinery_tpu_torch.models.focalnet import (
    FocalNet, FocalNetConfig)
from advancedliteratemachinery_tpu_torch.models.lister import (
    LISTER, LISTERConfig)
from advancedliteratemachinery_tpu_torch.models.lore import (
    LORE, LoreConfig, LoreProcessor)
from advancedliteratemachinery_tpu_torch.models.mgp_str import (
    MGPSTR, MGPSTRConfig)
from advancedliteratemachinery_tpu_torch.models.vit import ViTConfig

torch.set_num_threads(2)

# the configurations of the golden artifacts and of the torch mirrors, from
# the JAX tests that build them
MGP_CFG = MGPSTRConfig(batch_max_length=MGP.T - 2, bpe_vocab_size=64,
                       wp_vocab_size=64,
                       vit=ViTConfig(embed_dim=MGP.D, depth=MGP.DEPTH,
                                     num_heads=MGP.HEADS))
DLA_CFG = DLASegConfig(dla=DLAConfig(levels=DLA.LEVELS, channels=DLA.CH),
                       head_conv=DLA.HEAD_CONV, heads=DLA.HEADS)
FOCAL_KW = dict(embed_dim=8, depths=(1, 1, 1, 1), layerscale_value=1e-2)
LISTER_KW = dict(max_ch=6, iters=1, nhead=2, window_size=5)
LISTER_CFG = LISTERConfig(focalnet=FocalNetConfig(**FOCAL_KW), **LISTER_KW)
PROC_CFG = dict(input_size=PROC.HID, hidden_size=PROC.HID,
                tsfm_layers=PROC.LAYERS, stacking_layers=PROC.STACK_LAYERS,
                num_heads=PROC.HEADS, max_fmp_size=PROC.FMP)


def golden(family):
    sd = ck.load_torch_state_dict(os.path.join(G.GOLDEN_DIR,
                                               f"{family}.pth"))
    return sd, np.load(os.path.join(G.GOLDEN_DIR, f"{family}.npz"))


def zeros_tree(init, *args, **kw):
    shapes = jax.eval_shape(lambda *a: init(jax.random.PRNGKey(0), *a, **kw),
                            *args)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def numpy_sd(sd):
    return {k: v.float().numpy() for k, v in sd.items()}


def assert_same_state(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ---------------- the loader ----------------


def test_chip_smoke_golden_configs_are_the_tests():
    import test_torch_docxlayout
    import test_torch_levocr
    import test_torch_omniparser
    assert chip_smoke.GOLDEN_MGP_STR == MGP_CFG
    assert chip_smoke.GOLDEN_DLASEG == DLA_CFG
    assert chip_smoke.GOLDEN_LISTER == LISTER_CFG
    assert chip_smoke.GOLDEN_LEVOCR == test_torch_levocr.GOLDEN_CFG
    assert (chip_smoke.GOLDEN_OMNIPARSER
            == test_torch_omniparser.golden_configs()[1])
    assert chip_smoke.GOLDEN_DOCXLAYOUT == test_torch_docxlayout.GOLDEN_CFG
    assert chip_smoke.GOLDEN_TOL == {
        f: G.TOLERANCES[f][0] for f in ("mgp_str", "lore", "lister",
                                        "levocr", "omniparser",
                                        "docxlayout")}


@pytest.mark.parametrize("wrap", ["model", "state_dict", "net", None])
def test_pth_wrappers_and_ddp_prefix(tmp_path, wrap):
    g = torch.Generator().manual_seed(0)
    sd = {"module.a.weight": torch.randn(3, 4, generator=g),
          "module.b.bias": torch.randn(5, generator=g).bfloat16(),
          "c.module.x": torch.arange(6)}
    path = str(tmp_path / "ckpt.pth")
    torch.save({wrap: sd, "epoch": 3} if wrap else sd, path)
    got = ck.load_torch_state_dict(path)
    assert set(got) == {"a.weight", "b.bias", "c.module.x"}
    assert got["b.bias"].dtype == torch.bfloat16          # as stored
    for k, v in sd.items():
        assert torch.equal(got[k.removeprefix("module.")], v)


def test_weights_only_refuses_pickled_objects(tmp_path):
    path = str(tmp_path / "full.pth")
    torch.save({"model": {"w": torch.ones(2)}, "net_obj": nn.Linear(2, 2)},
               path)
    with pytest.raises(RuntimeError, match="trusted=True"):
        ck.load_torch_state_dict(path)
    got = ck.load_torch_state_dict(path, trusted=True)
    assert set(got) == {"w"}


def test_safetensors_bitwise_against_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(1)
    sd = {"module.f32": torch.randn(3, 5, generator=g),
          "f16": torch.randn(7, generator=g).half(),
          "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
          "i64": torch.arange(-5, 5),
          "i32": torch.arange(9, dtype=torch.int32).reshape(3, 3),
          "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "m.safetensors")
    st.save_file(sd, path, metadata={"format": "pt"})
    want = st.load_file(path)
    got = ck.load_safetensors(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k].view(-1).view(torch.uint8),
                           v.view(-1).view(torch.uint8)), k
    loaded = ck.load_torch_state_dict(path)
    assert "f32" in loaded and torch.equal(loaded["bf16"], sd["bf16"])


def test_sharded_index_merges(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    st.save_file({"a.weight": torch.ones(2)},
                 str(tmp_path / "model-00001-of-00002.safetensors"))
    torch.save({"b.weight": torch.full((3,), 2.0)},
               str(tmp_path / "model-00002-of-00002.bin"))
    index = {"weight_map": {"a.weight": "model-00001-of-00002.safetensors",
                            "b.weight": "model-00002-of-00002.bin"}}
    path = str(tmp_path / "model.safetensors.index.json")
    with open(path, "w") as f:
        json.dump(index, f)
    got = ck.load_torch_state_dict(path)
    assert set(got) == {"a.weight", "b.weight"}
    assert torch.equal(got["b.weight"], torch.full((3,), 2.0))


# ---------------- importers against the torch mirrors ----------------


@pytest.fixture(scope="module")
def mgp_mirror():
    torch.manual_seed(0)
    tm = MGP.TorchMGPSTR().eval()
    port = MGPSTR(MGP_CFG, policy=FP32_POLICY, device="cpu")
    sd = ck.import_mgp_str({"mgp_str." + k: v
                            for k, v in tm.state_dict().items()}, port)
    return tm, port, sd


def test_mgp_str_import_matches_mirror(mgp_mirror):
    tm, port, sd = mgp_mirror
    img = np.random.default_rng(0).standard_normal((2, 32, 128, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(img.transpose(0, 3, 1, 2)))
        got = port(torch.from_numpy(img))
    for head, v in (("char", 38), ("bpe", 64), ("wp", 64)):
        np.testing.assert_allclose(got[head][..., :v].numpy(),
                                   want[head].numpy(), rtol=2e-4, atol=2e-4)
        # the padded columns carry -1e4 and never win
        assert (sd[f"{head}_head.bias"][v:] == -1e4).all()
        assert (sd[f"{head}_head.weight"][v:] == 0).all()
        assert int(got[head].argmax(-1).max()) < v


def test_dla_import_matches_mirror():
    torch.manual_seed(0)
    tm = DLA.TDLASeg().eval()
    port = DLASeg(DLA_CFG, policy=FP32_POLICY, device="cpu")
    ck.import_dla(tm.state_dict(), port)
    img = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(img.transpose(0, 3, 1, 2)))
        got = port(torch.from_numpy(img))
    for head, _ in DLA.HEADS:
        np.testing.assert_allclose(got[head].numpy(),
                                   want[head].numpy().transpose(0, 2, 3, 1),
                                   rtol=2e-3, atol=2e-3, err_msg=head)


def dcn_v2(x, om, weight, bias):
    """The reference modulated DCNv2 (dcn_v2.py:147, NCHW, 3x3, stride 1,
    padding 1): channels [0, 18) of the offset conv's output are
    interleaved (y_k, x_k) pairs, [18, 27) the mask logits; a sample at
    (py, px) is 0 unless -1 < py < H and -1 < px < W, and each bilinear
    corner off the image counts 0."""
    B, C, H, W = x.shape
    off, mask = om[:, :18], torch.sigmoid(om[:, 18:])
    flat = x.reshape(B, C, H * W)
    cols = []
    for k in range(9):
        py = (torch.arange(H)[:, None] - 1 + k // 3 + off[:, 2 * k])
        px = (torch.arange(W)[None] - 1 + k % 3 + off[:, 2 * k + 1])
        y0, x0 = torch.floor(py), torch.floor(px)
        val = torch.zeros(B, C, H, W)
        for yy, wy in ((y0, 1 - (py - y0)), (y0 + 1, py - y0)):
            for xx, wx in ((x0, 1 - (px - x0)), (x0 + 1, px - x0)):
                ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
                g = torch.gather(flat, 2, idx.reshape(B, 1, -1).expand(
                    -1, C, -1)).reshape(B, C, H, W)
                val = val + g * (wy * wx * ok)[:, None]
        inside = (py > -1) & (px > -1) & (py < H) & (px < W)
        cols.append(val * inside[:, None] * mask[:, k:k + 1])
    col = torch.stack(cols, 2)                          # [B, C, 9, H, W]
    out = torch.einsum("bckhw,ock->bohw", col, weight.reshape(
        weight.shape[0], C, 9))
    return out + bias[None, :, None, None]


def test_dcn_offsets_several_pixels_match_a_plain_dcnv2(monkeypatch):
    """The mirror DLASeg with real DCNv2s (the interleaved layout) and
    offset/mask convs spread so that offsets reach several pixels; imported
    through `import_dla` (its offset permutation), the port's DeformConv2d
    layers must give the same head maps."""
    biggest = []

    def forward(self, x):
        om = self.conv_offset_mask(x)
        biggest.append(om[:, :18].abs().max().item())
        return dcn_v2(x, om, self.weight, self.bias)

    monkeypatch.setattr(DLA.TDCN, "forward", forward)
    torch.manual_seed(1)
    tm = DLA.TDLASeg().eval()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, DLA.TDCN):
                com = m.conv_offset_mask
                com.weight.normal_(0, 0.05, generator=g)
                com.bias[:18].normal_(0, 2.5, generator=g)
                com.bias[18:].normal_(0, 1, generator=g)
    port = DLASeg(DLA_CFG, policy=FP32_POLICY, device="cpu")
    ck.import_dla(tm.state_dict(), port)
    img = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(img.transpose(0, 3, 1, 2)))
        got = port(torch.from_numpy(img))
    assert len(biggest) == 16 and min(biggest) > 3.0, biggest
    for head, _ in DLA.HEADS:
        np.testing.assert_allclose(got[head].numpy(),
                                   want[head].numpy().transpose(0, 2, 3, 1),
                                   rtol=2e-3, atol=2e-3, err_msg=head)


def test_lore_processor_import_matches_mirror():
    torch.manual_seed(0)
    tm = PROC.TorchProcessor().eval()
    port = LoreProcessor(LoreConfig(**PROC_CFG), policy=FP32_POLICY)
    ck.import_lore_processor(tm.state_dict(), port)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2, 5, PROC.HID)).astype(np.float32)
    boxes = rng.integers(0, PROC.FMP, (2, 5, 8)).astype(np.float32)
    with torch.no_grad():
        logic, stacked = tm(torch.from_numpy(feat),
                            torch.from_numpy(boxes).long())
        got = port(torch.from_numpy(feat), torch.from_numpy(boxes))
    np.testing.assert_allclose(got["logic"].numpy(), logic.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["stacked_logic"].numpy(),
                               stacked.numpy(), rtol=2e-4, atol=2e-4)


def test_focalnet_import_matches_mirror(monkeypatch):
    monkeypatch.setattr(FN, "E", 8)
    torch.manual_seed(0)
    tm = FN.TFocalNet().eval()
    port = FocalNet(FocalNetConfig(**FOCAL_KW), policy=FP32_POLICY,
                    device="cpu")
    ck.import_focalnet({"encoder." + k: v
                        for k, v in tm.state_dict().items()}, port)
    img = np.random.default_rng(0).standard_normal((2, 32, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(img.transpose(0, 3, 1, 2)))
        got, _ = port(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_lister_decoder_blocks_match_mirrors():
    """The golden LISTER checkpoint through `import_lister`: its local
    attention block against `TLocalBlock` with the same tensors, on a
    masked sequence, and its navigator against the reference BilinearLayer
    (nb_decoder.py:35-46)."""
    sd, _ = golden("lister")
    port = LISTER(LISTER_CFG, policy=FP32_POLICY, device="cpu")
    ck.import_lister(sd, port)
    pre = "decoder.cntx_module.attn_blocks.0."
    blk = LI.TLocalBlock(64, 2, 5, True).eval()
    blk.load_state_dict({k[len(pre):]: v for k, v in sd.items()
                         if k.startswith(pre)})
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(np.float32))
    mask = torch.ones(2, 9)
    mask[1, 6:] = 0.0
    with torch.no_grad():
        np.testing.assert_allclose(port.decoder.cntx_module(x, mask).numpy(),
                                   blk(x, mask).numpy(), rtol=2e-3,
                                   atol=2e-3)
        q, k = x[:, :5], x[:, 2:9]
        w, b = (sd[f"decoder.neighbor_navigator.{n}"]
                for n in ("weight", "bias"))
        y = torch.einsum("bim,omn->bino", q, w)
        want = (torch.einsum("bino,bjn->bijo", y, k) + b.view(1, 1, 1, -1))
        np.testing.assert_allclose(
            port.decoder.neighbor_navigator(q, k).numpy(),
            want[..., 0].numpy(), rtol=1e-5, atol=1e-4)


def test_load_lore_reads_both_reference_files(tmp_path):
    """`load_lore`: the DLASeg file and the Processor file into one LORE,
    each part equal to its own importer's result."""
    torch.manual_seed(0)
    psd = PROC.TorchProcessor().state_dict()
    proc_path = str(tmp_path / "processor.pth")
    torch.save({"epoch": 1, "state_dict": psd}, proc_path)
    lore = LORE(LoreConfig(backbone=DLA_CFG, **PROC_CFG), policy=FP32_POLICY,
                device="cpu")
    got = ck.load_lore(lore, os.path.join(G.GOLDEN_DIR, "lore.pth"),
                       proc_path)
    assert set(got) == set(lore.state_dict())
    sd, _ = golden("lore")
    want = ck.import_dla(sd, DLASeg(DLA_CFG, policy=FP32_POLICY,
                                    device="cpu"))
    proc = LoreProcessor(LoreConfig(**PROC_CFG), policy=FP32_POLICY)
    want = {**{f"backbone.{k}": v for k, v in want.items()},
            **{f"processor.{k}": v for k, v in
               ck.import_lore_processor(psd, proc).items()}}
    assert_same_state(got, want)
    assert_same_state({k: v for k, v in lore.state_dict().items()}, want)


# ---------------- importers against the JAX route ----------------


def test_mgp_str_state_equals_jax_route(mgp_mirror):
    tm, port, sd = mgp_mirror
    jm = JMGPSTR(JConfig(variant="tiny", batch_max_length=MGP.T - 2,
                         bpe_vocab_size=64, wp_vocab_size=64,
                         vit=JViTConfig(embed_dim=MGP.D, depth=MGP.DEPTH,
                                        num_heads=MGP.HEADS)),
                 policy=J_FP32)
    params = zeros_tree(jm.init, jnp.zeros((1, 32, 128, 3)))["params"]
    params = jck.import_mgp_str(numpy_sd(tm.state_dict()), params)
    assert_same_state(sd, flax_state_dict(port, params))


def test_lore_processor_state_equals_jax_route():
    """(DLASeg's: tests/test_torch_lore.py, on the golden.)"""
    torch.manual_seed(0)
    psd = PROC.TorchProcessor().state_dict()
    jp = JLoreProcessor(JLoreConfig(**PROC_CFG), policy=J_FP32)
    params = jck.import_lore_processor(numpy_sd(psd), zeros_tree(
        jp.init, jnp.zeros((1, 3, PROC.HID)), jnp.zeros((1, 3, 8)))[
            "params"])
    proc = LoreProcessor(LoreConfig(**PROC_CFG), policy=FP32_POLICY)
    assert_same_state(ck.import_lore_processor(psd, proc),
                      flax_state_dict(proc, params))


def test_lister_states_equal_jax_route():
    sd, data = golden("lister")
    jfocal.FOCALNET_VARIANTS.setdefault(
        "import_tiny", jfocal.FocalNetConfig(**FOCAL_KW))
    jm = jlister.LISTER(jlister.LISTERConfig(variant="import_tiny",
                                             **LISTER_KW), policy=J_FP32)
    params = jck.import_lister(numpy_sd(sd), zeros_tree(
        jm.init, jnp.asarray(data["in_image"]),
        jnp.asarray(data["in_mask"]))["params"])
    port = LISTER(LISTER_CFG, policy=FP32_POLICY, device="cpu")
    assert_same_state(ck.import_lister(sd, port),
                      flax_state_dict(port, params))
    enc = FocalNet(FocalNetConfig(**FOCAL_KW), policy=FP32_POLICY,
                   device="cpu")
    assert_same_state(ck.import_focalnet(sd, enc),
                      flax_state_dict(enc, params["encoder"]))


# ---------------- errors ----------------


def test_wrong_variant_names_the_key_and_both_shapes(mgp_mirror):
    tm, *_ = mgp_mirror
    wide = MGPSTR(dataclasses.replace(MGP_CFG, vit=ViTConfig(
        embed_dim=64, depth=MGP.DEPTH, num_heads=MGP.HEADS)),
        policy=FP32_POLICY, device="cpu")
    with pytest.raises(ValueError, match=r"'encoder\.patch_embed\.proj\."
                       r"weight' has shape \(32, 3, 4, 4\) but the model "
                       r"expects \(64, 3, 4, 4\)"):
        ck.import_mgp_str(tm.state_dict(), wide)
    small = MGPSTR(dataclasses.replace(MGP_CFG, bpe_vocab_size=32,
                                       vocab_pad_multiple=32),
                   policy=FP32_POLICY, device="cpu")
    with pytest.raises(ValueError, match=r"'bpe_head\.weight' has shape "
                       r"\(64, 32\) but the model expects at most "
                       r"\(32, 32\)"):
        ck.import_mgp_str(tm.state_dict(), small)


def test_missing_and_unused_keys(mgp_mirror):
    tm, port, _ = mgp_mirror
    sd = dict(tm.state_dict())
    del sd["blocks.1.mlp.fc2.bias"]
    with pytest.raises(KeyError, match="blocks.1.mlp.fc2.bias"):
        ck.import_mgp_str(sd, port)
    sd = dict(tm.state_dict(), **{"extra_head.weight": torch.ones(2),
                                  "pe_buf.pe": torch.ones(2)})
    with pytest.warns(UserWarning, match=r"1 checkpoint tensors.*extra_head"):
        ck.import_mgp_str(sd, port)


# ---------------- golden replay through the port alone ----------------


def test_golden_mgp_str_replays():
    sd, data = golden("mgp_str")
    port = MGPSTR(MGP_CFG, policy=FP32_POLICY, device="cpu")
    ck.import_mgp_str(sd, port)
    with torch.no_grad():
        got = port(torch.from_numpy(data["in_image"]))
    rtol, atol = G.TOLERANCES["mgp_str"]
    for head in ("char", "bpe", "wp"):
        want = data[f"out_{head}"]
        np.testing.assert_allclose(got[head][..., :want.shape[-1]].numpy(),
                                   want, rtol=rtol, atol=atol, err_msg=head)


def test_golden_lore_replays():
    sd, data = golden("lore")
    port = DLASeg(DLA_CFG, policy=FP32_POLICY, device="cpu")
    ck.import_dla(sd, port)
    with torch.no_grad():
        got = port(torch.from_numpy(data["in_image"]))
    rtol, atol = G.TOLERANCES["lore"]
    for head in ("hm", "reg"):
        np.testing.assert_allclose(got[head].numpy(), data[f"out_{head}"],
                                   rtol=rtol, atol=atol, err_msg=head)


def test_golden_lister_replays():
    sd, data = golden("lister")
    port = LISTER(LISTER_CFG, policy=FP32_POLICY, device="cpu")
    ck.import_lister(sd, port)
    with torch.no_grad():
        got = port(torch.from_numpy(data["in_image"]),
                   torch.from_numpy(data["in_mask"]))
    rtol, atol = G.TOLERANCES["lister"]
    np.testing.assert_allclose(got[-1]["logits"].numpy(), data["out_logits"],
                               rtol=rtol, atol=atol)
