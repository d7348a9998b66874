"""CPU checks of what surrounds the port's CUDA kernels: the build cache key,
loading and counting from many threads, the weight packing the
deformable-conv wrapper does for TMA, and the device default of the batch
helpers. No nvcc and no card are needed."""

import collections
import shutil
import threading
import types

import numpy as np
import pytest
import torch

from advancedliteratemachinery_tpu_torch.engine import batches
from advancedliteratemachinery_tpu_torch.ops import _kernels
from advancedliteratemachinery_tpu_torch.ops.deform_conv import (
    bilinear_gather, deform_conv2d_plain, pack_weights)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, dst)
    monkeypatch.setattr(_kernels, "CSRC", dst)
    return dst


@pytest.mark.parametrize("name,headers", [
    ("vocab_greedy_decode", ["sm90_common.cuh"]),
    ("deform_conv", ["sm90_common.cuh"]),
    ("fused_qkv_attention", ["sm90_attention.cuh", "sm90_common.cuh"]),
    ("fused_qkv_attention_bwd", ["sm90_attention.cuh", "sm90_common.cuh"]),
    ("mha_short_seq", ["sm90_attention.cuh", "sm90_common.cuh"])])
def test_lib_path_follows_included_header(csrc_copy, name, headers):
    sources = [p.name for p in _kernels._sources(csrc_copy
                                                 / _kernels.SOURCES[name])]
    assert sources == [_kernels.SOURCES[name], *headers]
    before = _kernels._lib_path(name)
    assert _kernels._lib_path(name) == before          # stable
    header = csrc_copy / "sm90_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _kernels._lib_path(name) != before


def test_lib_path_ignores_headers_a_source_does_not_include(csrc_copy):
    """K2 and K3 include the common header but not the attention core."""
    names = ("vocab_greedy_decode", "deform_conv")
    before = {n: _kernels._lib_path(n) for n in names}
    header = csrc_copy / "sm90_attention.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert {n: _kernels._lib_path(n) for n in names} == before


def test_attention_core_edit_rebuilds_k1_and_k5_only(csrc_copy):
    """An edit of the attention core rebuilds the kernels on it and no
    other: K1, K5 and, since it moved onto the core, K4."""
    names = list(_kernels.SOURCES)
    before = {n: _kernels._lib_path(n) for n in names}
    header = csrc_copy / "sm90_attention.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    changed = {n for n in names if _kernels._lib_path(n) != before[n]}
    assert changed == {"fused_qkv_attention", "fused_qkv_attention_bwd",
                       "mha_short_seq"}


@pytest.mark.parametrize("cin,cout", [(5, 7), (8, 3), (13, 16)])
def test_pack_weights_pads_cin_to_8(cin, cout):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout))
                         .astype(np.float32))
    packed = pack_weights(w)
    cin8 = -(-cin // 8) * 8
    assert packed.shape == (9, cout, cin8) and packed.is_contiguous()
    assert torch.equal(packed[..., :cin],
                       w.permute(0, 1, 3, 2).reshape(9, cout, cin))
    assert not packed[..., cin:].any()


def test_packed_weights_give_the_unpadded_plain_result():
    """The kernel's arithmetic on packed weights (per tap, the mask-scaled
    bilinear sample with channels zero-padded to Cin8, contracted with the
    tap's [Cout, Cin8] rows) equals the plain version on the unpadded
    weights."""
    rng = np.random.default_rng(1)
    B, H, W, cin, cout = 1, 6, 7, 5, 3
    x = torch.from_numpy(rng.standard_normal((B, H, W, cin))
                         .astype(np.float32))
    off = torch.from_numpy(rng.uniform(-2.5, 2.5, (B, H, W, 9, 2))
                           .astype(np.float32))
    mask = torch.from_numpy(rng.uniform(0, 1, (B, H, W, 9))
                            .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout))
                         .astype(np.float32))
    packed = pack_weights(w)
    ys = torch.arange(H, dtype=torch.float32)[:, None, None] - 1 + (
        torch.arange(9) // 3).float() + off[..., 0]
    xs = torch.arange(W, dtype=torch.float32)[None, :, None] - 1 + (
        torch.arange(9) % 3).float() + off[..., 1]
    got = torch.zeros(B, H, W, cout)
    for k in range(9):
        sample = bilinear_gather(x, ys[..., k], xs[..., k]) * mask[..., k,
                                                                   None]
        sample = torch.nn.functional.pad(sample, (0, packed.shape[-1] - cin))
        got += sample @ packed[k].t()
    want = deform_conv2d_plain(x, off, mask, w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_batch_helpers_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = {"images": np.zeros((2, 4, 4, 3), np.uint8)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batches.to_device(batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batches.prefetch_batches(iter([batch]))
    assert batches.to_device(batch, "cpu")["images"].device.type == "cpu"


def test_threads_load_a_kernel_once_and_lose_no_count(monkeypatch):
    """Eight threads asking for one entry point while its library loads
    (slowly, as nvcc builds) get one function, built and loaded once; their
    counts all land."""
    calls = collections.Counter()

    def build(names):
        calls["build"] += 1
        threading.Event().wait(0.05)

    def cdll(path):
        calls["load"] += 1
        return types.SimpleNamespace(alm_error_string=types.SimpleNamespace(),
                                     alm_entry=types.SimpleNamespace())

    monkeypatch.setattr(_kernels, "build", build)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_kernels, "_lib_path", lambda name: name)
    monkeypatch.setattr(_kernels, "_LIBS", {})
    monkeypatch.setattr(_kernels, "_FUNCS", {})
    monkeypatch.setattr(_kernels, "LAUNCHES", collections.Counter())
    fns = []

    def launch():
        for _ in range(2000):
            fns.append(_kernels.kernel_function("k", "alm_entry", [int]))
            _kernels.count("k")

    threads = [threading.Thread(target=launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == {"build": 1, "load": 1}
    assert len({id(f) for f in fns}) == 1 and fns[0].argtypes == [int]
    assert _kernels.LAUNCHES == {"k": 16000}
