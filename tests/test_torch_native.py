"""The port's host packer (``vlut_tpu_torch/convert/native.py`` over its own
``csrc/vlut_pack.cpp``) against the JAX package's ``native`` module and its
numpy ``pack_ternary``, bit for bit, and ``pack_ternary(k_mult=, n_mult=)``
and the CPU ``pack_weight`` against the JAX package's bytes."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert import native as jax_native
from vlut_tpu.models import transformer as jt
from vlut_tpu.ops import packing as jp
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert import native
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.models.dims import make_plan
from vlut_tpu_torch.ops import _build, packing

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _trits(k, n, seed):
    return np.random.default_rng(seed).integers(-1, 2, (k, n)).astype(np.int8)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("k,n", [(1300, 200), (640, 128), (100, 100)])
def test_native_pack_matches_numpy_and_torch(fmt, k, n):
    """The native route's bytes equal the JAX numpy pack's and the port's
    torch pack's."""
    trits = _trits(k, n, k + n)
    want = jp.pack_ternary(trits, 0.5, fmt, use_native=False)
    got = packing.pack_ternary(trits, 0.5, fmt, use_native=True)
    torch_pack = packing.pack_ternary(trits, 0.5, fmt)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    assert torch.equal(got.packed, torch_pack.packed)
    assert (got.k, got.n, got.kb, got.fmt) == (k, n, want.kb, fmt)
    assert got.scale.numpy() == np.float32(0.5)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
def test_native_unpack_roundtrip(fmt):
    trits = _trits(777, 160, 7)
    t = packing.pack_ternary(trits, 1.0, fmt, use_native=True)
    up = native.unpack(t.packed.numpy(), fmt, t.kb, t.k_padded)
    np.testing.assert_array_equal(up[: t.k, : t.n], trits)
    assert not up[t.k:].any() and not up[:, t.n:].any()


@pytest.mark.parametrize("shape,zeros", [((512, 96), 0.0), ((300, 77), 0.3)])
def test_native_ternarize_matches_jax_native(shape, zeros):
    """Trits equal and the scale bit-equal to the JAX package's library;
    the trits equal the port's numpy ``ternarize``."""
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[rng.random(shape) < zeros] = 0.0
    t1, s1 = native.ternarize_absmean(w)
    t2, s2 = jax_native.ternarize_absmean(w)
    np.testing.assert_array_equal(t1, t2)
    assert np.float32(s1).tobytes() == np.float32(s2).tobytes()
    np.testing.assert_array_equal(t1, packing.ternarize(w)[0])


def test_native_detect_ternary():
    """Its three answers: the magnitude of an exactly ternary matrix, 0.0
    for an all-zero one, -1.0 otherwise; as the JAX package's library."""
    rng = np.random.default_rng(4)
    trits = rng.integers(-1, 2, (64, 64)).astype(np.float32)
    for w, want in ((trits * 0.05, pytest.approx(0.05)),
                    (np.zeros((8, 8), np.float32), 0.0),
                    (rng.standard_normal((64, 64)).astype(np.float32), -1.0)):
        assert native.detect_ternary(w) == want
        assert native.detect_ternary(w) == jax_native.detect_ternary(w)


@pytest.mark.parametrize("fmt,k,n,k_mult,n_mult", [
    ("i2", 1300, 200, 512, None), ("i2", 640, 200, None, 512),
    ("i1", 3000, 130, 1280, 256), ("i1", 3000, 130, None, None),
    ("i1", 700, 100, 320, None)])
def test_pack_ternary_shard_padding_matches_jax(fmt, k, n, k_mult, n_mult):
    """``k_mult`` / ``n_mult`` pad as the JAX package's pack_ternary does
    (i1's 4 x 640 rule only where k_mult is None), by torch and natively."""
    trits = _trits(k, n, k * 3 + n)
    want = jp.pack_ternary(trits, 0.25, fmt, k_mult=k_mult, n_mult=n_mult)
    for use_native in (False, True):
        got = packing.pack_ternary(trits, 0.25, fmt, k_mult=k_mult,
                                   n_mult=n_mult, use_native=use_native)
        np.testing.assert_array_equal(got.packed.numpy(),
                                      np.asarray(want.packed))
        assert got.k_padded == want.k_padded


def test_native_route_refuses_trits_off_the_host():
    """A tensor on another device raises ValueError (a meta tensor stands
    in for the card's)."""
    with pytest.raises(ValueError, match="host"):
        packing.pack_ternary(torch.zeros((4, 4), dtype=torch.int8,
                                         device="meta"), use_native=True)
    with pytest.raises(ValueError, match="trits"):
        packing.pack_ternary(np.full((4, 4), 2, np.int8), use_native=True)


@pytest.mark.parametrize("fmt", ["i2", "i1"])
def test_pack_weight_on_the_cpu_is_jax_bytes_by_either_route(fmt):
    """``pack_weight`` of numpy trits, or of a CPU tensor, gives the JAX
    package's ``pack_weight`` bytes for every projection kind, padded heads
    and chunks included, and the native route over ``pad_weight``'s trits
    gives the same bytes (on the card pack_weight packs by torch there:
    chip_smoke.py phase 24 holds those bytes to these)."""
    over = dict(weight_fmt=fmt, head_dim=48)
    cfg_j = dataclasses.replace(JAX_PRESETS["tiny"], **over)
    cfg = dataclasses.replace(PRESETS["tiny"], **over)
    kb = make_plan(cfg).kb
    d, hd, hq, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d), "w_gate": (d, cfg.d_ff),
              "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}
    for i, (name, (k, n)) in enumerate(shapes.items()):
        trits = _trits(k, n, i)
        want = jt.pack_weight(name, trits, 0.5, cfg_j)
        got = tt.pack_weight(name, trits, 0.5, cfg)
        np.testing.assert_array_equal(got.packed.numpy(),
                                      np.asarray(want.packed))
        tensor = tt.pack_weight(name, torch.from_numpy(trits), 0.5, cfg)
        assert torch.equal(tensor.packed, got.packed)
        padded = tt.pad_weight(name, trits, cfg)
        nat = packing.pack_ternary(padded, 0.5, fmt, kb, use_native=True)
        assert torch.equal(nat.packed, got.packed)


_BUILD = ("import pathlib, sys; from vlut_tpu_torch.ops import _build; "
          "print(_build.build('vlut_pack.cpp', pathlib.Path(sys.argv[1])))")


def test_concurrent_builds_load_one_library(tmp_path):
    """Two processes building into one empty directory at once end with one
    whole library (each writes a temporary file and renames it), which
    packs as the numpy route does."""
    import ctypes

    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1]
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        pathlib.Path(outs[0]).name]
    assert pathlib.Path(outs[0]) == _build._lib_path(native.SOURCE, tmp_path)
    lib = ctypes.CDLL(outs[0])
    trits = np.zeros((128, 128), np.int8)
    trits[::3] = 1
    out = np.empty((32, 128), np.uint8)
    lib.vlut_pack_i2(trits.ctypes.data_as(ctypes.c_void_p),
                     out.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int64(128), ctypes.c_int64(128),
                     ctypes.c_int64(128))
    np.testing.assert_array_equal(
        out, np.asarray(jp.pack_ternary(trits, 1.0, "i2").packed))


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    """A compiler failure raises RuntimeError with the compiler's output;
    nothing falls back to numpy."""
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / native.SOURCE).write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", bad)
    with pytest.raises(RuntimeError, match="failed for vlut_pack.cpp"):
        _build.build(native.SOURCE, tmp_path / "build")
    assert not any((tmp_path / "build").iterdir())


def test_host_library_name_follows_the_cpu(monkeypatch):
    """The host library is built for the host's CPU (-march=native), so a
    build directory carried to another CPU builds its own library and
    loads none made for another."""
    here = _build._lib_path(native.SOURCE)
    assert _build._host_cpu() and here.name.startswith("vlut_pack-")
    monkeypatch.setattr(_build, "_host_cpu", lambda: "another cpu")
    assert _build._lib_path(native.SOURCE) != here
    # the CUDA libraries are built for the card and keep their names
    cuda = _build._lib_path("kv_update.cu")
    monkeypatch.undo()
    assert _build._lib_path("kv_update.cu") == cuda
