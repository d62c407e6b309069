"""The port's autotune table (``vlut_tpu_torch/bench/autotune.py``): the
cases of ``tests/test_autotune.py`` held on the H100 table's lookups, the
table ignored on another card and on the CPU, a route entry reaching
``ternary_matmul``, and the two routes of M <= 64 array-equal in their
plain versions (the same int8 codes and scales, the same int32
accumulator, the same epilogue)."""

import json

import numpy as np
import pytest
import torch

from vlut_tpu_torch.bench import autotune
from vlut_tpu_torch.ops import matmul as tmm
from vlut_tpu_torch.ops import ternary_gemm as tg
from vlut_tpu_torch.ops.packing import pack_ternary, padded_k

torch.set_num_threads(1)

CARD = "NVIDIA H100 80GB HBM3"


def _weights(k, n, fmt, seed):
    rng = np.random.default_rng(seed)
    trits = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    return pack_ternary(trits, rng.uniform(0.01, 0.1, n).astype(np.float32),
                        fmt)


@pytest.fixture
def table(tmp_path, monkeypatch):
    """A table on a card named CARD, this process on that card."""
    t = _weights(640, 256, "i2", 0)
    kp, np_ = t.packed.shape[0] * 4, t.packed.shape[1]
    entries = {
        "route:i2:16:4096:6144": "small",
        "route:i2:64:4096:6144": "tiled",
        "route:i2:48:14336:4096": "tiled",
        "i2:64:4096:6144": [64, 128, 2],
        f"route:i2:64:{kp}:{np_}": "tiled",
    }
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({"card": {"name": CARD, "sms": 132},
                                "entries": entries}))
    monkeypatch.setattr(autotune, "TABLE_FILE", path)
    monkeypatch.setattr(autotune, "device_name", lambda index: CARD)
    autotune.reset()
    yield t
    autotune.reset()


def test_route_rounds_m_up(table):
    # a query rounds up to the nearest tuned M of the same weight shape
    assert autotune.lookup_route("i2", 1, 4096, 6144) == "small"
    assert autotune.lookup_route("i2", 16, 4096, 6144) == "small"
    assert autotune.lookup_route("i2", 17, 4096, 6144) == "tiled"
    assert autotune.lookup_route("i2", 64, 4096, 6144) == "tiled"


def test_route_untuned_returns_none(table):
    # past the largest tuned M, another format or an unknown shape: None
    # (the caller keeps the small-M kernel)
    assert autotune.lookup_route("i2", 65, 4096, 6144) is None
    assert autotune.lookup_route("i1", 16, 4096, 6144) is None
    assert autotune.lookup_route("i2", 16, 9999, 6144) is None
    assert autotune.lookup_route("i2", 49, 14336, 4096) is None


def test_tiles_round_m_up_to_32(table, monkeypatch):
    assert autotune.lookup("i2", 33, 4096, 6144) == (64, 128, 2)
    assert autotune.lookup("i2", 64, 4096, 6144) == (64, 128, 2)
    assert autotune.lookup("i2", 32, 4096, 6144) is None
    assert autotune.lookup("i2", 65, 4096, 6144) is None
    # ternary_gemm.tiles takes the entry, else the plan
    assert tg.tiles(40, 6144, 4096, "i2", 0) == (64, 128, 2)
    monkeypatch.setattr(tg, "sm_count", lambda index: 132)
    assert tg.tiles(128, 6144, 4096, "i2", 0) == tg.tiled_plan(
        128, 6144, 4096, "i2", 132)


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", None])
def test_table_ignored_on_another_card(table, monkeypatch, name):
    monkeypatch.setattr(autotune, "device_name", lambda index: name)
    autotune.reset()
    assert autotune.load_table() == {}
    assert autotune.lookup("i2", 64, 4096, 6144) is None
    assert autotune.lookup_route("i2", 64, 4096, 6144) is None


def test_cpu_reads_no_table(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    autotune.reset()
    try:
        assert autotune.device_name(0) is None
        assert autotune.load_table() == {}
    finally:
        autotune.reset()


def _spy(monkeypatch, names):
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(tg, n)

        def call(*a, _fn=fn, _n=n, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tg, n, call)
    return calls


def test_route_entry_reaches_ternary_matmul(table, monkeypatch):
    """A "tiled" entry sends ternary_matmul at M <= 64 through quantize +
    #3, with the small-M route's result; ternary_matmul_fused keeps #1."""
    t = table
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 640)).astype(np.float32)).to(torch.bfloat16)
    calls = _spy(monkeypatch, ["ternary_gemm_tiled",
                               "ternary_gemm_fused_quant",
                               "ternary_gemm_decode"])
    routed = tmm.ternary_matmul(x, t)
    assert calls == {"ternary_gemm_tiled": 1, "ternary_gemm_fused_quant": 0,
                     "ternary_gemm_decode": 0}
    tmm.ternary_matmul_fused(x, t, mode="plain")
    assert calls["ternary_gemm_decode"] == 1
    assert calls["ternary_gemm_tiled"] == 1
    monkeypatch.setattr(autotune, "device_name", lambda index: "another")
    autotune.reset()
    small = tmm.ternary_matmul(x, t)
    assert calls["ternary_gemm_fused_quant"] == 1
    assert torch.equal(routed, small)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fmt", ["i2", "i1"])
def test_routes_array_equal_at_every_small_m(fmt, dtype):
    """quantize + #3 against #4 (plain versions) at M 1-64: the same
    codes, the scale ``amax * (1/127)`` of both, the same int32 sum and
    ``(acc * xs) * ws``, bit for bit."""
    k, n = 1000, 384
    t = _weights(k, n, fmt, 7)
    rng = np.random.default_rng(8)
    for m in range(1, 65):
        x = torch.from_numpy(
            (rng.standard_normal((m, k)) * rng.uniform(0.1, 30.0)).astype(
                np.float32)).to(dtype)
        small = tmm.ternary_matmul(x, t)
        tiled = tmm.ternary_matmul(x, t, impl="tiled")
        assert small.dtype == tiled.dtype == dtype
        assert torch.equal(small, tiled), m


def test_quantize_activations_scale_parts_from_the_kernels():
    """Why the tiled route at M <= 64 quantizes as #4 does: the unfused
    quantization divides amax by 127, the small-M kernels multiply by the
    float32 reciprocal, and the two scales part by an ulp on some rows."""
    from vlut_tpu_torch.ops.quant import quantize_activations

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4096, 64)).astype(np.float32))
    qa, sa = quantize_activations(x)
    qk, sk = tg.kernel_quantize(x)
    assert torch.equal(qa, qk)
    assert 0 < int((sa != sk).sum()) < 4096


def test_committed_table_is_well_formed():
    """``autotune_h100.json``: the card it was measured on, tile entries
    the kernel takes for their key's shape, routes of M <= 64, and each
    entry's measured times."""
    table = json.loads(autotune.TABLE_FILE.read_text())
    card = table["card"]
    assert card["name"] and card["sms"] > 0 and "W" in card["nvidia_smi"]
    for key, v in table["entries"].items():
        assert key in table["measured_us"]
        if key.startswith("route:"):
            _, fmt, m, kp, np_ = key.split(":")
            assert v in ("small", "tiled") and 1 <= int(m) <= 64
        else:
            fmt, m, kp, np_ = key.split(":")
            assert int(m) % 32 == 0
            assert tuple(v) in set(autotune.candidates(
                int(m), int(np_), int(kp), fmt, card["sms"]))
        assert fmt in ("i2", "i1") and int(kp) == padded_k(int(kp), fmt)
