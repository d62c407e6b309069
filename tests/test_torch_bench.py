"""The port's benchmark tools on the CPU: the kernel microbenchmark's lanes,
the end-to-end sweeps at a tiny size, and their output formats against the
JAX package's.  CPU timings are not measurements; these tests check keys,
shapes, codes and control flow."""

import contextlib
import io
import json

import pytest
import torch

from vlut_tpu.bench.e2e import format_rows as jax_format_rows
from vlut_tpu_torch.bench import e2e, kernels
from vlut_tpu_torch.ops import tq
from vlut_tpu_torch.ops.packing import DEFAULT_BLOCK, unpack_fields

torch.set_num_threads(1)

# the keys of vlut_tpu/bench/kernels.py::bench_gemm's result
JAX_GEMM_KEYS = {"fmt", "m", "k", "n", "blocks", "us", "gbps_packed", "tflops"}
SWEEP_KEYS = ["model", "test", "batch", "n_tokens", "time_s", "tok_per_s"]
BATCHED_KEYS = ["PP", "TG", "B", "N_KV", "T_s", "S_t/s"]


@pytest.mark.parametrize("fmt", ["i2", "i1", "tq2", "tq1"])
def test_bench_gemm_lanes(fmt):
    out = kernels.bench_gemm(fmt, 3, 512, 128, repeats=1, device="cpu")
    assert set(out) == JAX_GEMM_KEYS
    assert (out["fmt"], out["m"], out["k"], out["n"]) == (fmt, 3, 512, 128)
    assert out["us"] > 0 and out["gbps_packed"] > 0 and out["tflops"] > 0
    want_blocks = ((64, 32, 512) if fmt.startswith("tq")
                   else (128, 128, DEFAULT_BLOCK[fmt]))
    assert out["blocks"] == want_blocks


@pytest.mark.parametrize("fmt", ["i2", "i1", "tq2", "tq1"])
def test_random_packed_codes_are_valid(fmt):
    gen = torch.Generator().manual_seed(0)
    p = kernels.rand_packed(fmt, 1000, 64, gen, "cpu")
    if fmt == "tq2":
        assert p.shape == (4 * 64, 64)
        assert int(tq.tq_trits(p, fmt).max()) <= 1
        fields = torch.stack([(p.int() >> (2 * q)) & 3 for q in range(4)])
        assert int(fields.max()) == 2
    elif fmt == "tq1":
        rows = p.reshape(4, 52, 64).int()
        assert int(rows[:, :48].max()) == 242 and int(rows[:, 48:].max()) <= 80
    elif fmt == "i2":
        assert int(unpack_fields(p, fmt, DEFAULT_BLOCK[fmt]).max()) == 2
    else:
        assert int(p.max()) <= 242
    again = kernels.rand_packed(fmt, 1000, 64,
                                torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p, again)


def test_kernels_main_table_and_word_flag():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = kernels.main(["-m", "falcon_1b", "-ns", "2", "--fmt", "tq2,i1",
                             "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].split() == ["model", "gemm", "fmt", "M", "us", "GB/s",
                                "TFLOP/s"]
    assert len(lines) == 1 + 3 * 2 and len(rows) == 6
    assert [(r["gemm"], r["fmt"]) for r in rows[:2]] == [("dxd", "tq2"),
                                                        ("dxd", "i1")]
    assert (rows[-1]["k"], rows[-1]["n"]) == (8192, 2048)
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        kernels.main(["--word", "--device", "cpu"])


ROWS = [
    {"model": "m", "test": "pp512", "batch": 1, "n_tokens": 512,
     "time_s": 0.0123, "tok_per_s": 41626.02},
    {"model": "m", "test": "tg128", "batch": 32, "n_tokens": 4096,
     "time_s": 1.5, "tok_per_s": 2730.67},
]


@pytest.mark.parametrize("fmt", ["md", "csv", "json"])
def test_format_rows_matches_jax(fmt):
    assert e2e.format_rows(ROWS, fmt) == jax_format_rows(ROWS, fmt)
    assert e2e.format_rows([], fmt) == jax_format_rows([], fmt) == ""


def test_bench_sweep_and_batched_bench_on_tiny():
    rows = e2e.bench_sweep(preset="tiny", n_prompt=(8,), n_gen=(3,),
                           batch=(1, 2), repeats=1, device="cpu", n_layers=1)
    assert [r["test"] for r in rows] == ["pp8", "tg3", "pp8", "tg3"]
    assert all(list(r) == SWEEP_KEYS for r in rows)
    assert [r["n_tokens"] for r in rows] == [8, 3, 16, 6]
    rows = e2e.batched_bench(preset="tiny", npp=(6,), ntg=(2,), npl=(2,),
                             device="cpu", n_layers=1, impl="dequant")
    assert len(rows) == 1 and list(rows[0]) == BATCHED_KEYS
    assert rows[0]["N_KV"] == 2 * (6 + 2)


def test_e2e_cli_json_output():
    from vlut_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["bench-sweep", "--preset", "tiny", "--layers", "1", "-p",
                  "4", "-n", "2", "-r", "1", "-o", "json", "--device", "cpu"])
    rows = json.loads(out.getvalue())
    assert [r["test"] for r in rows] == ["pp4", "tg2"]
