"""Slot save / restore under ``Engine(mesh=)`` against the JAX package's
engines on the CPU.

The port's engine serves tiny_real in two gloo ranks, at tp 2 and at dp 2
(``tests/_torch_parallel.py``: ``slot_save`` then ``slot_restore``): slot
1 serves a prompt and is saved, then continued uninterrupted; fresh
engines restore saved files into slot 1 and continue the same history.
The JAX engines (single-device, tp 2 and dp 2 meshes of the conftest's
virtual CPU devices, ``impl="pallas_interpret"``, unfused as a mesh
serves) restore the same files in this process.  The file is the same
whatever the mesh: every KV head in global order (a tp rank's block of
heads after another's), from the dp group that holds the slot.
"""

import functools
import io
import pathlib

import numpy as np
import pytest
import torch

from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.parallel.sharding import make_mesh
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.parallel.distributed import launch
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

import _torch_parallel as worker

torch.set_num_threads(1)

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
TP2, DP2 = "dp1tp2", "dp2tp1"


def _arrays(data: bytes) -> dict:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def _jax_request(prompt):
    return JaxRequest(prompt=prompt, max_new_tokens=6,
                      sampler=JaxSampler(temperature=0.0))


def _jax_continue(eng, hist):
    r = _jax_request(hist + worker.SLOT_MORE)
    eng.run([r])
    return r.output


@functools.cache
def _jax_engine(dp: int, tp: int):
    cfg, params, _ = jax_load(TINY_REAL)
    mesh = make_mesh(dp=dp, tp=tp) if dp * tp > 1 else None
    return JaxEngine(cfg, params, n_slots=2, max_len=256,
                     impl="pallas_interpret", fuse=False, mesh=mesh)


@functools.cache
def _jax_saved():
    """The JAX single-device engine's saved slot 1 (after the same two
    requests as the port's ranks) and its uninterrupted continuation."""
    eng = _jax_engine(1, 1)
    eng.run([_jax_request(worker.SLOT_OTHER),
             _jax_request(worker.SLOT_PROMPT)])
    data = eng.save_slot(1)
    return data, _jax_continue(eng, list(eng.slots[1].history))


def _jax_restored(dp: int, tp: int, data: bytes):
    """A JAX engine restores ``data`` into slot 1 and continues it: (its
    continuation, the slot saved again)."""
    eng = _jax_engine(dp, tp)
    eng.restore_slot(1, data)
    again = eng.save_slot(1)
    return _jax_continue(eng, list(eng.slots[1].history)), again


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jax_file = _jax_saved()[0]
    cases = [("slot_save", (1, 2)), ("slot_save", (2, 1)),
             ("slot_restore", (1, 2, {TP2: None, DP2: None,
                                      "jax": jax_file})),
             ("slot_restore", (2, 1, {DP2: None, TP2: None})),
             ("slot_moe", ())]
    out = launch("_torch_parallel:run_cases", (cases,), nprocs=2,
                 timeout=300, folder=tmp_path_factory.mktemp("slots"))
    return {"save": {TP2: [r[0] for r in out], DP2: [r[1] for r in out]},
            "restore": {TP2: out[0][2], DP2: out[0][3]}, "moe": out[0][4]}


def test_file_holds_the_ranks_heads_bit_for_bit(ranks):
    """tp 2: the file's K/V rows are rank 0's heads then rank 1's, bit for
    bit; dp 2: they are those of rank 1, whose dp group holds slot 1."""
    tp_ranks, dp_ranks = ranks["save"][TP2], ranks["save"][DP2]
    for mesh, want in ((TP2, lambda k, i, n: np.concatenate(
            [r["local"][k][i][:n] for r in tp_ranks], axis=1)),
                       (DP2, lambda k, i, n: dp_ranks[1]["local"][k][i][:n])):
        arrays = _arrays(ranks["save"][mesh][0]["saved"])
        n = len(arrays["tokens"])
        assert n == len(worker.SLOT_PROMPT) + 5
        for k in ("k", "v"):
            got = arrays[f"kv_{k}"]
            assert got.shape[2] == 2  # tiny_real's KV heads, whole
            for i in range(got.shape[0]):
                assert got[i].tobytes() == want(k, i, n).tobytes(), (mesh, k)
    assert dp_ranks[0]["local"] is None


@pytest.mark.parametrize("mesh", [TP2, DP2])
def test_restore_continues_as_uninterrupted(ranks, mesh):
    """A fresh engine on the same mesh restores the file and continues the
    history with the uninterrupted run's tokens, reusing every row."""
    saved = ranks["save"][mesh][0]
    got, reused, _ = ranks["restore"][mesh][mesh]
    assert (got, reused) == tuple(saved["cont"])
    assert reused == len(_arrays(saved["saved"])["tokens"])


def test_restored_slot_reads_back_bit_for_bit(ranks):
    """Every file restored on either mesh is saved again from the ranks'
    caches bit for bit: each rank wrote its own block of the heads."""
    files = {TP2: ranks["save"][TP2][0]["saved"],
             DP2: ranks["save"][DP2][0]["saved"], "jax": _jax_saved()[0]}
    for mesh in (TP2, DP2):
        for name, (_, _, again) in ranks["restore"][mesh].items():
            want, got = _arrays(files[name]), _arrays(again)
            assert set(got) == set(want)
            for k in want:
                assert got[k].tobytes() == want[k].tobytes(), (mesh, name, k)


def test_moe_mesh_slot_keeps_whole_heads(ranks):
    """Under a MoE model's ep (the tp axis carries experts, every rank
    holds every KV head) the file holds the model's KV heads once, and a
    restore reads back bit for bit."""
    saved, again = (_arrays(f) for f in ranks["moe"])
    assert saved["kv_k"].shape[2] == 2
    for k in saved:
        assert again[k].tobytes() == saved[k].tobytes(), k


def test_restored_continuations_equal_jax_mesh_engines(ranks):
    """Each file restored into a mesh of the other package, and into the
    other mesh: the port's tp 2 engine continues the tp 2 file, the dp 2
    file and the JAX single-device engine's file as the JAX tp 2 engine
    does; the port's dp 2 engine continues the tp 2 file as the JAX dp 2
    engine does."""
    files = {TP2: ranks["save"][TP2][0]["saved"],
             DP2: ranks["save"][DP2][0]["saved"], "jax": _jax_saved()[0]}
    for name in (TP2, DP2, "jax"):
        assert ranks["restore"][TP2][name][0] == _jax_restored(
            1, 2, files[name])[0], name
    assert ranks["restore"][DP2][TP2][0] == _jax_restored(2, 1,
                                                          files[TP2])[0]


def test_mesh_file_restores_into_one_device(ranks):
    """The tp 2 file into a single-device engine of either package: the
    slot reads back bit-equal and both continue alike; the JAX engine's
    file into the port's single-device engine continues as the JAX
    engine's uninterrupted run did."""
    data = ranks["save"][TP2][0]["saved"]
    want = _arrays(data)
    jax_cont, jax_again = _jax_restored(1, 1, data)
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    eng = Engine(cfg, model, n_slots=2, max_len=256)
    for name, blob, cont in (("tp2", data, jax_cont),
                             ("jax", *_jax_saved())):
        eng.restore_slot(1, blob)
        if name == "tp2":
            for again in (_arrays(eng.save_slot(1)), _arrays(jax_again)):
                assert set(again) == set(want)
                for k in want:
                    assert again[k].tobytes() == want[k].tobytes(), k
        req = Request(prompt=list(eng.slots[1].history) + worker.SLOT_MORE,
                      max_new_tokens=6,
                      sampler=SamplerParams(temperature=0.0))
        eng.run([req])
        assert req.output == cont, name
