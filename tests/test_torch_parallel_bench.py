"""``bench/mesh.py``, the checks of ``chip_smoke.py`` phase 29, on the CPU
at tiny sizes (two gloo ranks, one spawn for the sound cases).

Each reading must lie within the limit the card holds it to
(``bench/mesh.py``: ``PREFILL_TOL``, ``LAYER_TOL``, ``ATTN_TOL``), and
each wiring fault of ``bench/mesh.py:FAULTS``, run in a copy of the
checkout that holds it, must read past its limit (phase 30's
``copy_to_sum`` past ``TRAIN_UPDATE_RTOL``).
"""

import pytest

from vlut_tpu_torch.bench import mesh
from vlut_tpu_torch.parallel.distributed import launch

SERVE = dict(preset="tiny", n_layers=2, dp=1, tp=2, n_slots=4, ctx=64,
             prompt_len=16, new_tokens=6, device="cpu")
SERVE_MOE = {**SERVE, "preset": "tiny_moe", "single": False}
SP = dict(preset="tiny", n_layers=2, b=2, t=32, device="cpu")
PP = dict(preset="tiny", n_layers=2, b=4, t=16, device="cpu")
CASES = [("serve_rank", SERVE), ("serve_rank", SERVE_MOE), ("sp_rank", SP),
         ("pp_rank", PP)]
FAULT_CASES = {"shard_max_scale": ("serve_rank", {**SERVE, "new_tokens": 2,
                                                  "single": False}),
               "ring_positions_kept": ("sp_rank", SP),
               "copy_to_sum": ("train_rank", dict(
                   preset="tiny", n_layers=None, b=2, t=16, n_slots=4,
                   ctx=64, prompt_len=16, new_tokens=4, device="cpu"))}


@pytest.fixture(scope="module")
def ranks():
    return launch("vlut_tpu_torch.bench.mesh:run_cases", (CASES,),
                  nprocs=2, backend="gloo", timeout=300)


def _within(e: dict) -> bool:
    return e["max_abs_err"] <= mesh.PREFILL_TOL * e["max_abs_logit"]


@pytest.mark.parametrize("i", [0, 1], ids=["dense_tp2", "moe_ep2"])
def test_serve_rank_steps_within_limits(ranks, i):
    res = ranks[0][i]
    assert _within(res["prefill_logits"]) and _within(res["step_logits"])
    assert res["step_layer_rel_err"] <= mesh.LAYER_TOL
    assert res["decode_steps"] == SERVE["new_tokens"] - 1
    assert res["timed_steps"] == res["decode_steps"] - mesh.WARM_STEPS
    assert res["ms_per_step"] > 0
    assert ranks[1][i] == {"rank": 1, "launches": ranks[1][i]["launches"]}


def test_serve_rank_times_the_single_device_engine(ranks):
    res = ranks[0][0]
    assert res["single_ms_per_step"] > 0 and res["single_tokens_equal"] == 1


@pytest.mark.parametrize("rank", [0, 1])
def test_sp_rank_layer_by_layer_within_limits(ranks, rank):
    res = ranks[rank][2]
    assert res["attn_rel_err"] <= mesh.ATTN_TOL
    assert res["layer_rel_err"] <= mesh.LAYER_TOL
    assert _within(res["held_logits"]) and _within(res)


@pytest.mark.parametrize("rank", [0, 1])
def test_pp_rank_within_limits(ranks, rank):
    assert _within(ranks[rank][3])


@pytest.mark.parametrize("name", sorted(FAULT_CASES))
def test_each_fault_reads_past_its_limit(name, monkeypatch):
    path, text, broken, _ = mesh.FAULTS[name]
    monkeypatch.setitem(mesh.FAULTS, name,
                        (path, text, broken, FAULT_CASES[name]))
    res = mesh.fault_readings(name, timeout=300)
    if name == "shard_max_scale":
        assert res["step_layer_rel_err"] > mesh.LAYER_TOL
        assert not _within(res["prefill_logits"])
    elif name == "copy_to_sum":
        errs = res["leaf_errors"]
        assert res["loss_rel_err"] <= mesh.TRAIN_LOSS_RTOL
        assert errs["lm_head"]["update_rel_err"] <= mesh.TRAIN_UPDATE_RTOL
        # tiny's 256 tokens lie in rank 0's half of its 512 padded head
        # columns, so the final norm's gradient reaches rank 0 whole even
        # so; every layer's leaves, upstream of a column shard, do not
        for kind in ("embed", "attn_norm", "wq", "w_down", "ffn_norm"):
            assert errs[kind]["update_rel_err"] > mesh.TRAIN_UPDATE_RTOL
    else:
        assert res["attn_rel_err"] > mesh.ATTN_TOL
        assert res["layer_rel_err"] > mesh.LAYER_TOL
        assert not _within(res)
