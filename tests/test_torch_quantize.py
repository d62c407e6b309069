"""i2 <-> i1 requantization, checkpoint writing and ``unpack_weight`` of the
port against the JAX package on the CPU (tests/fixtures/tiny_real and the
tiny presets).  Everything here is exact: packed bytes, scales and greedy
tokens must be identical."""

import contextlib
import dataclasses
import io
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.convert.checkpoint import save_checkpoint as jax_save
from vlut_tpu.convert.quantize import requantize_params as jax_requantize
from vlut_tpu.models import transformer as jt
from vlut_tpu.ops.packing import TernaryTensor as JaxTernaryTensor
from vlut_tpu_torch import cli
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import load_checkpoint, save_checkpoint
from vlut_tpu_torch.convert.quantize import requantize, requantize_params
from vlut_tpu_torch.models.dims import chunk_positions, make_plan
from vlut_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"


def _as_np(t):
    if torch.is_tensor(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for name in want:
        a, b = _as_np(got[name]), _as_np(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def tiny_real():
    cfg_j, params_j, _ = jax_load(TINY_REAL, stream=False)
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    return cfg_j, params_j, cfg, model


def test_requantize_i1_bytes_equal_jax_and_roundtrip(tiny_real):
    """Packed bytes and scales equal the JAX package's.  The sub-norm gains
    differ on purpose: the port lays them out for the i1 plan (wider chunk
    padding), the JAX package keeps the i2 layout, which its own i1 forward
    cannot broadcast; the logical gains are the same."""
    cfg_j, params_j, cfg, model = tiny_real
    cfg1_j, p1_j = jax_requantize(cfg_j, params_j, "i1")
    cfg1, p1 = requantize_params(cfg, model, "i1")
    assert cfg1.weight_fmt == cfg1_j.weight_fmt == "i1"
    subs = ("attn_sub_norm", "ffn_sub_norm")
    _assert_trees_equal(
        {**p1, "layers": {k: v for k, v in p1["layers"].items()
                          if k not in subs}},
        {**p1_j, "layers": {k: v for k, v in p1_j["layers"].items()
                            if k not in subs}})
    plan0, plan1 = make_plan(cfg), make_plan(cfg1)
    for name, n, chunk, old, new, width in (
            ("attn_sub_norm", plan0.q_dim_p, plan0.wo_chunk,
             plan0.wo_chunk_p, plan1.wo_chunk_p, plan1.wo_in_p),
            ("ffn_sub_norm", cfg.d_ff, plan0.ff_chunk, plan0.ff_chunk_p,
             plan1.ff_chunk_p, plan1.ff_p)):
        got = p1["layers"][name].numpy()
        assert got.shape == (cfg.n_layers, width) and width > n
        src = np.asarray(p1_j["layers"][name])
        np.testing.assert_array_equal(got[:, chunk_positions(n, chunk, new)],
                                      src[:, chunk_positions(n, chunk, old)])
        assert np.count_nonzero(got) == np.count_nonzero(src)
    # i1 -> i2 gives back the original bytes and gains
    cfg2, p2 = requantize_params(cfg1, p1, "i2")
    assert cfg2 == cfg
    _assert_trees_equal(p2, model.tree())


def test_save_checkpoint_loads_in_jax(tiny_real, tmp_path):
    cfg_j, params_j, cfg, model = tiny_real
    save_checkpoint(tmp_path / "ck", cfg, model, tokenizer_src=TINY_REAL,
                    extra_meta={"note": "port"})
    cfg2, params2, meta = jax_load(tmp_path / "ck", stream=False)
    assert cfg2 == cfg_j and meta["note"] == "port"
    _assert_trees_equal(params2, params_j)
    assert (tmp_path / "ck" / "tokenizer.json").read_bytes() == (
        TINY_REAL / "tokenizer.json").read_bytes()
    # and the port reads back what it wrote
    _, model2, _ = load_checkpoint(tmp_path / "ck", device="cpu")
    _assert_trees_equal(model2.tree(), model.tree())


def test_jax_checkpoint_of_unrolled_tree_round_trips(tmp_path):
    """A JAX-saved checkpoint loads in the port, and the port saves an
    unrolled (per-layer) tree stacked back, as checkpoints keep it."""
    cfg_j = JAX_PRESETS["tiny_bitnet"]
    params = jax.tree.map(np.asarray, jt.init_params(cfg_j, seed=3))
    jax_save(tmp_path / "j", cfg_j, params)
    cfg, model, _ = load_checkpoint(tmp_path / "j", device="cpu")
    _assert_trees_equal(model.tree(), params)
    unrolled = tt.unstack_layers(model, cfg)
    save_checkpoint(tmp_path / "p", cfg, unrolled)
    _, params2, _ = jax_load(tmp_path / "p", stream=False)
    _assert_trees_equal(params2, params)


def test_requantized_model_gives_the_same_greedy_tokens(tmp_path):
    requantize(TINY_REAL, tmp_path / "i1", "i1")
    meta = json.loads((tmp_path / "i1" / "vlut_config.json").read_text())
    assert meta["requantized_from"] == str(TINY_REAL)
    ids = [2] + list(b"The little model")
    toks = []
    for path in (TINY_REAL, tmp_path / "i1"):
        cfg, model, _ = load_checkpoint(path, device="cpu")
        toks.append(cli.run_batched(model, cfg, ids, 2, 10, temp=0.0))
    assert cfg.weight_fmt == "i1"
    assert torch.equal(toks[0], toks[1])
    with pytest.raises(ValueError, match="already"):
        requantize(tmp_path / "i1", tmp_path / "again", "i1")


@pytest.mark.parametrize("fmt", ["i2", "i1"])
@pytest.mark.parametrize("name", ["tiny", "tiny_bitnet"])
def test_unpack_weight_inverts_pack_weight(name, fmt):
    cfg = dataclasses.replace(PRESETS[name], weight_fmt=fmt)
    cfg_j = dataclasses.replace(JAX_PRESETS[name], weight_fmt=fmt)
    rng = np.random.default_rng(0)
    logical = {"wq": (cfg.d_model, cfg.q_dim), "wk": (cfg.d_model, cfg.kv_dim),
               "wv": (cfg.d_model, cfg.kv_dim), "wo": (cfg.q_dim, cfg.d_model),
               "w_gate": (cfg.d_model, cfg.d_ff),
               "w_up": (cfg.d_model, cfg.d_ff),
               "w_down": (cfg.d_ff, cfg.d_model)}
    for proj, shape in logical.items():
        trits = rng.integers(-1, 2, size=shape, dtype=np.int8)
        t = tt.pack_weight(proj, trits, np.float32(0.5), cfg)
        back = tt.unpack_weight(proj, t, cfg)
        assert back.dtype == np.int8
        np.testing.assert_array_equal(back, trits, err_msg=proj)
        jt_t = JaxTernaryTensor(packed=t.packed.numpy(), scale=np.float32(0.5),
                                k=t.k, n=t.n, fmt=fmt, kb=t.kb)
        np.testing.assert_array_equal(jt.unpack_weight(proj, jt_t, cfg_j),
                                      back, err_msg=proj)


def test_moe_stack_raises():
    cfg = PRESETS["tiny"]
    tree = tt.init_params(cfg, seed=0).tree()
    layers = dict(tree["layers"])
    layers["w_gate"] = {"packed": layers["w_gate"]["packed"][:, None],
                        "scale": layers["w_gate"]["scale"][:, None]}
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        requantize_params(cfg, {**tree, "layers": layers}, "i1")


def test_quantize_and_inspect_cli(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["quantize", str(TINY_REAL), str(tmp_path / "q"), "--fmt",
                  "i1"])
        cli.main(["inspect", str(tmp_path / "q"), "--hash"])
    text = out.getvalue()
    assert "requantized ->" in text and '"requantized_from"' in text
    assert "layers.wq.packed" in text and "model digest:" in text
