"""The dense zoo through the port's runtime on the CPU, against the JAX
package where it is right:

* the slot engine's greedy tokens equal the JAX engine's (its projections
  in interpret mode, as tests/test_torch_engine.py explains) for a
  sliding-window model with softcaps (tiny_gemma2), a rolling-window model
  without them (the fused decode attention with its window), and a
  LayerNorm / parallel-residual / partial-rope / biased model;
* a context shift rotates each layer's keys as a fresh prefill of the kept
  tokens at their new positions writes them, for a partial-rope, a NoPE,
  an ALiBi and a local-rope-base model.  Layer 0's keys are compared (a
  deeper layer's keys depend on the dropped context); each config puts
  the kind under test at layer 0;
* ``--promote i1`` / ``requantize`` of a gemma2-style and a gptneox-style
  model give the i2 model's greedy tokens;
* ``generate`` and ``serve`` of a converted checkpoint of such a model
  give the JAX package's tokens.
"""

import contextlib
import dataclasses
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import ENGINE_KW, _workload
from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.convert.checkpoint import save_checkpoint as jax_save
from vlut_tpu.models import transformer as jt
from vlut_tpu.ops.rope import rope_table as jax_rope_table
from vlut_tpu.runtime import kv_cache as jax_kv
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu.serving.server import serve as jax_serve
from vlut_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from vlut_tpu_torch import cli
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.convert.quantize import promote, requantize
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.runtime import kv_cache as kvc
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams
from vlut_tpu_torch.serving import server as port_server

torch.set_num_threads(1)

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
LN_PARALLEL = dict(norm_type="ln", parallel_residual=True, rope_pct=0.25,
                   ffn_gated=False, act_fn="gelu_exact", proj_bias=True)
MODELS = {
    "gemma2": ("tiny_gemma2", {}),
    "swa": ("tiny", dict(sliding_window=8, sliding_window_pattern=2)),
    "ln_parallel": ("tiny", LN_PARALLEL),
}


def _cfgs(name):
    preset, change = MODELS[name]
    return (dataclasses.replace(JAX_PRESETS[preset], **change),
            dataclasses.replace(PRESETS[preset], **change))


@pytest.mark.parametrize("name", list(MODELS))
def test_engine_matches_jax(name):
    cfg_j, cfg = _cfgs(name)
    params = jt.init_params(cfg_j, seed=0)
    je = JaxEngine(cfg_j, params, impl="pallas_interpret", **ENGINE_KW)
    want = [JaxRequest(sampler=JaxSampler(temperature=0.0), **kw)
            for kw in _workload(cfg.vocab_size)]
    je.run(want)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    eng = Engine(cfg, model, decode_attn="fused", **ENGINE_KW)
    got = [Request(sampler=SamplerParams(temperature=0.0), **kw)
           for kw in _workload(cfg.vocab_size)]
    eng.run(got)
    assert [r.output for r in got] == [r.output for r in want]
    assert eng.perf.n_reused_tokens == je.perf.n_reused_tokens


# kind -> config changes of ``tiny`` that put it at layer 0
SHIFT_KINDS = {
    "partial_rope": dict(rope_pct=0.5),
    "nope": dict(nope_layers=(True, False)),
    "alibi": dict(pos_embed="alibi"),
    "local_rope_base": dict(sliding_window=64, swa_layers=(True, False),
                            rope_theta=1e6, rope_theta_local=1e4),
}
# the kinds whose keys the JAX package's context shift rotates wrongly: it
# rotates every layer's whole head with the global tables
JAX_SHIFT_FAULTS = {"partial_rope", "nope", "alibi"}
N, KEEP, DROP, MAX = 20, 4, 6, 32


def _shift_err(k_shifted, k_fresh) -> float:
    """Largest difference of layer 0's kept keys over their largest
    magnitude (a bf16 ulp of the prefill's rope output is the floor)."""
    a = np.asarray(k_shifted, np.float32)[0, :N - DROP]
    b = np.asarray(k_fresh, np.float32)[0, :N - DROP]
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("kind", list(SHIFT_KINDS))
def test_context_shift_rotates_only_rope_dims(kind):
    change = SHIFT_KINDS[kind]
    cfg_j = dataclasses.replace(JAX_PRESETS["tiny"], **change)
    cfg = dataclasses.replace(PRESETS["tiny"], **change)
    params = jt.init_params(cfg_j, seed=0)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    toks = np.random.default_rng(0).integers(3, cfg.vocab_size, N)
    kept = np.concatenate([toks[:KEEP], toks[KEEP + DROP:]])

    def port_keys(ids, shift):
        cache = tt.init_kv_cache(cfg, 1, max_len=MAX, dtype=torch.float32)
        with torch.inference_mode():
            tt.forward(model, cfg, torch.from_numpy(ids)[None].long(),
                       torch.arange(len(ids))[None], cache)
        if shift:
            kvc.seq_shift(cache, 0, KEEP + DROP, DROP,
                          tt.shift_tables(cfg))
        return cache["k"][0].numpy()

    def jax_keys(ids, shift):
        cache = jt.init_kv_cache(cfg_j, 1, max_len=MAX, dtype=jnp.float32)
        _, cache = jax.jit(jt.forward, static_argnums=(1,))(
            params, cfg_j, jnp.asarray(ids, jnp.int32)[None],
            jnp.arange(len(ids), dtype=jnp.int32)[None], cache)
        if shift:
            # the tables and flags the JAX engine's context shift passes
            plan = jt.make_plan(cfg_j)
            tabs = jax_rope_table(cfg_j.max_seq_len, plan.hd,
                                  cfg_j.rope_theta, cfg_j.rope_scaling,
                                  pad_to=plan.hd_p, with_mscale=False)
            loc = {}
            if cfg_j.rope_theta_local:
                c_l, s_l = jax_rope_table(cfg_j.max_seq_len, plan.hd,
                                          cfg_j.rope_theta_local, None,
                                          pad_to=plan.hd_p, with_mscale=False)
                loc = dict(cos_loc=c_l, sin_loc=s_l,
                           swa_local=cfg_j.swa_flags())
            cache = jax_kv.seq_shift(cache, jnp.int32(0),
                                     jnp.int32(KEEP + DROP), jnp.int32(DROP),
                                     *tabs, **loc)
        return np.asarray(cache["k"][0])

    port_err = _shift_err(port_keys(toks, True), port_keys(kept, False))
    jax_err = _shift_err(jax_keys(toks, True), jax_keys(kept, False))
    assert port_err < 1e-2, port_err
    if kind in JAX_SHIFT_FAULTS:
        assert jax_err > 0.1, jax_err
    else:
        assert jax_err < 1e-2, jax_err


@pytest.mark.parametrize("name", ["tiny_gemma2", "ln_parallel"])
def test_promote_i1_gives_the_i2_tokens(name, tmp_path):
    """The FFN's up/gate biases and sub-norm gains live in the chunk-padded
    FFN width, which the pack block sets: the i1 repack lays them out
    anew, so the greedy tokens stay the i2 model's (through ``promote``
    in memory and through ``requantize`` on disk)."""
    if name == "ln_parallel":
        cfg_j = dataclasses.replace(JAX_PRESETS["tiny"], **LN_PARALLEL,
                                    d_ff=200)
    else:
        cfg_j = dataclasses.replace(JAX_PRESETS[name], d_ff=200)
    jax_save(tmp_path / "i2", cfg_j, jt.init_params(cfg_j, seed=0))
    cfg, model, _ = load_checkpoint(tmp_path / "i2", device="cpu")
    cfg1, model1 = promote(cfg, model, "i1")
    requantize(tmp_path / "i2", tmp_path / "i1", "i1")
    cfg1d, model1d, _ = load_checkpoint(tmp_path / "i1", device="cpu")
    assert cfg1.weight_fmt == cfg1d.weight_fmt == "i1"
    assert tt.make_plan(cfg1).ff_p != tt.make_plan(cfg).ff_p
    ids = [3, 5, 7, 11, 13, 17]
    toks = [cli.run_batched(m, c, ids, 2, 6, temp=0.0)
            for c, m in ((cfg, model), (cfg1, model1), (cfg1d, model1d))]
    assert torch.equal(toks[0], toks[1]) and torch.equal(toks[0], toks[2])


def _checkpoint(tmp_path):
    """A converted (JAX-written) gemma2-style checkpoint with tiny_real's
    tokenizer."""
    cfg_j = JAX_PRESETS["tiny_gemma2"]
    jax_save(tmp_path / "ckpt", cfg_j, jt.init_params(cfg_j, seed=1),
             tokenizer_src=TINY_REAL)
    return tmp_path / "ckpt"


def test_generate_and_serve_match_jax(tmp_path):
    ckpt = _checkpoint(tmp_path)
    prompt, n = "The little model", 8
    cfg_j, params, _ = jax_load(ckpt)
    params = jax.tree.map(jnp.asarray, params)
    tok = JaxTokenizer(ckpt)
    ids = tok.encode(prompt)
    je = JaxEngine(cfg_j, params, n_slots=1, max_len=64,
                   impl="pallas_interpret")
    jr = JaxRequest(prompt=ids, max_new_tokens=n,
                    sampler=JaxSampler(temperature=0.0))
    je.run([jr])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["generate", "--model", str(ckpt), "-p", prompt, "-n",
                  str(n), "--temp", "0", "--device", "cpu"])
    assert tok.decode(jr.output) in out.getvalue()

    ap = __import__("argparse").ArgumentParser()
    port_server.add_server_args(ap)
    httpd, router = port_server.start_from_args(ap.parse_args(
        ["--model", str(ckpt), "--port", "0", "--slots", "1", "--ctx", "64",
         "--device", "cpu"]))
    jhttpd, jstate = jax_serve(je, tok, port=0)
    body = {"prompt": prompt, "n_predict": n, "temperature": 0.0,
            "ignore_eos": True, "n_probs": 1}
    try:
        got = [_post(("127.0.0.1", h.server_address[1]), body)
               for h in (httpd, jhttpd)]
    finally:
        for h in (httpd, jhttpd):
            h.shutdown()
            h.server_close()
        for st in router.states.values():
            st.stop()
        jstate.running = False
    ids_of = [[p["id"] for p in g["completion_probabilities"]] for g in got]
    assert ids_of[0] == ids_of[1] == jr.output
    assert got[0]["content"] == got[1]["content"]


def _post(hostport, body):
    import http.client

    conn = http.client.HTTPConnection(*hostport, timeout=300)
    conn.request("POST", "/completion", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    assert r.status == 200, data
    return json.loads(data)
