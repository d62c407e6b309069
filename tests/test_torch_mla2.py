"""M-RoPE and the MLA runtime around the model in the port, on the CPU
(``tests/test_torch_mla.py`` holds MLA's model and engine against the JAX
package):

* ``apply_mrope`` (chunked and interleaved) equals the JAX package's bit
  for bit, and ``forward(mrope_pos=)`` its forward; without position rows
  an M-RoPE config ropes as plain rope;
* the MLA and M-RoPE families of ``bench/zoo.py`` serve and decode with
  their plain versions, and ``init_params_fast`` lays out a deepseek tree;
* a JAX-written MLA checkpoint serves through ``generate`` and ``serve``
  with the engine's tokens.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_archs import close, jax_forward
from test_torch_mla import _pair
from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert.checkpoint import save_checkpoint as jax_save
from vlut_tpu.models import transformer as jt
from vlut_tpu.ops import rope as jrope
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.ops import rope as prope
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)


@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["chunked", "interleaved"])
def test_apply_mrope_matches_jax(interleaved):
    rng = np.random.default_rng(4)
    sections = (4, 6, 6) if not interleaved else (8, 4, 4)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 3, 5)).astype(np.int32)
    cos, sin = jrope.rope_table(64, 32, 10000.0,
                                {"rope_type": "mrope",
                                 "mrope_section": list(sections)})
    rows_j = jrope.mrope_row_map(sections, 16, interleaved)
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), cos, sin,
                             rows_j)
    # the unscaled tables (torch's cos and XLA's round apart by an ulp)
    pc, ps = prope.rope_table(64, 32, 10000.0, {"rope_type": "mrope"})
    np.testing.assert_allclose(pc.numpy(), np.asarray(cos), atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(sin), atol=1e-6)
    rows = prope.mrope_row_map(sections, 16, interleaved)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_j))
    got = prope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                            torch.from_numpy(np.array(cos)),
                            torch.from_numpy(np.array(sin)), rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["chunked", "interleaved"])
def test_forward_with_mrope_rows_matches_jax(interleaved):
    scaling = {"rope_type": "mrope", "mrope_section": [4, 6, 6],
               "mrope_interleaved": interleaved}
    cfg_j = dataclasses.replace(JAX_PRESETS["tiny"], rope_scaling=scaling)
    cfg = dataclasses.replace(PRESETS["tiny"], rope_scaling=scaling)
    tt.check_supported(cfg)
    params = jt.init_params(cfg_j, seed=0)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    rng = np.random.default_rng(5)
    b, t = 2, 12
    tokens = rng.integers(0, 256, (b, t)).astype(np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    rows = np.stack([pos, pos // 3, pos % 4 + 2], axis=1).astype(np.int32)
    want, _ = jax.jit(lambda p, tk, ps, mr: jt.forward(
        p, cfg_j, tk, ps, None, impl="pallas_interpret", mrope_pos=mr))(
            params, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(rows))
    with torch.inference_mode():
        got, _ = tt.forward(model, cfg, torch.from_numpy(tokens).long(),
                            torch.from_numpy(pos).long(),
                            mrope_pos=torch.from_numpy(rows).long())
        plain, _ = tt.forward(model, cfg, torch.from_numpy(tokens).long(),
                              torch.from_numpy(pos).long())
        rope = dataclasses.replace(cfg, rope_scaling=None)
        ref, _ = tt.forward(tt.TransformerLM(rope, model.tree()), rope,
                            torch.from_numpy(tokens).long(),
                            torch.from_numpy(pos).long())
    close(got, want, "mrope")
    assert np.array_equal(got.argmax(-1).numpy(),
                          np.asarray(want).argmax(-1))
    # the rows change the logits; without rows it is plain rope
    assert not torch.equal(got, plain)
    assert torch.equal(plain, ref)
    jl, _ = jax_forward(params, cfg_j, jnp.asarray(tokens), jnp.asarray(pos))
    close(plain, jl, "mrope without rows")


def test_mla_zoo_families_and_fast_weights_on_the_cpu():
    """The chip script's MLA and M-RoPE families (``bench/zoo.py``) serve
    and decode with their plain versions, MLA's decode writing its latent
    rows through #5 (never the fused attention); ``init_params_fast`` lays
    out a deepseek tree (a dense lead layer, then routed and shared
    experts) that runs."""
    from vlut_tpu_torch.bench import zoo

    for name in zoo.MLA_FAMILIES:
        r = zoo.card_vs_cpu(name, "cpu", n_decode=2)
        assert r["max_rel_logit_err"] == 0.0 and r["graph_equals_eager"]
        assert r["greedy_equal"]
        kinds = set(r["expected_kernels"])
        if name.startswith("mla"):
            assert "write_rows_pair" in kinds
            assert "decode_attention" not in kinds
    cfg = zoo.family_config("mla_deepseek_v2")
    model = tt.init_params_fast(cfg, seed=0, device="cpu")
    lead, routed = model.layers[0], model.layers[1]
    assert "router" not in dict(lead.named_buffers()) and lead.mla
    assert len(routed.experts["w_gate"]) == cfg.n_experts
    assert "w_shared_down" in routed.proj
    with torch.inference_mode():
        lg, _ = tt.forward(model, cfg, torch.tensor([[5, 7, 9]]),
                           torch.arange(3)[None])
    assert torch.isfinite(lg).all()


def test_generate_and_serve_an_mla_checkpoint(tmp_path):
    import argparse
    import contextlib
    import pathlib

    from test_torch_archs_engine import _post
    from vlut_tpu_torch import cli
    from vlut_tpu_torch.serving import server as port_server
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg_j, params, cfg, model = _pair()
    fixture = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
    jax_save(tmp_path / "ckpt", cfg_j, params, tokenizer_src=fixture)
    prompt, n = "The little model", 8
    tok = Tokenizer(tmp_path / "ckpt")
    req = Request(prompt=tok.encode(prompt), max_new_tokens=n,
                  sampler=SamplerParams(temperature=0.0))
    Engine(cfg, model, n_slots=1, max_len=64).run([req])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["generate", "--model", str(tmp_path / "ckpt"), "-p",
                  prompt, "-n", str(n), "--temp", "0", "--device", "cpu"])
    assert tok.decode(req.output) in out.getvalue()
    ap = argparse.ArgumentParser()
    port_server.add_server_args(ap)
    httpd, router = port_server.start_from_args(ap.parse_args(
        ["--model", str(tmp_path / "ckpt"), "--port", "0", "--slots", "1",
         "--ctx", "64", "--device", "cpu"]))
    try:
        got = _post(("127.0.0.1", httpd.server_address[1]),
                    {"prompt": prompt, "n_predict": n, "temperature": 0.0,
                     "ignore_eos": True, "n_probs": 1})
    finally:
        httpd.shutdown()
        httpd.server_close()
        for st in router.states.values():
            st.stop()
    assert [p["id"] for p in got["completion_probabilities"]] == req.output
