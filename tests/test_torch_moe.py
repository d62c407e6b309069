"""Mixture of experts and per-layer stacks in the port: the config gate,
routing, layouts, checkpoints and requantization, held against the JAX
package on the CPU.

* ``check_supported`` takes the MoE and per-layer fields (and MLA's and
  M-RoPE, ported since) and still refuses non-causal attention, the
  diffusion fields and cogvlm's visual experts, each naming its ROADMAP
  item;
* top-k selects as ``jax.lax.top_k`` does on ties (the lower index first),
  so a router of exact ties picks the JAX package's experts; identical
  experts make the output independent of the router;
* ``init_params`` lays out a MoE model's experts and router as the JAX
  package's does (bit for bit), ``fuse_projections`` fuses qkv and keeps
  the expert stacks, ``init_params_fast`` lays out (L, E, ...) stacks;
* the slot engine's greedy tokens equal the JAX engine's on a MoE model;
* ``requantize_params`` repacks expert stacks byte for byte as the JAX
  package does, and back;
* a ``layers_tuple`` checkpoint written by the JAX package loads in the
  port, and one the port writes loads in the JAX package;
* ``mixtral_8x7b`` equals what the JAX converter makes of
  ``transformers.MixtralConfig`` at Mixtral-8x7B's published values;
* each MoE / per-layer family of ``bench/zoo.py`` runs on the CPU with
  the kernels the JAX gates send it to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_archs import check_pair, trees
from test_torch_engine import ENGINE_KW, _workload
from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.convert.checkpoint import save_checkpoint as jax_save
from vlut_tpu.convert.quantize import requantize_params as jax_requantize
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import load_checkpoint, save_checkpoint
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.convert.quantize import requantize_params
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

torch.set_num_threads(1)

# one non-default value of each field this slice ports
PORTED = dict(
    heads_per_layer=((4, 2), (2, 1)), d_ff_per_layer=(256, 128),
    n_experts=4, n_experts_used=2, moe_score="sigmoid", moe_norm_topk=False,
    n_expert_groups=2, topk_groups=1, routed_scale=2.5, n_shared_experts=1,
    d_ff_shared=64, first_k_dense=1, d_ff_dense=512,
    dense_layers=(False, True), moe_expert_bias=True, moe_weight_before=True,
    moe_router_input="layer_input", moe_parallel="arctic",
    moe_chunk_experts=2, moe_chunk_scale=0.5, d_ff_chunk=64)
# the fields refused before this slice, with the ROADMAP item their error
# names, or None for those taken since (MLA's fields and M-RoPE, item 4c;
# bidirectional attention and the diffusion fields, item 7; cogvlm's
# visual experts, item 8)
REFUSED = [
    (dict(q_lora_rank=64), None), (dict(kv_lora_rank=64), None),
    (dict(qk_nope_dim=64), None), (dict(qk_rope_dim=32), None),
    (dict(rope_scaling={"rope_type": "mrope", "mrope_section": [4, 6, 6]}),
     None),
    (dict(causal_attn=False), None), (dict(mask_token_id=5), None),
    (dict(diffusion_shift_logits=False), None), (dict(dual_expert=True), None),
]


@pytest.mark.parametrize("field", list(PORTED))
def test_check_supported_takes_the_field(field):
    tt.check_supported(dataclasses.replace(PRESETS["tiny"],
                                           **{field: PORTED[field]}))


@pytest.mark.parametrize("change,item", REFUSED,
                         ids=[next(iter(c)) for c, _ in REFUSED])
def test_check_supported_refuses(change, item):
    cfg = dataclasses.replace(PRESETS["tiny"], **change)
    if item is None:
        tt.check_supported(cfg)  # ported by item 4c, 7 or 8
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tt.check_supported(cfg)


def test_top_k_breaks_ties_as_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (64, 16)).astype(np.float32)  # many exact ties
    x[:8] = 0.5
    for k in (1, 2, 5):
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        got = tt._top_k(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)


def _tiny_moe(**change):
    cfg_j = dataclasses.replace(JAX_PRESETS["tiny_moe"], **change)
    cfg = dataclasses.replace(PRESETS["tiny_moe"], **change)
    return cfg_j, cfg, jt.init_params(cfg_j, seed=0)


def _tokens(vocab, t=9, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (2, t)).astype(
        np.int32)


def test_router_ties_pick_the_jax_experts():
    """A zero router scores every expert alike: the top two are experts 0
    and 1 in both packages (torch.topk promises no order on ties)."""
    cfg_j, cfg, params = _tiny_moe()
    params["layers"]["router"] = jnp.zeros_like(params["layers"]["router"])
    for _, p, model in trees(cfg_j, params, cfg):
        check_pair(cfg_j, p, cfg, model, _tokens(cfg.vocab_size))


def test_identical_experts_make_the_router_irrelevant():
    cfg_j, cfg, params = _tiny_moe()
    layers = params["layers"]
    for nm in ("w_gate", "w_up", "w_down"):
        p, s = np.array(layers[nm]["packed"]), np.array(layers[nm]["scale"])
        p[:, 1:], s[:, 1:] = p[:, :1], s[:, :1]
        layers[nm] = {"packed": jnp.asarray(p), "scale": jnp.asarray(s)}
    toks = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    pos = torch.arange(9)[None].repeat(2, 1)
    out = []
    for seed in (3, 4):
        rng = np.random.default_rng(seed)
        layers["router"] = jnp.asarray(rng.standard_normal(
            layers["router"].shape), jnp.float32)
        model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
        with torch.inference_mode():
            out.append(tt.forward(model, cfg, toks, pos)[0])
    torch.testing.assert_close(out[0], out[1], rtol=1e-4, atol=1e-4)


def test_moe_layouts_follow_jax():
    cfg_j, cfg, params = _tiny_moe()
    tree = tt.init_params(cfg, seed=0).tree()["layers"]
    for name, v in params["layers"].items():
        want = v["packed"] if isinstance(v, dict) else v
        got = tree[name]["packed"] if isinstance(v, dict) else tree[name]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    model = tt.init_params(cfg, seed=0)
    fused = tt.unstack_layers(tt.fuse_projections(model, cfg), cfg)
    lp = fused.layers[0]
    assert "wqkv" in lp.proj and "w_gateup" not in lp.proj
    assert set(lp.experts) == {"w_gate", "w_up", "w_down"}
    assert len(lp.experts["w_up"]) == cfg.n_experts
    fast = tt.init_params_fast(cfg, seed=0, device="cpu").tree()["layers"]
    fast_j = jt.init_params_fast(cfg_j, seed=0)["layers"]
    for name in ("w_gate", "w_up", "w_down", "router"):
        a = fast[name]["packed"] if name != "router" else fast[name]
        b = fast_j[name]["packed"] if name != "router" else fast_j[name]
        assert tuple(a.shape) == b.shape, name
    np.testing.assert_array_equal(fast["router"].float().numpy(),
                                  np.asarray(fast_j["router"], np.float32))


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_moe_engine_matches_jax(q8):
    cfg_j, cfg, params = _tiny_moe()
    je = JaxEngine(cfg_j, params, impl="pallas_interpret", kv_quant=q8,
                   **ENGINE_KW)
    want = [JaxRequest(sampler=JaxSampler(temperature=0.0), **kw)
            for kw in _workload(cfg.vocab_size)]
    je.run(want)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    eng = Engine(cfg, model, kv_quant=q8, **ENGINE_KW)
    got = [Request(sampler=SamplerParams(temperature=0.0), **kw)
           for kw in _workload(cfg.vocab_size)]
    eng.run(got)
    assert [r.output for r in got] == [r.output for r in want]


@pytest.mark.parametrize("fmt_cfg", ["tiny_moe", "tiny_moe_d_ff_200"])
def test_requantize_expert_stacks_byte_equal_jax(fmt_cfg):
    """i2 -> i1 of a MoE tree: every expert's bytes and scales equal the
    JAX package's ``requantize_params``'; i1 -> i2 gives the source back.
    d_ff 200 makes the pack block move the experts' chunk padding."""
    change = dict(d_ff=200) if fmt_cfg.endswith("200") else {}
    cfg_j, cfg, params = _tiny_moe(**change)
    pn = jax.tree.map(np.asarray, params)
    _, want = jax_requantize(cfg_j, pn, "i1")
    cfg1, got = requantize_params(cfg, params_from_numpy(pn, cfg), "i1")
    for name, v in want["layers"].items():
        if isinstance(v, dict):
            assert got["layers"][name]["packed"].dim() == (
                4 if name.startswith("w_") else 3)
            np.testing.assert_array_equal(
                got["layers"][name]["packed"].numpy(), v["packed"], name)
            np.testing.assert_array_equal(
                got["layers"][name]["scale"].numpy(), v["scale"], name)
    _, back = requantize_params(cfg1, got, "i2")
    for name, v in pn["layers"].items():
        if isinstance(v, dict):
            np.testing.assert_array_equal(back["layers"][name]["packed"],
                                          v["packed"], name)


def test_requantize_relays_the_expert_biases():
    """gpt-oss's expert biases (L, E, ff_p) live in the experts' padded FFN
    width: an i2 -> i1 -> i2 round trip gives them back, and the i1 model's
    logits are the i2 model's."""
    cfg = dataclasses.replace(PRESETS["tiny_moe"], d_ff=200,
                              moe_expert_bias=True)
    model = tt.init_params(cfg, seed=0)
    tree = model.tree()
    cfg1, t1 = requantize_params(cfg, tree, "i1")
    assert t1["layers"]["eb_up"].shape[-1] != tree["layers"]["eb_up"].shape[-1]
    _, t2 = requantize_params(cfg1, t1, "i2")
    for nm in ("eb_gate", "eb_up", "eb_down"):
        torch.testing.assert_close(t2["layers"][nm], tree["layers"][nm],
                                   rtol=0, atol=0)
    toks = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    pos = torch.arange(9)[None].repeat(2, 1)
    with torch.inference_mode():
        a = tt.forward(model, cfg, toks, pos)[0]
        b = tt.forward(tt.TransformerLM(cfg1, t1), cfg1, toks, pos)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _np_tree(node):
    if isinstance(node, dict):
        return {k: _np_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return tuple(_np_tree(v) for v in node)
    if node.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(node.float().numpy(), jnp.bfloat16))
    return node.numpy()


def test_layers_tuple_checkpoints_between_packages(tmp_path):
    """A MoE model with a dense lead layer and per-layer heads keeps one
    tree per layer: written by the JAX package's ``save_checkpoint``, it
    loads in the port tensor for tensor and forwards as the JAX package
    does; written by the port, it loads in the JAX package."""
    cfg = dataclasses.replace(
        PRESETS["tiny_moe"], head_dim=32, first_k_dense=1, d_ff_dense=384,
        heads_per_layer=((4, 2), (2, 1)), n_shared_experts=1)
    cfg_j = dataclasses.replace(JAX_PRESETS["tiny_moe"], head_dim=32,
                                first_k_dense=1, d_ff_dense=384,
                                heads_per_layer=((4, 2), (2, 1)),
                                n_shared_experts=1)
    model = tt.init_params(cfg, seed=0)
    tree = model.tree()
    assert isinstance(tree["layers"], list) and "router" not in tree[
        "layers"][0] and "w_shared_gate" in tree["layers"][1]
    jax_save(tmp_path / "j", cfg_j, _np_tree(tree))
    cfg2, got, meta = load_checkpoint(tmp_path / "j", device="cpu")
    assert meta["layers_tuple"] and cfg2 == cfg
    for lp, lw in zip(got.tree()["layers"], tree["layers"]):
        assert set(lp) == set(lw)
        for k, v in lw.items():
            pairs = ([(lp[k][x], v[x]) for x in v] if isinstance(v, dict)
                     else [(lp[k], v)])
            for a, b in pairs:
                assert torch.equal(a.reshape(b.shape), b), k
    params_j = jax.tree.map(jnp.asarray, jax_load(tmp_path / "j")[1])
    toks = _tokens(cfg.vocab_size, 6)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    want = jt.forward(params_j, cfg_j, jnp.asarray(toks), jnp.asarray(pos),
                      None, impl="xla")[0]
    with torch.inference_mode():
        mine = tt.forward(got, cfg2, torch.from_numpy(toks).long(),
                          torch.from_numpy(pos).long())[0]
    w = np.asarray(want, np.float32)
    assert np.abs(mine.numpy() - w).max() <= 2e-2 * np.abs(w).max()
    save_checkpoint(tmp_path / "p", cfg, got)
    _, back, meta_j = jax_load(tmp_path / "p")
    assert meta_j["layers_tuple"] and isinstance(back["layers"], tuple)
    np.testing.assert_array_equal(
        back["layers"][1]["w_up"]["packed"],
        tree["layers"][1]["w_up"]["packed"].numpy())


def test_mixtral_8x7b_equals_config_from_hf(tmp_path):
    transformers = pytest.importorskip("transformers")
    from vlut_tpu.convert.convert import config_from_hf

    transformers.MixtralConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        head_dim=128, max_position_embeddings=32768, rms_norm_eps=1e-5,
        rope_theta=1e6, sliding_window=None, num_local_experts=8,
        num_experts_per_tok=2, tie_word_embeddings=False,
    ).save_pretrained(str(tmp_path))
    want = dataclasses.asdict(config_from_hf(tmp_path))
    assert dataclasses.asdict(PRESETS["mixtral_8x7b"]) == want
    tt.check_supported(PRESETS["mixtral_8x7b"])


def test_moe_zoo_families_run_on_the_cpu():
    """The chip script's MoE and per-layer families (``bench/zoo.py``)
    build, serve and decode with their plain versions; each one's expected
    kernels follow the JAX gates: #4 for every expert, #1 for wo (and qkv
    on a stacked tree), #7 on each layer whose own heads it takes."""
    from vlut_tpu_torch.bench import zoo

    for name in zoo.MOE_FAMILIES:
        r = zoo.card_vs_cpu(name, "cpu", n_decode=2)
        assert r["max_rel_logit_err"] == 0.0 and r["graph_equals_eager"]
        assert r["max_rel_layer_err"] == 0.0 and r["greedy_equal"]
        assert set(r["expected_kernels"]) == {
            "ternary_gemm_tiled", "ternary_gemm_decode",
            "ternary_gemm_fused_quant", "decode_attention"}, name


def test_generate_override_and_serve_a_moe_checkpoint(tmp_path, monkeypatch):
    """A JAX-written tiny_moe checkpoint (tiny_real's tokenizer): ``generate
    --override n_experts_used=1`` gives the JAX package's text, and the
    port's server answers a /completion with the JAX server's tokens."""
    import contextlib
    import io
    import pathlib

    from test_torch_archs_engine import _post
    from vlut_tpu import cli as jax_cli
    from vlut_tpu.serving.server import serve as jax_serve
    from vlut_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
    from vlut_tpu_torch import cli
    from vlut_tpu_torch.serving import server as port_server

    tiny_real = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
    cfg_j = JAX_PRESETS["tiny_moe"]
    jax_save(tmp_path / "moe", cfg_j, jt.init_params(cfg_j, seed=1),
             tokenizer_src=tiny_real)
    monkeypatch.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
    gen = ["generate", "--model", str(tmp_path / "moe"), "-p",
           "The little model", "-n", "6", "--temp", "0", "--ctx", "64",
           "--override", "n_experts_used=1"]

    def text(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(argv)
        return out.getvalue()

    assert text(cli.main, gen + ["--device", "cpu"]) == text(jax_cli.main,
                                                             gen)
    params = jax.tree.map(jnp.asarray, jax_load(tmp_path / "moe")[1])
    je = JaxEngine(cfg_j, params, n_slots=1, max_len=64,
                   impl="pallas_interpret")
    ap = __import__("argparse").ArgumentParser()
    port_server.add_server_args(ap)
    httpd, router = port_server.start_from_args(ap.parse_args(
        ["--model", str(tmp_path / "moe"), "--port", "0", "--slots", "1",
         "--ctx", "64", "--device", "cpu"]))
    jhttpd, jstate = jax_serve(je, JaxTokenizer(tmp_path / "moe"), port=0)
    body = {"prompt": "The little model", "n_predict": 6,
            "temperature": 0.0, "ignore_eos": True, "n_probs": 1}
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
    ids = [[p["id"] for p in g["completion_probabilities"]] for g in got]
    assert ids[0] == ids[1] and got[0]["content"] == got[1]["content"]
