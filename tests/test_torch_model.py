"""Model-level parity of the PyTorch port against the JAX package on the CPU.

Both packages compute on identical weights (the JAX tree carried over by
``params_from_numpy``, or the same checkpoint read by each package's
loader).  The port's plain CPU path runs the same integer GEMMs as the JAX
XLA path, so logits agree to float32 rounding of the epilogues and the
attention; the stated tolerance (2e-2 of the largest logit) leaves room for
an int8 activation code that rounds the other way, and greedy tokens must
be identical.
"""

import contextlib
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime.generate import make_generate_fn as jax_generate_fn
from vlut_tpu.runtime.sampling import SamplerParams as JaxSamplerParams
from vlut_tpu.runtime.sampling import stack_params as jax_stack_params
from vlut_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from vlut_tpu_torch import cli
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.runtime import sampling
from vlut_tpu_torch.runtime.generate import make_generate_fn
from vlut_tpu_torch.utils.tokenizer import CharWordLevel

torch.set_num_threads(1)

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
B, T, N_STEPS, MAX_LEN = 2, 8, 8, 32
jax_forward = jax.jit(jt.forward, static_argnums=(1,))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _as_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def test_load_checkpoint_matches_jax():
    cfg_j, params_j, meta_j = jax_load(TINY_REAL, stream=False)
    cfg, model, meta = load_checkpoint(TINY_REAL, device="cpu")
    assert meta == meta_j
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == {
        f: getattr(cfg_j, f) for f in cfg.__dataclass_fields__}
    want, got = _flat(params_j), _flat(model.tree())
    assert set(got) == set(want)
    for name, a in want.items():
        b = _as_np(got[name])
        assert b.dtype == a.dtype and b.shape == a.shape, name
        np.testing.assert_array_equal(b.view(np.uint8), np.asarray(a).view(
            np.uint8), err_msg=name)


@pytest.mark.parametrize("name", ["tiny", "tiny_bitnet"])
def test_init_params_matches_jax(name):
    """The port's numpy-seeded init_params draws the JAX package's weights."""
    want = _flat(jt.init_params(JAX_PRESETS[name], seed=0))
    got = _flat(tt.init_params(PRESETS[name], seed=0).tree())
    assert set(got) == set(want)
    for key, a in want.items():
        np.testing.assert_array_equal(
            _as_np(got[key]).view(np.uint8), np.asarray(a).view(np.uint8),
            err_msg=key)


@pytest.mark.parametrize("name", ["tiny", "tiny_bitnet"])
def test_init_params_fast_bytes_are_trits(name):
    """init_params_fast draws packed bytes straight on the device; every
    field must be a trit (an i2 field of 3 is not one)."""
    from vlut_tpu_torch.ops.packing import unpack_fields

    cfg = PRESETS[name]
    model = tt.init_params_fast(cfg, seed=1, device="cpu")
    for i in range(cfg.n_layers):
        for lin in model.layers[i].proj.values():
            fields = unpack_fields(lin.packed, lin.fmt, lin.kb)
            assert int(fields.max()) <= 2 and int(fields.min()) >= 0
    again = tt.init_params_fast(cfg, seed=1, device="cpu")
    assert torch.equal(model.layers.wq__packed, again.layers.wq__packed)


def _models(name: str, fused: bool):
    """(JAX cfg, JAX params, port cfg, port model) on identical weights."""
    if name == "tiny_real":
        cfg_j, params, _ = jax_load(TINY_REAL, stream=False)
        params = jax.tree.map(jnp.asarray, params)
        cfg = load_checkpoint(TINY_REAL, device="cpu")[0]
    else:
        cfg_j, cfg = JAX_PRESETS[name], PRESETS[name]
        params = jt.init_params(cfg_j, seed=0)
    if fused:
        params = jt.unstack_layers(jt.fuse_projections(params, cfg_j), cfg_j)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    assert isinstance(model.layers, tt.StackedLayers) != fused
    assert all(model.layers[i].fused == fused for i in range(cfg.n_layers))
    return cfg_j, params, cfg, model


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("decode_attn", ["fused", "composed"])
@pytest.mark.parametrize("fused", [False, True], ids=["stacked", "fused"])
@pytest.mark.parametrize("name", ["tiny", "tiny_bitnet", "tiny_real"])
def test_prefill_decode_generate_match_jax(name, fused, decode_attn):
    cfg_j, params, cfg, model = _models(name, fused)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))

    def prefill():
        jc = jt.init_kv_cache(cfg_j, B, max_len=MAX_LEN)
        jl, jc = jax_forward(params, cfg_j, jnp.asarray(toks),
                             jnp.asarray(pos), jc)
        tc = tt.init_kv_cache(cfg, B, max_len=MAX_LEN)
        with torch.inference_mode():
            tl, tc = tt.forward(model, cfg, torch.from_numpy(toks).long(),
                                torch.from_numpy(pos).long(), tc)
        return jl, jc, tl, tc

    jl, jc, tl, tc = prefill()
    _close(tl, jl)
    v = cfg.vocab_size
    last = np.asarray(jl)[:, -1, :v].argmax(-1)
    np.testing.assert_array_equal(tl[:, -1, :v].argmax(-1).numpy(), last)

    # step-by-step greedy decode, logits compared at every step
    cur = last
    for step in range(N_STEPS):
        p = np.full((B, 1), T + step, np.int32)
        jl, jc = jax_forward(params, cfg_j,
                             jnp.asarray(cur[:, None], jnp.int32),
                             jnp.asarray(p), jc)
        with torch.inference_mode():
            tl, tc = tt.forward(model, cfg,
                                torch.from_numpy(cur[:, None]).long(),
                                torch.from_numpy(p).long(), tc,
                                decode_attn=decode_attn)
        _close(tl, jl)
        cur = np.asarray(jl)[:, 0, :v].argmax(-1)
        np.testing.assert_array_equal(tl[:, 0, :v].argmax(-1).numpy(), cur)

    # fixed-n generation from a fresh prefill
    jl, jc, tl, tc = prefill()
    lens = np.full((B,), T, np.int32)
    want, _ = jax_generate_fn(cfg_j, N_STEPS)(
        params, jc, jnp.asarray(last, jnp.int32), jnp.asarray(lens),
        jax_stack_params([JaxSamplerParams(temperature=0.0)] * B),
        jax.random.PRNGKey(0))
    got, cache = make_generate_fn(cfg, N_STEPS, features=(),
                                  decode_attn=decode_attn)(
        model, tc, torch.from_numpy(last), torch.from_numpy(lens).long(),
        sampling.stack_params([sampling.SamplerParams(temperature=0.0)] * B))
    assert cache is tc  # the cache is updated in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_cli_matches_jax():
    """``batched`` on tiny_real with --device cpu: the port's token ids and
    printed text against the JAX package's forward + fixed-n greedy."""
    prompt, n_par, n_pred = "The little model", 2, 8
    cfg_j, params, _ = jax_load(TINY_REAL, stream=False)
    params = jax.tree.map(jnp.asarray, params)
    tok = JaxTokenizer(TINY_REAL)
    ids = tok.encode(prompt)
    t = len(ids)
    cache = jt.init_kv_cache(cfg_j, n_par, max_len=t + n_pred + 8)
    logits, cache = jax_forward(
        params, cfg_j, jnp.tile(jnp.asarray(ids, jnp.int32)[None], (n_par, 1)),
        jnp.tile(jnp.arange(t, dtype=jnp.int32), (n_par, 1)), cache,
        logits_at=jnp.full((n_par,), t - 1, jnp.int32))
    last = jnp.argmax(logits[:, 0, : cfg_j.vocab_size], -1).astype(jnp.int32)
    samplers = [JaxSamplerParams(temperature=0.0, seed=i) for i in range(n_par)]
    want, _ = jax_generate_fn(cfg_j, n_pred)(
        params, cache, last, jnp.full((n_par,), t, jnp.int32),
        jax_stack_params(samplers), jax.random.PRNGKey(0))
    want = np.asarray(want)

    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    got = cli.run_batched(model, cfg, ids, n_par, n_pred, temp=0.0)
    np.testing.assert_array_equal(got.numpy(), want)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["batched", "--model", str(TINY_REAL), "-p", prompt, "-np",
                  str(n_par), "-n", str(n_pred), "--temp", "0",
                  "--device", "cpu"])
    lines = out.getvalue().splitlines()
    for i, row in enumerate(want):
        assert lines[2 * i] == f"--- seq {i} ---"
        assert lines[2 * i + 1] == prompt + tok.decode([int(x) for x in row])


def test_int8_head_matches_jax():
    cfg_j, params, cfg, model = _models("tiny", fused=True)
    params = jt.quantize_head(params)
    model_q = tt.quantize_head(model)
    np.testing.assert_array_equal(model_q.lm_head_q.numpy(),
                                  np.asarray(params["lm_head"]["q"]))
    np.testing.assert_array_equal(model_q.lm_head_scale.numpy(),
                                  np.asarray(params["lm_head"]["scale"]))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    want, _ = jax_forward(params, cfg_j, jnp.asarray(toks), jnp.asarray(pos))
    with torch.inference_mode():
        got, _ = tt.forward(model_q, cfg, torch.from_numpy(toks).long(),
                            torch.from_numpy(pos).long())
    _close(got, want)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(want).argmax(-1))


def test_temperature_sampling_distribution():
    """Seeded draws differ from JAX's (Philox vs threefry), so temperature
    sampling is held to its distribution: softmax(logits / T) per row."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, -30.0]] * 2)
    p = sampling.stack_params([sampling.SamplerParams(temperature=0.7, seed=0),
                               sampling.SamplerParams(temperature=0.0, seed=1)])
    gens = sampling.row_generators(p, seed=3, device="cpu")
    n = 4000
    draws = torch.stack([sampling.sample(logits, p, gens, ("sampling",))
                         for _ in range(n)])
    assert (draws[:, 1] == 0).all()  # temperature 0 is greedy
    freq = torch.bincount(draws[:, 0], minlength=5).double() / n
    want = torch.softmax(logits[0].double() / 0.7, dim=0)
    # four standard deviations of a binomial share
    assert ((freq - want).abs() <= 4 * (want * (1 - want) / n).sqrt()
            + 1e-9).all()


def test_unported_sampler_transforms_raise():
    """The sampler chain is ported (a top-k feature set builds), grammar
    constraints are too (a grammar request is served under its mask), and
    a config outside the ported subset, an activation the port does not
    compute, still raises (a MoE, an MLA, a non-causal one and cogvlm's
    visual experts, ported since, do not)."""
    import dataclasses

    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.grammar import GrammarSampler

    make_generate_fn(PRESETS["tiny"], 2, features=("top_k", "sampling"))
    model = tt.init_params(PRESETS["tiny"], seed=0)
    eng = Engine(PRESETS["tiny"], model, n_slots=1, max_len=32)
    pieces = [""] * 3 + [chr(i) for i in range(3, 256)]
    req = Request(prompt=[1, 2], max_new_tokens=3,
                  grammar=GrammarSampler('root ::= "ab" [0-9]', pieces))
    eng.run([req])
    assert "".join(pieces[t] for t in req.output) == "ab" + pieces[
        req.output[-1]] and pieces[req.output[-1]].isdigit()
    tt.check_supported(dataclasses.replace(
        PRESETS["tiny"], causal_attn=False, mask_token_id=7,
        diffusion_shift_logits=False))
    with pytest.raises(NotImplementedError):
        tt.check_supported(dataclasses.replace(PRESETS["tiny"],
                                               act_fn="swish9"))
    tt.check_supported(dataclasses.replace(PRESETS["tiny"],
                                           dual_expert=True))
    tt.check_supported(dataclasses.replace(PRESETS["tiny"], n_experts=4,
                                           n_experts_used=2))
    tt.check_supported(dataclasses.replace(PRESETS["tiny"],
                                           kv_lora_rank=64))


def test_unported_config_raises():
    import dataclasses

    # the diffusion fields (item 7) and cogvlm's visual experts (item 8)
    # are ported, and so is describe's audio branch, which needs its
    # encoder directory
    tt.check_supported(dataclasses.replace(
        PRESETS["tiny"], causal_attn=False, mask_token_id=7,
        diffusion_shift_logits=False))
    tt.check_supported(dataclasses.replace(PRESETS["tiny"],
                                           dual_expert=True))
    tt.check_supported(PRESETS["tiny_mla"])
    with pytest.raises(SystemExit, match="--audio-encoder"):
        cli.main(["describe", "--model", str(TINY_REAL), "--audio", "a.wav",
                  "--device", "cpu"])


def test_char_tokenizer_matches_hf():
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(str(TINY_REAL))
    ours = CharWordLevel(TINY_REAL)
    for text in ("The little model", "a<0x01>b, ü\n", ""):
        assert ours.encode(text) == hf.encode(text, add_special_tokens=True)
    ids = list(range(256)) + [72, 1, 10, 300, 128000]  # two out of vocab
    assert ours.decode(ids) == hf.decode(ids, skip_special_tokens=False)
    assert ours.eos_token_id == hf.eos_token_id
    assert ours.bos_token_id == hf.bos_token_id


@pytest.mark.parametrize("fused", [False, True], ids=["stacked", "fused"])
@pytest.mark.parametrize("name", ["tiny", "tiny_bitnet", "tiny_real"])
def test_forward_hidden_matches_jax(name, fused):
    """``output="hidden"``: the final-norm hidden states (B, T, D) in bf16
    with no head, against the JAX package's; the head applied to them
    gives ``forward``'s logits bit for bit."""
    cfg_j, params, cfg, model = _models(name, fused)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    want, _ = jax.jit(jt.forward, static_argnums=(1,),
                      static_argnames=("output",))(
        params, cfg_j, jnp.asarray(toks), jnp.asarray(pos), None,
        output="hidden")
    t_toks, t_pos = torch.from_numpy(toks).long(), torch.from_numpy(pos).long()
    with torch.inference_mode():
        got, cache = tt.forward(model, cfg, t_toks, t_pos, output="hidden")
        logits, _ = tt.forward(model, cfg, t_toks, t_pos)
    assert cache is None
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, cfg.d_model)
    _close(got.float(), np.asarray(want.astype(jnp.float32)))
    assert torch.equal(tt.project_head(model, got), logits)
