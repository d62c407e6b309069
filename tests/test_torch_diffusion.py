"""Bidirectional attention and the float twin (``models/transformer.py``,
``train/finetune.py``) against the JAX package, and the entry points of
the diffusion and decoder-embedder checkpoints.

The non-causal packed forward of a tiny random model (made by the JAX
``init_params`` from a seed, carried across bit for bit) equals the JAX
forward run with ``impl="pallas_interpret"`` within 2e-2 of the largest
logit (the tolerance of ``tests/_torch_archs.py``: one last-ulp difference
flips an int8 code) with the same argmax, with and without a sliding
window, with ALiBi, over a padded batch; the causal forward differs at
every row but the last.  The float twin's forward equals the JAX twin's
within 1e-5 of the largest logit (float32 products summed in other
orders).  The decoder embedders the JAX converter marks bidirectional
(llama-embed, EmbeddingGemma) give the JAX hidden states; ``llada_8b`` is
what the JAX converter makes of LLaDA-8B's config; ``cli generate`` on a
diffusion checkpoint prints the JAX loop's tokens.
"""

import argparse
import dataclasses
import http.client
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_archs_wave5
import test_archs_wave6
from _torch_archs import close
from vlut_tpu.config import PRESETS as JP
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.convert.convert import config_from_hf
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime.diffusion import (DiffusionParams as JaxDP,
                                        diffusion_generate as jax_diffusion)
from vlut_tpu.train.finetune import float_twin_params as jax_twin
from vlut_tpu_torch import cli
from vlut_tpu_torch.config import PRESETS, ModelConfig
from vlut_tpu_torch.convert import checkpoint as pck
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.runtime.engine import Engine
from vlut_tpu_torch.serving.server import add_server_args, start_from_args
from vlut_tpu_torch.train.finetune import float_twin_params
from vlut_tpu_torch.utils.tokenizer import Tokenizer

torch.set_num_threads(1)
TWIN_TOL = 1e-5


def bidir(**over):
    """A tiny JAX config with bidirectional attention and a mask token,
    and the port's copy of it."""
    cj = dataclasses.replace(JP["tiny"], causal_attn=False,
                             mask_token_id=255, diffusion_shift_logits=False,
                             **over)
    return cj, ModelConfig(**dataclasses.asdict(cj))


def jax_logits(params, cfg, toks, pos, mask=None, impl="pallas_interpret"):
    lg, _ = jt.forward(params, cfg, jnp.asarray(toks, jnp.int32),
                       jnp.asarray(pos, jnp.int32), None, impl=impl,
                       attn_mask=mask)
    return np.asarray(lg)


def port_logits(model, cfg, toks, pos, mask=None):
    with torch.inference_mode():
        lg, _ = tt.forward(model, cfg, torch.from_numpy(toks).long(),
                           torch.from_numpy(pos).long(), None,
                           attn_mask=None if mask is None
                           else torch.from_numpy(np.asarray(mask)))
    return lg


@pytest.mark.parametrize("over", [
    {}, {"sliding_window": 5, "sliding_window_pattern": 2},
    {"pos_embed": "alibi"}, {"qk_norm": True, "qkv_bias": True}],
    ids=["plain", "window", "alibi", "qknorm_bias"])
def test_noncausal_packed_forward_matches_jax(over):
    cj, cfg = bidir(**over)
    params = jt.init_params(cj, seed=11)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    rng = np.random.default_rng(2)
    b, t = 2, 13
    toks = rng.integers(0, cfg.vocab_size, (b, t))
    pos = np.tile(np.arange(t), (b, 1))
    want = jax_logits(params, cj, toks, pos)
    got = port_logits(model, cfg, toks, pos)
    close(got, want, "bidirectional")
    v = cfg.vocab_size
    assert np.array_equal(got[..., :v].argmax(-1).numpy(),
                          want[..., :v].argmax(-1))
    # the causal model differs at every row but the last
    causal = port_logits(model, dataclasses.replace(cfg, causal_attn=True),
                         toks, pos)
    diff = (causal - got).abs().amax(-1)[0]
    assert bool((diff[:-1] > 0).all())
    # past ATTN_CHUNK keys the chunked attention takes the same mask
    if not over:
        lng = 1100
        toks = rng.integers(0, v, (1, lng))
        pos = np.arange(lng)[None]
        dense = tt._attention
        q = torch.randn(1, lng, 4, 32)
        k = torch.randn(1, lng, 2, 32)
        pp = torch.from_numpy(pos)
        a = dense(q, k, k, pp, pp, 32, causal=False)
        c = tt._attention_chunked(q, k, k, pp, pp, 32, causal=False)
        assert float((a - c).abs().max()) < 1e-5


def test_override_mask_keeps_bidirectional_rows():
    """An all-true ``attn_mask`` (the denoise loop's) over a causal model
    equals the non-causal model without one."""
    cj, cfg = bidir()
    params = jt.init_params(cj, seed=4)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    toks = np.random.default_rng(1).integers(0, 255, (1, 9))
    pos = np.arange(9)[None]
    full = np.ones((1, 9, 9), bool)
    a = port_logits(model, dataclasses.replace(cfg, causal_attn=True), toks,
                    pos, full)
    b = port_logits(model, cfg, toks, pos)
    assert torch.equal(a, b)
    close(a, jax_logits(params, cj, toks, pos, jnp.asarray(full)), "override")


@pytest.mark.parametrize("over", [{}, {"sliding_window": 5,
                                       "sliding_window_pattern": 2}])
def test_float_twin_forward_matches_jax(over):
    cj, cfg = bidir(**over)
    params = jt.init_params(cj, seed=5)
    # float32 embeddings and head, as a float32 conversion stores them (a
    # bf16 residual would round the two sums' last bits apart)
    params = {**params, **{k: jnp.asarray(params[k], jnp.float32)
                           for k in ("embed", "lm_head")}}
    twin_j = jax_twin(params, cj)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    twin = float_twin_params(model, cfg)
    # the twin's leaves are the JAX twin's, bit for bit
    lj = jax.tree.map(np.asarray, twin_j)["layers"]
    lp = twin.tree()["layers"]
    for name in ("wq", "wo", "w_gate", "w_down"):
        assert np.array_equal(lp[name]["dense"].numpy(), lj[name]["dense"])
    assert isinstance(twin.layers[0].proj["wq"], tt.DenseLinear)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 11))
    pos = np.tile(np.arange(11), (2, 1))
    want = jax_logits(twin_j, cj, toks, pos, impl="xla")
    got = port_logits(twin, cfg, toks, pos).numpy()
    assert np.abs(got - want).max() <= TWIN_TOL * np.abs(want).max()
    # a twin never fuses, so the fused tree's gates leave it alone
    assert tt.fuse_projections(twin, cfg) is twin


def test_llada_preset_is_the_converters(tmp_path):
    """``llada_8b`` equals the JAX converter's config of LLaDA-8B's
    config.json (GSAI-ML/LLaDA-8B-Instruct; the mask token as
    ``mask_token_id``)."""
    raw = {
        "model_type": "llada", "architectures": ["LLaDAModelLM"],
        "vocab_size": 126464, "embedding_size": 126464, "d_model": 4096,
        "n_layers": 32, "n_heads": 32, "n_kv_heads": 32,
        "mlp_hidden_size": 12288, "mlp_ratio": 4, "rms_norm_eps": 1e-05,
        "rope_theta": 500000.0, "max_sequence_length": 4096,
        "weight_tying": False, "mask_token_id": 126336,
        "activation_type": "silu", "block_type": "llama",
        "include_bias": False, "layer_norm_type": "rms",
    }
    (tmp_path / "config.json").write_text(json.dumps(raw))
    want = dataclasses.asdict(config_from_hf(tmp_path))
    assert dataclasses.asdict(PRESETS["llada_8b"]) == want


@pytest.mark.parametrize("which", ["llama_embed", "gemma_embedding"])
def test_decoder_embedders_attend_both_ways(which, tmp_path):
    """The checkpoints the JAX converter marks ``causal_attn=False``
    (llama-embed, EmbeddingGemma): the port's hidden states equal the JAX
    package's, packed (within 2e-2) and as float twins (within 1e-5)."""
    if which == "llama_embed":
        test_archs_wave6.test_llama_embed_bidirectional_hidden(tmp_path)
        ckpt = tmp_path / "out_e"
    else:
        test_archs_wave5.test_gemma_embedding_parity(tmp_path)
        ckpt = tmp_path / "out"
    cj, params, _ = jax_load(ckpt)
    cfg, model, _ = pck.load_checkpoint(ckpt, device="cpu")
    assert not cfg.causal_attn and not cj.causal_attn
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    pos = np.tile(np.arange(9), (2, 1))
    params = jax.tree.map(jnp.asarray, params)
    for p_j, m, tol in ((params, model, None),
                        (jax_twin(params, cj), float_twin_params(model, cfg),
                         TWIN_TOL)):
        want, _ = jt.forward(p_j, cj, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(pos, jnp.int32), None,
                             impl="pallas_interpret" if tol is None
                             else "xla", output="hidden")
        with torch.inference_mode():
            got, _ = tt.forward(m, cfg, torch.from_numpy(toks).long(),
                                torch.from_numpy(pos).long(), None,
                                output="hidden")
        want = np.asarray(want, np.float32)
        if tol is None:
            close(got, want, which)
        else:
            err = np.abs(got.float().numpy() - want).max()
            assert err <= tol * np.abs(want).max()


@pytest.fixture
def diffusion_ckpt(tmp_path):
    """tests/fixtures/tiny_real (trained weights and a tokenizer) as a
    diffusion checkpoint: bidirectional, the mask token 255, in place."""
    dst = tmp_path / "tiny_diff"
    shutil.copytree("tests/fixtures/tiny_real", dst)
    meta = json.loads((dst / "vlut_config.json").read_text())
    meta["model_config"].update(causal_attn=False, mask_token_id=255,
                                diffusion_shift_logits=False)
    (dst / "vlut_config.json").write_text(json.dumps(meta))
    return dst


def test_cli_generate_diffusion(diffusion_ckpt, capsys):
    """``cli generate`` on a diffusion checkpoint: the float twin denoised
    by the JAX loop's tokens, and its summary line."""
    cj, params, _ = jax_load(diffusion_ckpt)
    tok = Tokenizer(str(diffusion_ckpt))
    prompt = "The little model"
    ids = tok.encode(prompt)
    for alg in ("low_confidence", "margin"):
        want = jax_diffusion(jax_twin(params, cj), cj, ids, 8,
                             JaxDP(steps=4, alg=alg))
        cli.main(["generate", "--model", str(diffusion_ckpt), "-p", prompt,
                  "-n", "8", "--temp", "0", "--diffusion-steps", "4",
                  "--diffusion-alg", alg, "--device", "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert out[0] == tok.decode(want)
        assert out[-1].startswith("[8 tokens (diffusion, 4 steps), ")


def test_entry_points_default_to_the_card(diffusion_ckpt):
    """Without a device the entry points ask for the card; on a machine
    without one they raise and do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    for argv in (["generate", "--model", str(diffusion_ckpt), "-p", "x",
                  "-n", "2"],
                 ["embed", "--model", str(diffusion_ckpt)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pck.load_checkpoint(diffusion_ckpt)



def test_engine_refuses_a_bidirectional_model(diffusion_ckpt):
    """A ``causal_attn=False`` model decodes from no cache: the engine
    refuses it and names the denoise loop and the embedding routes (the
    JAX engine serves it and attends every cache row)."""
    cfg, model, _ = pck.load_checkpoint(diffusion_ckpt, device="cpu")
    with pytest.raises(ValueError, match="denoises it.*embedding-only"):
        Engine(cfg, model, n_slots=1, max_len=64)


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", path)
    data = conn.getresponse().read()
    conn.close()
    return data


def test_bidirectional_model_served_embedding_only(diffusion_ckpt):
    """``serve`` answers a ``causal_attn=False`` transformer's embeddings
    and refuses its completions (400 "embedding-only").  Its rows attend
    their own tokens and not the bucket's pads, so a 16-token input embeds
    the same alone (no pad) and batched with a longer one (a bucket of 32),
    and as its unpadded forward's mean hidden state, within 1e-6 (one
    padded forward: without the key mask the batched vector moves by about
    1.6e-2)."""
    ap = argparse.ArgumentParser()
    add_server_args(ap)
    httpd, router = start_from_args(ap.parse_args(
        ["--model", f"d={diffusion_ckpt}", "--port", "0", "--device",
         "cpu"]))
    port = httpd.server_address[1]
    short = "The little model"
    longer = "a much longer input that runs past the first bucket of sixteen"
    try:
        vecs = []
        for texts in ([short], [short, longer]):
            st, data = _post(port, "/v1/embeddings", {"input": texts})
            assert st == 200
            vecs.append(np.asarray(json.loads(data)["data"][0]["embedding"]))
        st, data = _post(port, "/completion", {"prompt": "x"})
        assert st == 400 and b"embedding-only" in data
        props = json.loads(_get(port, "/props"))
        assert props["embedding_only"] and props["pooling"] == "mean"
        cfg, params = router.states["d"].embedder
        ids = router.states["d"].tok.encode(short)
        assert len(ids) == 16
        with torch.inference_mode():
            h, _ = tt.forward(params, cfg, torch.tensor([ids]),
                              torch.arange(len(ids))[None], None,
                              output="hidden")
        want = h.float().mean(1)[0]
        want = (want / want.norm()).numpy()
        for v in vecs:
            assert np.abs(v - want).max() <= 1e-6
    finally:
        httpd.shutdown()
        httpd.server_close()
