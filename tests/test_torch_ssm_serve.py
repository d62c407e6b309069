"""Mamba through the port's ``generate`` and server on the CPU, with
tiny_real's tokenizer (256 pieces), and the other families' ``generate``
loops through the CLI; seeded sampling checked by distribution (torch's
Philox stands in for JAX's threefry, so only the law of the draws can
match).

Routes of the JAX server over a Mamba engine: completion, chat and infill
answer; embeddings and rerank fail there (its transformer forward gets
Mamba weights) and the port refuses them with a message
(:func:`test_server_refuses_hidden_state_routes`); a Mamba2, RWKV or
hybrid checkpoint is refused by the port's ``serve`` and fails in the JAX
server's engine.
"""

import contextlib
import http.client
import io
import json
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

from _torch_recurrent import greedy_ref, jax_family_generate, mamba_pair
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.convert.checkpoint import save_checkpoint as jax_save
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.serving.server import serve as jax_serve
from vlut_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from vlut_tpu_torch import cli
from vlut_tpu_torch.convert.checkpoint import load_checkpoint, save_checkpoint
from vlut_tpu_torch.models import ssm as ps
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams
from vlut_tpu_torch.serving import server as port_server
from vlut_tpu_torch.utils.tokenizer import Tokenizer

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
V = 256


@pytest.fixture(scope="module")
def mamba_dir(tmp_path_factory):
    """A tiny Mamba (vocabulary 256) written by the JAX package with
    tiny_real's tokenizer."""
    cfg_j, pj, _, _ = mamba_pair(seed=1, vocab_size=V)
    out = tmp_path_factory.mktemp("mamba")
    jax_save(out, cfg_j, jax.tree.map(np.asarray, pj),
             tokenizer_src=TINY_REAL)
    return out


def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def test_categorical_draws_follow_softmax():
    """``family_generate``'s sampled pick: 20,000 draws from fixed logits at
    temperature 0.7, each token's share within 4 standard errors of
    softmax(logits / 0.7)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, 3.0, -3.0, 1.5])
    gen = torch.Generator().manual_seed(0)
    n = 20000
    counts = np.bincount([cli._categorical(logits, 0.7, gen)
                          for _ in range(n)], minlength=8)
    p = torch.softmax(logits / 0.7, -1).numpy()
    se = np.sqrt(p * (1 - p) / n)
    assert (np.abs(counts / n - p) <= 4 * se + 1e-9).all(), (counts / n, p)


def test_generate_cli_mamba_goes_through_the_engine(mamba_dir, monkeypatch):
    """``generate`` on a Mamba checkpoint: the engine's greedy tokens, which
    are the JAX engine's."""
    monkeypatch.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
    cfg, model, _ = load_checkpoint(mamba_dir, device="cpu")
    tok = Tokenizer(mamba_dir)
    ids = tok.encode("The little model")
    text = _cli(["generate", "--model", str(mamba_dir), "-p",
                 "The little model", "-n", "8", "--temp", "0", "--device",
                 "cpu"])
    want = greedy_ref(cfg, model, ids, 8)
    assert text.strip() == tok.decode(want).strip()
    cfg_j, pj, _ = jax_load(mamba_dir)
    jeng = JaxEngine(cfg_j, pj, n_slots=1, max_len=256,
                     impl="pallas_interpret")
    from vlut_tpu.runtime.engine import Request as JaxRequest
    from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler

    req = JaxRequest(prompt=ids, max_new_tokens=8,
                     sampler=JaxSampler(temperature=0.0))
    jeng.run([req])
    assert req.output == want


@pytest.mark.parametrize("kind", ["mamba2", "rwkv7"])
def test_generate_cli_state_carrying_loops(kind, tmp_path):
    """Mamba2 and RWKV7 checkpoints the port writes (random weights,
    vocabulary 256, tiny_real's tokenizer) through ``generate``: greedy
    text of the JAX loop's tokens on the same file read by the JAX
    package; seeded sampling repeats itself."""
    if kind == "mamba2":
        cfg = ps.Mamba2Config(vocab_size=V, d_model=64, n_layers=2,
                              n_heads=4, head_dim=16, d_state=16, n_groups=2)
        model = ps.init_params_fast(cfg, seed=2, device="cpu")
    else:
        from vlut_tpu_torch.models import rwkv

        cfg = rwkv.Rwkv7Config(vocab_size=V, d_model=32, n_layers=2,
                               head_size=8, d_ff=64)
        model = _random_rwkv7(cfg)
    save_checkpoint(tmp_path, cfg, model, tokenizer_src=TINY_REAL)
    cfg2, model2, meta = load_checkpoint(tmp_path, device="cpu")
    assert meta["model_family"] == kind and cfg2 == cfg
    tok = Tokenizer(tmp_path)
    ids = tok.encode("The little model")
    text = _cli(["generate", "--model", str(tmp_path), "-p",
                 "The little model", "-n", "6", "--temp", "0", "--device",
                 "cpu"])
    cfg_j, pj, _ = jax_load(tmp_path)
    want = jax_family_generate(jax.tree.map(jax.numpy.asarray, pj), cfg_j,
                               ids, 6)
    assert text.strip() == tok.decode(want).strip()
    assert cli.family_generate(model2, cfg2, ids, 6) == want
    sampled = [cli.family_generate(model2, cfg2, ids, 6, temp=0.9, seed=4)
               for _ in range(2)]
    assert sampled[0] == sampled[1]


def _random_rwkv7(cfg):
    """An RWKV7 tree of the JAX converter's layout, from a seed."""
    from vlut_tpu_torch.models.ssm import TreeLM

    g = torch.Generator().manual_seed(3)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff_

    def r(*s, scale=0.2):
        return torch.randn((L,) + s, generator=g) * scale

    names = {"lerp_" + n: (D,) for n in "rwkvag"}
    layers = {n: r(*s).abs() for n, s in names.items()}
    layers.update({
        "ln1_w": r(D).abs() + 0.5, "ln1_b": r(D), "ln2_w": r(D).abs() + 0.5,
        "ln2_b": r(D), "w0": r(D), "w1": r(D, 4), "w2": r(4, D),
        "a0": r(D), "a1": r(D, 4), "a2": r(4, D), "v0": r(D),
        "v1": r(D, 4), "v2": r(4, D), "g1": r(D, 4), "g2": r(4, D),
        "k_k": r(D).abs() + 0.5, "k_a": r(D).abs(), "r_k": r(D),
        "wr": r(D, D), "wk": r(D, D), "wv": r(D, D), "wo": r(D, D),
        "ln_x_w": r(D).abs() + 0.5, "ln_x_b": r(D), "cm_lerp_k": r(D).abs(),
        "cm_key": r(D, F), "cm_value": r(F, D)})
    tree = {"embed": torch.randn((cfg.vocab_size, D), generator=g) * 0.5,
            "pre_ln_w": torch.ones(D), "pre_ln_b": torch.zeros(D),
            "final_norm": torch.ones(D), "final_norm_b": torch.zeros(D),
            "lm_head": torch.randn((D, cfg.vocab_size), generator=g) * 0.3,
            "layers": layers}
    return TreeLM(cfg, tree)


def _http(hostport, path, body=None):
    conn = http.client.HTTPConnection(*hostport, timeout=300)
    conn.request("POST" if body is not None else "GET", path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data) if data else None


@pytest.fixture(scope="module")
def servers(mamba_dir):
    """(port, JAX) servers over the Mamba checkpoint."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
        cfg_j, pj, _ = jax_load(mamba_dir)
        jeng = JaxEngine(cfg_j, pj, n_slots=2, max_len=256,
                         impl="pallas_interpret")
        jhttpd, jstate = jax_serve(jeng, JaxTokenizer(mamba_dir), port=0)
        cfg, model, _ = load_checkpoint(mamba_dir, device="cpu")
        eng = Engine(cfg, model, n_slots=2, max_len=256)
        httpd, state = port_server.serve(eng, Tokenizer(mamba_dir), port=0)
        yield (("127.0.0.1", httpd.server_address[1]),
               ("127.0.0.1", jhttpd.server_address[1]), cfg, model)
        for h, s in ((httpd, state), (jhttpd, jstate)):
            s.stop()
            h.shutdown()
            h.server_close()


def test_server_completion_and_chat_match_jax(servers):
    """A completion equals a direct engine run and the JAX server's; a chat
    (and an infill) answers the JAX server's text."""
    port, jax_port, cfg, model = servers
    body = {"prompt": "The little model", "n_predict": 8, "temperature": 0,
            "return_tokens": True}
    code, got = _http(port, "/completion", body)
    jcode, want = _http(jax_port, "/completion", body)
    assert code == jcode == 200
    ids = Tokenizer(TINY_REAL).encode("The little model")
    direct = Request(prompt=ids, max_new_tokens=8,
                     sampler=SamplerParams(temperature=0.0))
    Engine(cfg, model, n_slots=1, max_len=256).run([direct])
    assert got["tokens"] == direct.output
    assert got["content"] == want["content"]
    chat = {"messages": [{"role": "user", "content": "reads the lines"}],
            "max_tokens": 6, "temperature": 0}
    code, got = _http(port, "/v1/chat/completions", chat)
    jcode, want = _http(jax_port, "/v1/chat/completions", chat)
    assert code == jcode == 200
    assert (got["choices"][0]["message"]["content"]
            == want["choices"][0]["message"]["content"])
    infill = {"input_prefix": "The little ", "input_suffix": " lines",
              "n_predict": 4, "temperature": 0}
    code, got = _http(port, "/infill", infill)
    jcode, want = _http(jax_port, "/infill", infill)
    assert code == jcode == 200 and got["content"] == want["content"]
    code, props = _http(port, "/props")
    assert code == 200 and props["vocab_size"] == V


@pytest.mark.parametrize("path,body", [
    ("/v1/embeddings", {"input": "The little model"}),
    ("/v1/rerank", {"query": "The", "documents": ["little", "model"]})],
    ids=["embeddings", "rerank"])
def test_server_refuses_hidden_state_routes(servers, path, body):
    """Embeddings and rerank on a Mamba engine: the JAX server fails (500,
    its transformer forward on Mamba weights); the port answers 500 with
    the reason."""
    port, jax_port, _, _ = servers
    jcode, _ = _http(jax_port, path, body)
    code, got = _http(port, path, body)
    assert jcode == 500
    assert code == 500 and "transformer checkpoint" in got["error"]


def test_serve_refuses_the_generate_only_families(tmp_path):
    cfg = ps.Mamba2Config(vocab_size=V, d_model=64, n_layers=1, n_heads=4,
                          head_dim=16, d_state=16)
    save_checkpoint(tmp_path, cfg, ps.init_params_fast(cfg, device="cpu"),
                    tokenizer_src=TINY_REAL)
    args = types.SimpleNamespace(
        tp=1, dp=1, draft_model=None, model=[str(tmp_path)], device="cpu",
        promote=None)
    with pytest.raises(ValueError, match="runs through `generate` only"):
        port_server.start_from_args(args)
