"""The encoder family's entry points against the JAX package's: ``cli
embed`` and the embedding-only server, on the JAX server test's checkpoint
(``tests/test_encoder.py::test_encoder_server``: an HF BERT built in code
with a character tokenizer, converted by the JAX converter).

``/v1/embeddings`` of the port's server equals the JAX server's within 2e-5
of the largest value (both pool the same bucketed forward, 16 rows here),
completion, chat and infill answer 400 "embedding-only", ``/props`` and
``/tokenize`` answer as the JAX server's; ``cli embed --json`` gives the
JAX ``embed``'s vectors.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_encoder as enc_tests
from _torch_recurrent import loaded_by
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import encoder as jenc
from vlut_tpu.serving.server import serve_multi as jax_serve_multi
from vlut_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from vlut_tpu_torch import cli
from vlut_tpu_torch.convert import checkpoint as pck
from vlut_tpu_torch.serving.server import serve_multi
from vlut_tpu_torch.utils.tokenizer import Tokenizer

torch.set_num_threads(1)
TOL = 2e-5
TEXTS = ["hello", "hi there, a longer input of some twenty characters"]


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=json.dumps(body) if body is not None
                 else None, headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


@pytest.fixture
def ckpt(tmp_path, monkeypatch):
    return loaded_by(enc_tests.test_encoder_server, tmp_path, monkeypatch)


def test_encoder_server_matches_jax(ckpt):
    cfg, model, _ = pck.load_checkpoint(ckpt, device="cpu")
    cfg_j, params_j, _ = jax_load(ckpt)
    ours, _ = serve_multi({"emb": ((cfg, model), Tokenizer(str(ckpt)))},
                          port=0)
    theirs, _ = jax_serve_multi(
        {"emb": (None, JaxTokenizer(str(ckpt)),
                 (cfg_j, jax.tree.map(jnp.asarray, params_j)))}, port=0)
    p_ours, p_theirs = ours.server_address[1], theirs.server_address[1]
    try:
        got, want = (json.loads(_req(p, "POST", "/v1/embeddings",
                                     {"input": TEXTS})[1])
                     for p in (p_ours, p_theirs))
        assert len(got["data"]) == len(want["data"]) == 2
        for g, w in zip(got["data"], want["data"]):
            g, w = np.asarray(g["embedding"]), np.asarray(w["embedding"])
            assert g.shape == (cfg.d_model,)
            assert np.abs(g - w).max() <= TOL * np.abs(w).max()
            assert abs(np.linalg.norm(g) - 1.0) < 1e-5
        # token-id inputs and the other two routes answer alike
        ids = Tokenizer(str(ckpt)).encode("hello")
        for path in ("/embedding", "/embeddings"):
            st, data = _req(p_ours, "POST", path, {"input": [ids]})
            assert st == 200
            v = np.asarray(json.loads(data)["data"][0]["embedding"])
            assert np.abs(v - np.asarray(got["data"][0]["embedding"])).max() \
                <= 1e-6
        for path, body in (("/completion", {"prompt": "x"}),
                           ("/v1/chat/completions", {"messages": [
                               {"role": "user", "content": "x"}]}),
                           ("/infill", {"input_prefix": "a"})):
            for p in (p_ours, p_theirs):
                st, data = _req(p, "POST", path, body)
                assert st == 400 and "embedding-only" in data.decode()
        props = [json.loads(_req(p, "GET", "/props")[1])
                 for p in (p_ours, p_theirs)]
        assert props[0] == props[1] and props[0]["embedding_only"]
        toks = [json.loads(_req(p, "POST", "/tokenize",
                                {"content": "hello"})[1])
                for p in (p_ours, p_theirs)]
        assert toks[0] == toks[1]
        assert json.loads(_req(p_ours, "GET", "/slots")[1]) == []
    finally:
        for h in (ours, theirs):
            h.shutdown()
            h.server_close()


def test_cli_embed_json(ckpt, capsys):
    cfg_j, params_j, _ = jax_load(ckpt)
    params_j = jax.tree.map(jnp.asarray, params_j)
    tok = Tokenizer(str(ckpt))
    argv = ["embed", "--model", str(ckpt), "--json", "--device", "cpu"]
    for text in TEXTS:
        argv += ["-p", text]
    cli.main(argv)
    out = json.loads(capsys.readouterr().out)
    assert len(out["embeddings"]) == len(TEXTS)
    for text, got in zip(TEXTS, out["embeddings"]):
        ids = tok.encode(text)[:cfg_j.max_seq_len]
        t = jnp.asarray([ids], jnp.int32)
        want = np.asarray(jenc.embed(params_j, cfg_j, t, jnp.ones_like(t)))[0]
        assert np.abs(np.asarray(got) - want).max() <= TOL * np.abs(
            want).max()
    # the plain listing: one line per text, then the cosine matrix
    cli.main(["embed", "--model", str(ckpt), "--device", "cpu", "-p", "a",
              "-p", "b"])
    text = capsys.readouterr().out
    assert "dim=" in text and "cosine matrix:" in text


def test_cli_embed_refuses_a_decoder(capsys):
    with pytest.raises(SystemExit, match="not an encoder-family"):
        cli.main(["embed", "--model", "tests/fixtures/tiny_real", "--device",
                  "cpu"])
