"""The port's server on the CPU: the cases of tests/test_server.py on
``tiny``, and every route's answer against the JAX package's server on the
same weights and requests (``tiny`` with a stub tokenizer, and
``tests/fixtures/tiny_real`` with its own).

The JAX servers run their engines with ``impl="pallas_interpret"``, as
tests/test_torch_engine.py explains.  Its embeddings and rerank call
``forward`` with the default impl, so ``VLUT_TPU_MATMUL_IMPL`` selects the
same interpreted kernels there.  Its tiny_real engine is left unfused
(``fuse=False, unroll=False``): the JAX package's fused tree rounds a
forward of more than 64 rows apart from its own unfused tree (hidden
states up to 0.059 apart on tiny_real), while the port's fused tree, the
port's unfused tree and the JAX unfused tree agree bit for bit.
"""

import http.client
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.serving.server import serve as jax_serve
from vlut_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.runtime.engine import Engine
from vlut_tpu_torch.serving import server as port_server
from vlut_tpu_torch.serving.chat import _parse_tool_calls
from vlut_tpu_torch.serving.server import ServerState, serve, serve_multi
from vlut_tpu_torch.utils.tokenizer import Tokenizer

torch.set_num_threads(1)

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"


class StubTokenizer:
    """Byte-level stand-in for a Hugging Face tokenizer."""

    eos_id = 0
    bos_id = 1
    tk = None  # the JAX server's infill looks here for FIM tokens

    def encode(self, text, add_bos=True):
        ids = [1] if add_bos else []
        return ids + [2 + (b % 200) for b in text.encode()]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids if i >= 2)

    def apply_chat_template(self, messages, add_generation_prompt=True,
                            tools=None):
        out = [1]
        for m in messages:
            out += self.encode(m.get("content", ""), add_bos=False)
        return out

    def make_grammar(self, gbnf):
        from vlut_tpu_torch.runtime.grammar import GrammarSampler

        pieces = [self.decode([i]) for i in range(256)]
        return GrammarSampler(gbnf, pieces, eos_ids=(self.eos_id,))


@pytest.fixture(scope="module")
def params():
    return jt.init_params(JAX_PRESETS["tiny"], seed=0)


def _start(engine):
    httpd, state = serve(engine, StubTokenizer(), port=0)
    return ("127.0.0.1", httpd.server_address[1]), httpd, state


@pytest.fixture(scope="module")
def server(params):
    cfg = PRESETS["tiny"]
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    hostport, httpd, state = _start(Engine(cfg, model, n_slots=2, max_len=64))
    yield hostport
    state.stop()
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def noshift_server(params):
    cfg = PRESETS["tiny"]
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    hostport, httpd, state = _start(
        Engine(cfg, model, n_slots=2, max_len=32, context_shift=False))
    yield hostport
    state.stop()
    httpd.shutdown()
    httpd.server_close()


def _req(hostport, method, path, body=None):
    conn = http.client.HTTPConnection(*hostport, timeout=300)
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None,
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _complete(hostport, **body):
    status, data = _req(hostport, "POST", "/completion",
                        {"temperature": 0.0, "ignore_eos": True, **body})
    assert status == 200, data
    return json.loads(data)


def test_health_metrics_slots_props_models(server):
    status, data = _req(server, "GET", "/health")
    assert status == 200 and json.loads(data)["status"] == "ok"
    status, data = _req(server, "GET", "/metrics")
    assert status == 200 and b"vlut_requests_total" in data
    status, data = _req(server, "GET", "/slots")
    assert status == 200 and len(json.loads(data)) == 2
    status, data = _req(server, "GET", "/props")
    props = json.loads(data)
    assert status == 200 and props["n_slots"] == 2 and props["arch"] == "llama"
    status, data = _req(server, "GET", "/v1/models")
    assert status == 200 and json.loads(data)["data"][0]["object"] == "model"


@pytest.mark.parametrize("path", ["/completion", "/completions",
                                  "/v1/completions"])
def test_completion_routes(server, path):
    status, data = _req(server, "POST", path,
                        {"prompt": "hello", "n_predict": 4,
                         "temperature": 0.0, "ignore_eos": True,
                         "return_tokens": True})
    assert status == 200
    out = json.loads(data)
    assert out["tokens_predicted"] == 4 and len(out["tokens"]) == 4
    assert out["stopped_limit"] is True
    assert out["content"] == StubTokenizer().decode(out["tokens"])


def test_completion_matches_jax_server(server, params):
    """Greedy token ids through the whole server equal the JAX package's
    server on the same weights (its projections through the Pallas kernels
    in interpret mode, as tests/test_torch_engine.py explains)."""
    engine = JaxEngine(JAX_PRESETS["tiny"], params, n_slots=2, max_len=64,
                       impl="pallas_interpret")
    httpd, state = jax_serve(engine, StubTokenizer(), port=0)
    jax_hp = ("127.0.0.1", httpd.server_address[1])
    try:
        for prompt in ("hello", "the cache", "x"):
            body = dict(prompt=prompt, n_predict=6, n_probs=2)
            got, want = _complete(server, **body), _complete(jax_hp, **body)
            assert got["content"] == want["content"]
            assert [p["id"] for p in got["completion_probabilities"]] == [
                p["id"] for p in want["completion_probabilities"]]
    finally:
        state.running = False
        httpd.shutdown()
        httpd.server_close()


def test_tokenize_detokenize(server):
    status, data = _req(server, "POST", "/tokenize", {"content": "abc"})
    ids = json.loads(data)["tokens"]
    assert status == 200 and len(ids) == 3
    status, data = _req(server, "POST", "/detokenize", {"tokens": ids})
    assert status == 200 and json.loads(data)["content"] == "vwx"


def test_streaming_completion(server):
    conn = http.client.HTTPConnection(*server, timeout=300)
    conn.request("POST", "/completion", body=json.dumps(
        {"prompt": "hello", "n_predict": 4, "temperature": 0.0,
         "ignore_eos": True, "stream": True, "return_tokens": True}),
        headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200
    assert r.getheader("Content-Type") == "text/event-stream"
    raw = r.read().decode()
    conn.close()
    events = [json.loads(line[6:]) for line in raw.splitlines()
              if line.startswith("data: ") and line != "data: [DONE]"]
    assert raw.rstrip().endswith("data: [DONE]")
    assert events[-1]["stop"] is True and events[-1]["tokens_predicted"] == 4
    text = "".join(e.get("content", "") for e in events)
    full = _complete(server, prompt="hello", n_predict=4, return_tokens=True)
    assert text == full["content"]
    assert events[-1]["tokens"] == full["tokens"]


def test_stop_strings(server):
    full = _complete(server, prompt="stop test", n_predict=8)["content"]
    assert len(full) >= 4
    stop = full[2:4]
    out = _complete(server, prompt="stop test", n_predict=8,
                    stop=[stop])["content"]
    assert stop not in out and out == full[: full.find(stop)]


def test_completion_logprobs(server):
    out = _complete(server, prompt="lp", n_predict=3, n_probs=4)
    cps = out["completion_probabilities"]
    assert len(cps) == 3
    for e in cps:
        assert len(e["top_logprobs"]) == 4 and e["logprob"] <= 0.0
        best = max(e["top_logprobs"], key=lambda t: t["logprob"])
        assert best["id"] == e["id"]
        assert abs(e["logprob"] - best["logprob"]) < 1e-4


def test_unknown_route_404(server):
    assert _req(server, "POST", "/nope", {})[0] == 404
    assert _req(server, "GET", "/nope")[0] == 404
    # the ported slot actions and grammar fields answer
    status, data = _req(server, "POST", "/slots/0?action=save", {})
    assert status == 200 and json.loads(data)["filename"] == "slot0"
    assert _req(server, "POST", "/slots/0?action=restore", {})[0] == 200
    assert _req(server, "POST", "/slots/0?action=erase", {})[0] == 200
    assert _req(server, "POST", "/slots/0?action=nope", {})[0] == 400
    status, data = _req(server, "POST", "/completion",
                        {"prompt": "a", "grammar": 'root ::= "a"',
                         "n_predict": 4, "temperature": 0})
    assert status == 200 and json.loads(data)["content"] == "a"


def test_over_context_prompt_400(noshift_server):
    status, data = _req(noshift_server, "POST", "/completion",
                        {"prompt": "x" * 100, "n_predict": 4,
                         "temperature": 0.0, "ignore_eos": True})
    assert status == 400
    assert "exceeds context" in json.loads(data)["error"]["message"]
    out = _complete(noshift_server, prompt="ok", n_predict=3)
    assert len(out["content"]) > 0


def test_concurrent_requests_match_serial(server):
    """Sixteen requests in flight at once (more than the slots and the
    cores), with the interpreter switching threads often, each give the
    tokens they give alone, and the server counts every one."""
    import concurrent.futures as cf
    import sys

    prompts = ["alpha", "beta beta", "g", "delta"] * 4
    alone = {p: _complete(server, prompt=p, n_predict=5,
                          return_tokens=True)["tokens"] for p in set(prompts)}
    total = _metric(server, "vlut_requests_total")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with cf.ThreadPoolExecutor(16) as ex:
            together = list(ex.map(
                lambda p: _complete(server, prompt=p, n_predict=5,
                                    return_tokens=True)["tokens"], prompts))
    finally:
        sys.setswitchinterval(interval)
    assert together == [alone[p] for p in prompts]
    assert _metric(server, "vlut_requests_total") == total + len(prompts)
    assert _metric(server, "vlut_requests_errors_total") == 0


def _metric(hostport, name):
    status, data = _req(hostport, "GET", "/metrics")
    assert status == 200
    for line in data.decode().splitlines():
        if line.split(" ")[0] == name:
            return float(line.split()[-1])
    raise KeyError(name)


def test_slot_save_restore_and_constraints(server):
    """A slot saved after a completion restores into the other slot with
    the same cached history; a regex request answers text its constraint
    admits, and a json_schema one that the stub's a-z vocabulary cannot
    spell (no quote piece) ends at once with EOS."""
    _complete(server, prompt="hello", n_predict=3)
    status, data = _req(server, "POST", "/slots/0?action=save",
                        {"filename": "s"})
    saved = json.loads(data)
    assert status == 200 and saved["n_saved"] > 0
    status, data = _req(server, "POST", "/slots/1?action=restore",
                        {"filename": "s"})
    assert status == 200
    assert json.loads(data)["n_restored"] == saved["n_saved"]
    assert _req(server, "POST", "/slots/1?action=restore",
                {"filename": "missing"})[0] == 404
    out = _complete(server, prompt="x", n_predict=6, regex="[ab]{2}c",
                    ignore_eos=False)
    assert out["content"] in ("aac", "abc", "bac", "bbc")
    out = _complete(server, prompt="x", n_predict=8, ignore_eos=False,
                    response_format={"type": "json_schema", "json_schema": {
                        "schema": {"enum": ["cab", "bad"]}}})
    assert out["content"] == "" and out["tokens_predicted"] == 1


# --- the routes of the rest of the server, against the JAX package's -------

def _post(hostport, path, **body):
    status, data = _req(hostport, "POST", path, body)
    assert status == 200, data
    return json.loads(data)


def _stop(httpd, states):
    for st in states:
        st.running = False
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def real_pair():
    """(port, JAX) servers over tiny_real, each with its tokenizer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
        cfg_j, params_j, _ = jax_load(TINY_REAL, stream=False)
        jeng = JaxEngine(cfg_j, params_j, n_slots=2, max_len=256,
                         impl="pallas_interpret", fuse=False, unroll=False)
        jhttpd, jstate = jax_serve(jeng, JaxTokenizer(TINY_REAL), port=0)
        cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
        httpd, state = serve(Engine(cfg, model, n_slots=2, max_len=256),
                             Tokenizer(TINY_REAL), port=0)
        yield (("127.0.0.1", httpd.server_address[1]),
               ("127.0.0.1", jhttpd.server_address[1]))
        _stop(httpd, [state])
        _stop(jhttpd, [jstate])


CHAT = [{"role": "system", "content": "Be brief."},
        {"role": "user", "content": "The little model reads"}]


@pytest.mark.parametrize("extra", [
    {}, {"logprobs": True, "top_logprobs": 3}, {"n": 3}, {"stream": True}],
    ids=["plain", "logprobs", "n3", "stream"])
def test_chat_matches_jax_server(real_pair, extra):
    """Greedy chat: the port's answer equals the JAX server's (content,
    log-prob tokens, every one of n choices); a streamed answer's deltas
    join to the same content."""
    port, jax_hp = real_pair
    body = dict(messages=CHAT, max_tokens=8, temperature=0.0,
                ignore_eos=True, **extra)
    if extra.get("stream"):
        conn = http.client.HTTPConnection(*port, timeout=300)
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body))
        r = conn.getresponse()
        assert r.getheader("Content-Type") == "text/event-stream"
        events = [json.loads(line[6:]) for line in r.read().decode()
                  .splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        conn.close()
        text = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events)
        assert events[-1]["choices"][0]["finish_reason"] == "length"
        body.pop("stream")
        want = _post(jax_hp, "/v1/chat/completions", **body)
        assert text == want["choices"][0]["message"]["content"]
        return
    got = _post(port, "/v1/chat/completions", **body)
    want = _post(jax_hp, "/v1/chat/completions", **body)
    assert [c["message"] for c in got["choices"]] == [
        c["message"] for c in want["choices"]]
    assert got["usage"] == want["usage"]
    assert len(got["choices"]) == extra.get("n", 1)
    if "logprobs" in extra:
        lp, wl = (a["choices"][0]["logprobs"]["content"]
                  for a in (got, want))
        assert [e["token"] for e in lp] == [e["token"] for e in wl]
        assert [[t["token"] for t in e["top_logprobs"]] for e in lp] == [
            [t["token"] for t in e["top_logprobs"]] for e in wl]
        np.testing.assert_allclose([e["logprob"] for e in lp],
                                   [e["logprob"] for e in wl], atol=1e-4)


def test_chat_seeded_siblings(real_pair):
    """Seeded n > 1 (temperature 1.5, top-k 4): the siblings differ; on a
    one-slot engine sibling j is the single request at seed + j (a row's
    generator is seeded from its seed and its slot); and the first tokens
    of the port's and of the JAX server's siblings each follow the model's
    top-4 distribution at the prompt (Pearson's chi-square with 3 degrees
    of freedom below 16.27, its 1e-3 tail).  The two packages draw from
    different generators (Philox, threefry), so they agree in
    distribution, not token for token."""
    from vlut_tpu_torch.models.transformer import forward

    port, jax_hp = real_pair
    n, temp, seed = 48, 1.5, 100
    body = dict(messages=CHAT, max_tokens=1, temperature=temp, top_k=4,
                top_p=1.0, min_p=0.0, seed=seed, ignore_eos=True)
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    tok = Tokenizer(TINY_REAL)
    httpd, state = serve(Engine(cfg, model, n_slots=1, max_len=256), tok,
                         port=0)
    try:
        one_slot = ("127.0.0.1", httpd.server_address[1])
        sibs = _post(one_slot, "/v1/chat/completions", n=n,
                     return_tokens=True, **body)["choices"]
        assert len({tuple(c["tokens"]) for c in sibs}) > 1
        for j in (0, 1, n - 1):
            one = _post(one_slot, "/v1/chat/completions", return_tokens=True,
                        **{**body, "seed": seed + j})["choices"][0]
            assert one["tokens"] == sibs[j]["tokens"]
    finally:
        _stop(httpd, [state])
    ids = tok.apply_chat_template(CHAT)
    with torch.inference_mode():
        logits = forward(model, cfg, torch.tensor([ids]),
                         torch.arange(len(ids))[None], None)[0][0, -1]
    top = torch.topk(logits[:cfg.vocab_size].float(), 4)
    p = torch.softmax(top.values / temp, -1).numpy()
    pieces = [tok.decode([int(i)]) for i in top.indices]
    for hp in (port, jax_hp):
        texts = [c["message"]["content"] for c in _post(
            hp, "/v1/chat/completions", n=n, **body)["choices"]]
        assert set(texts) <= set(pieces)
        counts = np.asarray([texts.count(s) for s in pieces])
        assert ((counts - n * p) ** 2 / (n * p)).sum() < 16.27, (counts, p)


TOOLS = [{"type": "function", "function": {
    "name": "get_w", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}},
        "required": ["city"]}}}]


@pytest.mark.parametrize("choice", [
    "required", {"type": "function", "function": {"name": "get_w"}}, "auto"],
    ids=["required", "named", "auto"])
def test_chat_tools_match_jax_server(real_pair, choice):
    """Chat with tools: the grammar ("required", a named function) or the
    lazy grammar ("auto") gives the JAX server's tokens.  tiny_real's
    decode joins its pieces with spaces, so a call is read from the pieces
    joined as they are (the server's content holds the spaced text)."""
    port, jax_hp = real_pair
    body = dict(messages=[{"role": "user", "content": "weather?"}],
                max_tokens=120, temperature=0.0, tools=TOOLS,
                tool_choice=choice)
    got = _post(port, "/v1/chat/completions", return_tokens=True, **body)
    want = _post(jax_hp, "/v1/chat/completions", **body)
    assert got["choices"][0]["message"] == want["choices"][0]["message"]
    if choice != "auto":
        pieces = Tokenizer(TINY_REAL).pieces()
        text = "".join(pieces[t] for t in got["choices"][0]["tokens"])
        calls, _ = _parse_tool_calls(text)
        assert calls and calls[0]["name"] == "get_w"
        assert set(calls[0]["arguments"]) == {"city"}


def test_infill_and_template_match_jax_server(real_pair):
    """``/infill`` without FIM tokens completes the prefix (the JAX server's
    tokens, and ``/completion``'s); ``/apply-template`` renders ChatML."""
    port, jax_hp = real_pair
    body = dict(input_prefix="The little model", input_suffix=" repo.",
                n_predict=8, temperature=0.0, ignore_eos=True)
    got = _post(port, "/infill", **body)
    assert got == _post(jax_hp, "/infill", **body)
    comp = _post(port, "/completion", prompt="The little model", n_predict=8,
                 temperature=0.0, ignore_eos=True)
    assert got["content"] == comp["content"]
    got = _post(port, "/apply-template", messages=CHAT)
    assert got == _post(jax_hp, "/apply-template", messages=CHAT)
    assert got["prompt"].startswith("< | i m _ s t a r t | > s y s t e m")


EMBED_TEXTS = ["The little model reads the lines of its own repo.", "reads",
               "of its own repo, and then some more words than sixteen", "T"]


@pytest.mark.parametrize("n_inputs", [1, 4], ids=["M16", "M256"])
@pytest.mark.parametrize("pooling", ["mean", "last", "cls"])
@pytest.mark.parametrize("path", ["/v1/embeddings", "/embedding"])
def test_embeddings_match_jax_server(real_pair, path, pooling, n_inputs):
    """One input (bucket 16: 16 rows, the small-M projections) and four
    (bucket 64: 256 rows, the tiled GEMM): unit vectors within 1e-3 of the
    JAX server's."""
    port, jax_hp = real_pair
    body = dict(input=EMBED_TEXTS[:n_inputs], pooling=pooling)
    got, want = _post(port, path, **body), _post(jax_hp, path, **body)
    assert got["usage"] == want["usage"]
    g = np.asarray([d["embedding"] for d in got["data"]])
    w = np.asarray([d["embedding"] for d in want["data"]])
    assert g.shape == (n_inputs, 128)
    np.testing.assert_allclose(np.linalg.norm(g, axis=-1), 1.0, rtol=1e-5)
    assert np.abs(g - w).max() <= 1e-3


def test_embeddings_of_token_ids_and_bad_pooling(real_pair):
    port, _ = real_pair
    ids = Tokenizer(TINY_REAL).encode("The little model")
    a = _post(port, "/embeddings", input=[ids], pooling="last")
    b = _post(port, "/embeddings", input="The little model", pooling="last")
    assert a["data"][0]["embedding"] == b["data"][0]["embedding"]
    assert _req(port, "POST", "/embeddings",
                {"input": "x", "pooling": "max"})[0] == 500


@pytest.mark.parametrize("path", ["/v1/rerank", "/rerank", "/reranking"])
def test_rerank_matches_jax_server(real_pair, path):
    """Mean document log-prob given the query: within rtol 1e-3 of the JAX
    server's scores, in the same order; ``top_n`` keeps the best."""
    port, jax_hp = real_pair
    body = dict(query="The little model",
                documents=[" reads the lines", " zq xv kj", " of its own "
                           "repo and more words past one chunk of rows",
                           "!!"])
    got, want = _post(port, path, **body), _post(jax_hp, path, **body)
    assert [r["index"] for r in got["results"]] == [
        r["index"] for r in want["results"]]
    np.testing.assert_allclose(
        [r["relevance_score"] for r in got["results"]],
        [r["relevance_score"] for r in want["results"]], rtol=1e-3)
    top = _post(port, path, top_n=2, **body)["results"]
    assert top == got["results"][:2]


def test_rerank_with_rank_head():
    """A checkpoint carrying a classification head (``rank_head``, carried
    over by params_from_numpy) scores with it: the last hidden row of query
    + document through the head, against the JAX package's unfused
    forward, as tests/test_server.py::test_rerank_with_rank_head holds the
    JAX server."""
    import jax.numpy as jnp

    cfg_j, cfg = JAX_PRESETS["tiny"], PRESETS["tiny"]
    params = jt.init_params(cfg_j, seed=0)
    rng = np.random.default_rng(3)
    params["rank_head"] = {
        "w": rng.standard_normal((cfg_j.d_model, 1)).astype(np.float32),
        "b": np.asarray([0.25], np.float32)}
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    assert torch.equal(model.tree()["rank_head"]["b"], torch.tensor([0.25]))
    httpd, state = serve(Engine(cfg, model, n_slots=1, max_len=64),
                         StubTokenizer(), port=0)
    try:
        hp = ("127.0.0.1", httpd.server_address[1])
        res = {r["index"]: r["relevance_score"] for r in _post(
            hp, "/v1/rerank", query="q", documents=["aa", "bbbb"])["results"]}
        tok = StubTokenizer()
        for i, doc in enumerate(["aa", "bbbb"]):
            ids = tok.encode("q") + tok.encode(doc, add_bos=False)
            h, _ = jt.forward(params, cfg_j, jnp.asarray([ids], jnp.int32),
                              jnp.arange(len(ids), dtype=jnp.int32)[None],
                              None, output="hidden", impl="pallas_interpret")
            want = float(np.asarray(h)[0, -1].astype(np.float32)
                         @ params["rank_head"]["w"][:, 0] + 0.25)
            np.testing.assert_allclose(res[i], want, rtol=2e-3)
    finally:
        _stop(httpd, [state])


def test_webui(server):
    """``GET /`` and ``/index.html`` serve the port's copy of the web UI,
    byte for byte the JAX package's."""
    import vlut_tpu.serving

    ui = pathlib.Path(port_server.__file__).parent / "webui.html"
    assert ui.read_bytes() == (pathlib.Path(vlut_tpu.serving.__file__).parent
                               / "webui.html").read_bytes()
    for path in ("/", "/index.html"):
        conn = http.client.HTTPConnection(*server, timeout=60)
        conn.request("GET", path)
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type") == "text/html; charset=utf-8"
        assert r.read() == ui.read_bytes()
        conn.close()


def test_multi_model_router(params):
    """Two engines behind one port, routed by ``model``: /v1/models lists
    both, each answers with its own weights, no field takes the default
    and an unknown name answers 404."""
    cfg = PRESETS["tiny"]
    engines = {
        name: Engine(cfg, params_from_numpy(jax.tree.map(
            np.asarray, jt.init_params(JAX_PRESETS["tiny"], seed=seed)), cfg),
            n_slots=1, max_len=48)
        for name, seed in (("alpha", 1), ("beta", 2))}
    httpd, router = serve_multi(
        {n: (e, StubTokenizer()) for n, e in engines.items()}, port=0,
        default="beta")
    hp = ("127.0.0.1", httpd.server_address[1])
    try:
        status, data = _req(hp, "GET", "/v1/models")
        assert {m["id"] for m in json.loads(data)["data"]} == {"alpha",
                                                                "beta"}
        body = {"prompt": "route", "n_predict": 3, "temperature": 0.0,
                "ignore_eos": True, "return_tokens": True}
        a = _post(hp, "/completion", model="alpha", **body)["tokens"]
        b = _post(hp, "/completion", model="beta", **body)["tokens"]
        assert a != b
        assert _post(hp, "/completion", **body)["tokens"] == b
        assert _req(hp, "POST", "/completion",
                    {**body, "model": "nope"})[0] == 404
        assert _req(hp, "POST", "/v1/embeddings",
                    {"input": "x", "model": "nope"})[0] == 404
        emb = _post(hp, "/v1/embeddings", input="x", model="alpha")
        assert emb["model"] == "alpha"
    finally:
        _stop(httpd, router.states.values())


def test_models_of_one_device_share_the_engine_lock():
    """serve_multi gives the models of one device one lock, so one model's
    steps and forwards never run while another captures a CUDA graph."""
    cfg = PRESETS["tiny"]
    model = params_from_numpy(jax.tree.map(
        np.asarray, jt.init_params(JAX_PRESETS["tiny"], seed=0)), cfg)
    httpd, router = serve_multi(
        {n: (Engine(cfg, model, n_slots=1, max_len=32), StubTokenizer())
         for n in ("a", "b")}, port=0, start_engine=False)
    httpd.shutdown()
    httpd.server_close()
    assert router.states["a"].lock is router.states["b"].lock
    assert ServerState(router.states["a"].engine, StubTokenizer()).lock \
        is not router.states["a"].lock


def test_serve_cli_models_and_promote():
    """``serve --model a=DIR --model b=DIR --promote i1``: both names
    listed, each engine holds the i1 repack, and its greedy tokens are the
    i2 checkpoint's."""
    import argparse

    ap = argparse.ArgumentParser()
    port_server.add_server_args(ap)
    args = ap.parse_args(["--model", f"a={TINY_REAL}", "--model",
                          f"b={TINY_REAL}", "--promote", "i1", "--port", "0",
                          "--slots", "1", "--ctx", "128", "--device", "cpu"])
    httpd, router = port_server.start_from_args(args)
    hp = ("127.0.0.1", httpd.server_address[1])
    try:
        status, data = _req(hp, "GET", "/v1/models")
        assert [m["id"] for m in json.loads(data)["data"]] == ["a", "b"]
        status, data = _req(hp, "GET", "/props")
        assert json.loads(data)["weight_fmt"] == "i1"
        body = {"prompt": "The little model", "n_predict": 6,
                "temperature": 0.0, "ignore_eos": True, "return_tokens": True}
        got = _post(hp, "/completion", model="b", **body)["tokens"]
    finally:
        _stop(httpd, router.states.values())
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    httpd, state = serve(Engine(cfg, model, n_slots=1, max_len=128),
                         Tokenizer(TINY_REAL), port=0)
    try:
        want = _post(("127.0.0.1", httpd.server_address[1]), "/completion",
                     **body)["tokens"]
    finally:
        _stop(httpd, [state])
    assert got == want
