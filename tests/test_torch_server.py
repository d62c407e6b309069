"""The port's completion server on ``tiny`` on the CPU (the cases of
tests/test_server.py that the port serves), and its token ids against the
JAX package's server on the same weights and requests."""

import http.client
import json

import jax
import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.serving.server import serve as jax_serve
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.runtime.engine import Engine
from vlut_tpu_torch.serving.server import serve

torch.set_num_threads(1)


class StubTokenizer:
    """Byte-level stand-in for a Hugging Face tokenizer."""

    eos_id = 0
    bos_id = 1

    def encode(self, text, add_bos=True):
        ids = [1] if add_bos else []
        return ids + [2 + (b % 200) for b in text.encode()]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids if i >= 2)

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


def test_unknown_route_404_and_unported_501(server):
    assert _req(server, "POST", "/nope", {})[0] == 404
    assert _req(server, "GET", "/nope")[0] == 404
    for path in ("/v1/chat/completions", "/infill", "/embedding", "/rerank",
                 "/apply-template"):
        assert _req(server, "POST", path, {})[0] == 501, path
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
