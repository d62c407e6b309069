"""OpenAI-compatible HTTP server over the slot engine (port of
vlut_tpu/serving/server.py).

A stdlib ThreadingHTTPServer parks each request's thread on an event while
one engine thread per model drives ``Engine.step()`` (continuous
batching).

  POST /completion, /completions, /v1/completions  — completion (+SSE)
  POST /v1/chat/completions                        — chat (+SSE, tools, n)
  POST /infill                                     — fill-in-middle
  POST /embedding, /embeddings, /v1/embeddings     — pooled final hidden
  POST /rerank, /reranking, /v1/rerank             — query/document scores
  POST /tokenize, /detokenize                      — vocabulary round-trips
  POST /apply-template                             — chat template only
  POST /slots/{id}?action=save|restore|erase       — slot state
  GET  /, /index.html                              — the web UI
  GET  /health, /metrics, /slots, /props, /v1/models

Request fields as in the JAX package (prompt as text or token ids,
n_predict / max_tokens, the sampler fields, stop strings, stream,
ignore_eos, n_probs / logprobs + top_logprobs, and the constraints
``grammar`` (GBNF, with ``grammar_lazy`` + ``grammar_triggers``), ``regex``
/ ``guided_regex``, ``json_schema`` and ``response_format``).  Chat takes
``messages``, ``n``, and ``tools`` with ``tool_choice`` ("required" or a
named function: a tool-call grammar; "auto": the same grammar, lazy until
``<tool_call>``); its answer splits a leading reasoning block into
``reasoning_content`` and parses tool calls (``serving/chat.py``).
Embeddings take ``input`` (texts or token id lists) and ``pooling`` (mean,
last, cls); rerank takes ``query``, ``documents`` and ``top_n``.
``return_tokens: true`` adds the generated token ids (``tokens``) to a
completion, chat choice or infill answer, and to the last event of a
stream.  A slot save keeps the state in the server's memory under
``filename`` (default ``slot<id>``).  Several models are served by
repeating ``--model NAME=DIR``; a request picks one by its ``model`` field
(an unknown name answers 404 when more than one is loaded).

    python -m vlut_tpu_torch.serving.server --model [NAME=]DIR
        [--model NAME=DIR ...] [--port 8080] [--slots 8] [--ctx 4096]
        [--cache-type bf16|q8] [--decode-attn fused|composed]
        [--promote i2|i1] [--draft-model DIR [--draft-k 4]]
        [--lookahead [--lookahead-window 8] [--lookahead-ngram 3]]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from vlut_tpu_torch.models.transformer import forward, project_head
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams
from vlut_tpu_torch.serving.chat import _parse_tool_calls, _split_reasoning

WEBUI = pathlib.Path(__file__).parent / "webui.html"
POOLINGS = ("mean", "last", "cls")
RERANK_CHUNK = 32  # rows of T per head call: (B, T, V) logits are GBs


def _bucket(t: int) -> int:
    """The padded length of a cacheless forward: 16 * 2**k >= t."""
    bucket = 16
    while bucket < t:
        bucket *= 2
    return bucket


def _padded(seqs: list[list[int]], dev) -> tuple[torch.Tensor, ...]:
    """(tokens, positions, lengths) on ``dev``: each row padded with token 0
    to the bucket, every row at positions 0 .. bucket - 1 (pad rows
    included, as the JAX package gives them)."""
    bucket = _bucket(max(1, max(len(s) for s in seqs)))
    toks = torch.zeros((len(seqs), bucket), dtype=torch.long)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = torch.tensor(s, dtype=torch.long)
    pos = torch.arange(bucket).expand(len(seqs), bucket)
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.long)
    return toks.to(dev), pos.to(dev), lens.to(dev)


def pool_hidden(hidden: torch.Tensor, lens: torch.Tensor,
                pooling: str) -> torch.Tensor:
    """float32 (B, D) of final hidden states (B, T, D): the mean over each
    row's first ``lens`` positions, its last one, or its first (cls)."""
    h = hidden.to(torch.float32)
    if pooling == "mean":
        valid = torch.arange(h.shape[1], device=h.device)[None] < lens[:, None]
        return ((h * valid[..., None]).sum(1)
                / torch.clamp(lens[:, None], min=1).to(torch.float32))
    if pooling == "last":
        return h[torch.arange(h.shape[0], device=h.device), lens - 1]
    if pooling == "cls":
        return h[:, 0]
    raise ValueError(f"pooling must be one of {POOLINGS}")


class ServerState:
    def __init__(self, engine: Engine, tokenizer, model_name: str = "vlut-tpu",
                 lock: threading.Lock | None = None):
        self.engine = engine
        self.tok = tokenizer
        self.model_name = model_name
        # the models of one device share one lock (serve_multi)
        self.lock = lock or threading.Lock()
        self.events: dict[int, threading.Event] = {}
        self.metrics = {
            "prompt_tokens_total": 0,
            "generated_tokens_total": 0,
            "requests_total": 0,
            "requests_errors_total": 0,
        }
        self.running = True
        # saved slot states by filename (POST /slots/{id}?action=save)
        self.slot_files: dict[str, bytes] = {}
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()

    def stop(self):
        self.running = False

    def _loop(self):
        while self.running:
            with self.lock:
                try:
                    busy = self.engine.step()
                except Exception:  # noqa: BLE001
                    # one bad request must not kill the engine thread (every
                    # in-flight and future request would hang): fail what is
                    # in flight, count the error, keep serving
                    traceback.print_exc()
                    self.metrics["requests_errors_total"] += 1
                    for r in list(self.engine.queue):
                        self.engine.cancel(r.rid)
                    for s in self.engine.slots:
                        if s.req is not None:
                            self.engine.cancel(s.req.rid)
                    busy = False
                done = [rid for rid in self.events if self._find_done(rid)]
                for rid in done:
                    self.events[rid].set()
            if not busy:
                time.sleep(0.005)

    def _find_done(self, rid: int) -> bool:
        if any(r.rid == rid for r in self.engine.queue):
            return False
        return not any(s.req is not None and s.req.rid == rid
                       for s in self.engine.slots)

    def submit(self, req: Request) -> threading.Event:
        ev = threading.Event()
        with self.lock:
            rid = self.engine.submit(req)
            self.events[rid] = ev
            self.metrics["requests_total"] += 1
            self.metrics["prompt_tokens_total"] += len(req.prompt)
        return ev

    def finish(self, req: Request):
        with self.lock:
            self.events.pop(req.rid, None)
            self.metrics["generated_tokens_total"] += len(req.output)

    def cancel(self, req: Request):
        with self.lock:
            self.engine.cancel(req.rid)
            ev = self.events.pop(req.rid, None)
        if ev:
            ev.set()

    # --- cacheless forwards: embeddings and rerank ---------------------------
    #
    # Both run under the engine lock, between two engine steps, where the
    # JAX package runs them without it: the engine thread captures its step
    # programs as CUDA graphs, and a forward launched from another thread
    # during a capture would invalidate it.  The same holds across models:
    # serve_multi gives every model on one device the same lock, so one
    # model's steps and forwards never run during another's capture.  A
    # long embedding batch thus delays the next decode step of every model
    # on its device by its own time.

    def embed(self, ids_list: list[list[int]],
              pooling: str = "mean") -> np.ndarray:
        """L2-normalised pooled final hidden states (B, D) float32 of token
        id lists, in one padded forward (pooling: mean | last | cls)."""
        if pooling not in POOLINGS:
            raise ValueError(f"pooling must be one of {POOLINGS}")
        eng = self.engine
        toks, pos, lens = _padded(ids_list, eng.device)
        with self.lock, torch.inference_mode():
            hidden, _ = forward(eng.params, eng.cfg, toks, pos, None,
                                output="hidden")
            out = pool_hidden(hidden, lens, pooling).cpu().numpy()
        norms = np.linalg.norm(out, axis=-1, keepdims=True)
        return out / np.maximum(norms, 1e-12)

    def rerank(self, query_ids: list[int],
               doc_ids_list: list[list[int]]) -> list[float]:
        """Relevance of each document to the query: the model's
        ``rank_head`` on the last hidden row of query + document, or else
        the mean log-prob of the document tokens given the query, from one
        padded forward and a head applied ``RERANK_CHUNK`` rows of T at a
        time (logits cut to the vocabulary)."""
        eng, cfg = self.engine, self.engine.cfg
        params = eng.params
        seqs = [list(query_ids) + list(d) for d in doc_ids_list]
        toks, pos, lens = _padded(seqs, eng.device)
        b, t = toks.shape
        with self.lock, torch.inference_mode():
            hidden, _ = forward(params, cfg, toks, pos, None, output="hidden")
            if hasattr(params, "rank_head_w"):
                last = hidden[torch.arange(b, device=toks.device),
                              lens - 1].to(torch.float32)
                sc = last @ params.rank_head_w.to(torch.float32)
                if hasattr(params, "rank_head_b"):
                    sc = sc + params.rank_head_b.to(torch.float32)
                return sc[:, 0].tolist()
            targets = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])],
                                dim=1)
            lps = []
            for c in range(0, t, RERANK_CHUNK):
                lg = project_head(params, hidden[:, c:c + RERANK_CHUNK])[
                    ..., :cfg.vocab_size]
                tg = targets[:, c:c + RERANK_CHUNK, None]
                lps.append(lg.gather(-1, tg)[..., 0]
                           - torch.logsumexp(lg, dim=-1))
            lps = torch.cat(lps, dim=1)
            # the mean over the document's region [q_len - 1, len - 1)
            idx = torch.arange(t, device=toks.device)[None]
            m = (idx >= len(query_ids) - 1) & (idx < lens[:, None] - 1)
            tot = (lps * m).sum(-1)
            return (tot / torch.clamp(m.sum(-1), min=1)).tolist()


def _sampler_from_body(body: dict[str, Any]) -> SamplerParams:
    bias: list[tuple[int, float]] = []
    lb = body.get("logit_bias")
    if isinstance(lb, dict):
        bias = [(int(k), float(v)) for k, v in lb.items()]
    elif isinstance(lb, list):
        bias = [(int(t), float(v)) for t, v in lb]
    mirostat = int(body.get("mirostat", 0))
    return SamplerParams(
        temperature=float(body.get("temperature", 0.8)),
        top_k=int(body.get("top_k", 40)),
        top_p=float(body.get("top_p", 0.95)),
        min_p=float(body.get("min_p", 0.05)),
        typical_p=float(body.get("typ_p", body.get("typical_p", 1.0))),
        dynatemp_range=float(body.get("dynatemp_range", 0.0)),
        dynatemp_exponent=float(body.get("dynatemp_exponent", 1.0)),
        xtc_p=float(body.get("xtc_probability", 0.0)),
        xtc_t=float(body.get("xtc_threshold", 0.1)),
        top_n_sigma=float(body.get("top_n_sigma", 0.0)),
        mirostat_tau=float(body.get("mirostat_tau", 5.0)) if mirostat else 0.0,
        mirostat_eta=float(body.get("mirostat_eta", 0.1)),
        repeat_penalty=float(body.get("repeat_penalty", 1.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        penalty_last_n=int(body.get("repeat_last_n", 64)),
        dry_multiplier=float(body.get("dry_multiplier", 0.0)),
        dry_base=float(body.get("dry_base", 1.75)),
        dry_allowed_length=int(body.get("dry_allowed_length", 2)),
        logit_bias=tuple(bias),
        seed=int(body.get("seed", 0)),
    )


def _grammar_from_body(body: dict[str, Any], tok):
    """The request's constraint as a grammar sampler bound to the
    tokenizer's vocabulary, or None: ``grammar`` (GBNF; lazy with
    ``grammar_lazy`` and ``grammar_triggers``), ``regex`` /
    ``guided_regex``, ``json_schema``, or ``response_format`` of type
    ``json_schema`` / ``json_object``."""
    from vlut_tpu_torch.runtime.grammar import (
        LazyGrammarSampler,
        json_schema_to_gbnf,
        regex_to_gbnf,
    )

    if body.get("grammar"):
        g = tok.make_grammar(body["grammar"])
        trig = body.get("grammar_triggers")
        if body.get("grammar_lazy") and trig:
            g = LazyGrammarSampler(g, trig)
        return g
    rx = body.get("regex") or body.get("guided_regex")
    if rx:
        return tok.make_grammar(regex_to_gbnf(rx))
    schema = body.get("json_schema")
    rf = body.get("response_format") or {}
    if schema is None and rf.get("type") == "json_schema":
        schema = (rf.get("json_schema") or {}).get("schema", {})
    if schema is None and rf.get("type") == "json_object":
        schema = {}
    if schema is not None:
        return tok.make_grammar(json_schema_to_gbnf(schema))
    return None


class Router:
    """Multi-model routing: a request picks a model's state by its
    ``model`` field; no field, or a name not loaded while only one model
    is, takes the default; an unknown name raises KeyError (404) when
    several are loaded."""

    def __init__(self):
        self.states: dict[str, ServerState] = {}
        self.default_name: str | None = None

    def add(self, name: str, state: ServerState, default: bool = False):
        self.states[name] = state
        if default or self.default_name is None:
            self.default_name = name

    def resolve(self, name: str | None) -> ServerState:
        if name and name not in self.states and len(self.states) > 1:
            raise KeyError(name)
        return self.states[name if name in self.states
                           else self.default_name]


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _resolve(self, body=None) -> bool:
            """Picks this request's model; answers 404 for an unknown
            one."""
            name = body.get("model") if isinstance(body, dict) else None
            try:
                self.st = router.resolve(name)
            except KeyError:
                self._json(404, {"error": f"unknown model {name!r}"})
                return False
            return True

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj: Any):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

        def _sse(self, obj: Any):
            self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
            self.wfile.flush()

        # --- GET -----------------------------------------------------------

        def do_GET(self):
            path = urlparse(self.path).path
            if not self._resolve():
                return
            eng = self.st.engine
            if path in ("/", "/index.html"):
                # the single-file chat web UI
                data = WEBUI.read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/health":
                self._json(200, {"status": "ok"})
            elif path == "/metrics":
                self._metrics()
            elif path == "/slots":
                self._json(200, [
                    {"id": i, "busy": s.req is not None, "length": s.length,
                     "generated": s.generated,
                     "cached_tokens": len(s.history)}
                    for i, s in enumerate(eng.slots)])
            elif path == "/props":
                cfg = eng.cfg
                self._json(200, {
                    "model": self.st.model_name,
                    "n_ctx": eng.max_len,
                    "n_slots": eng.n_slots,
                    "arch": cfg.arch,
                    "weight_fmt": cfg.weight_fmt,
                    "vocab_size": cfg.vocab_size,
                    "bos_token_id": self.st.tok.bos_id,
                    "eos_token_id": self.st.tok.eos_id,
                })
            elif path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": name, "object": "model", "owned_by": "vlut-tpu"}
                    for name in router.states]})
            else:
                self._json(404, {"error": "not found"})

        def _metrics(self):
            lines = []
            for k, v in self.st.metrics.items():
                lines += [f"# TYPE vlut_{k} counter", f"vlut_{k} {v}"]
            eng = self.st.engine
            busy = sum(1 for s in eng.slots if s.req is not None)
            used = sum(s.length + s.generated for s in eng.slots
                       if s.req is not None)
            cap = eng.n_slots * eng.max_len
            perf = eng.perf
            gauges = {
                "slots_busy": busy,
                "slots_total": eng.n_slots,
                "slots_idle": eng.n_slots - busy,
                "requests_processing": busy,
                "requests_deferred": len(eng.queue),
                "kv_cache_usage_ratio": round(used / cap, 6) if cap else 0.0,
                "kv_cache_tokens": used,
                "prompt_tokens_seconds": round(
                    perf.n_prompt_tokens / perf.t_prompt_s
                    if perf.t_prompt_s else 0.0, 3),
                "predicted_tokens_seconds": round(
                    perf.n_decode_tokens / perf.t_decode_s
                    if perf.t_decode_s else 0.0, 3),
                "n_past_max": max((s.length + s.generated
                                   for s in eng.slots), default=0),
                "n_tokens_reused": perf.n_reused_tokens,
                "n_drafted_total": perf.n_spec_drafted,
                "n_drafted_accepted_total": perf.n_spec_accepted,
            }
            for k, v in gauges.items():
                lines += [f"# TYPE vlut_{k} gauge", f"vlut_{k} {v}"]
            data = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        # --- POST ----------------------------------------------------------

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                self._json(400, {"error": "bad json"})
                return
            if not self._resolve(body):
                return
            parsed = urlparse(self.path)
            path = parsed.path
            try:
                if path in ("/completion", "/completions", "/v1/completions"):
                    self._completion(body)
                elif path == "/v1/chat/completions":
                    self._chat(body)
                elif path == "/infill":
                    self._infill(body)
                elif path in ("/embedding", "/embeddings", "/v1/embeddings"):
                    self._embedding(body)
                elif path in ("/rerank", "/reranking", "/v1/rerank"):
                    self._rerank(body)
                elif path == "/tokenize":
                    ids = self.st.tok.encode(
                        body.get("content", ""),
                        add_bos=bool(body.get("add_special", False)))
                    self._json(200, {"tokens": ids})
                elif path == "/detokenize":
                    self._json(200, {
                        "content": self.st.tok.decode(body.get("tokens", []))})
                elif path == "/apply-template":
                    ids = self.st.tok.apply_chat_template(
                        body.get("messages", []))
                    self._json(200, {"prompt": self.st.tok.decode(ids)})
                elif path.startswith("/slots/"):
                    self._slot_action(path, parsed.query, body)
                else:
                    self._json(404, {"error": "not found"})
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001
                self.st.metrics["requests_errors_total"] += 1
                self._json(500, {"error": str(e)})

        # --- the run loop with stop strings and optional streaming ----------

        def _make_request(self, prompt_ids, body) -> Request:
            stop_tok = ()
            if self.st.tok.eos_id is not None and not body.get(
                    "ignore_eos", False):
                stop_tok = (self.st.tok.eos_id,)
            n_probs = int(body.get("n_probs", 0))
            if body.get("logprobs"):
                n_probs = max(n_probs, int(body.get("top_logprobs", 1)), 1)
            return Request(
                prompt=prompt_ids,
                max_new_tokens=int(body.get("n_predict",
                                            body.get("max_tokens", 128))),
                sampler=_sampler_from_body(body),
                stop_tokens=stop_tok,
                grammar=_grammar_from_body(body, self.st.tok),
                n_probs=min(n_probs, 16),
            )

        def _probs_payload(self, req: Request):
            out = []
            for tok, (ids, lps, chosen) in zip(req.output, req.logprobs):
                out.append({
                    "id": int(tok),
                    "token": self.st.tok.decode([int(tok)]),
                    "logprob": chosen,
                    "top_logprobs": [
                        {"id": int(i), "token": self.st.tok.decode([int(i)]),
                         "logprob": float(lp)}
                        for i, lp in zip(ids, lps)],
                })
            return out

        @staticmethod
        def _stop_strings(body) -> list[str]:
            stop = body.get("stop", [])
            if isinstance(stop, str):
                stop = [stop]
            return [s for s in stop if s]

        def _run_collect(self, req: Request, stops: list[str],
                         on_delta=None, ev=None) -> tuple[str, str]:
            """Drive req to completion; returns (text, finish_reason) and
            calls on_delta(new_text) as tokens stream in.  ``ev``: the
            request was submitted already (a chat's ``n`` siblings)."""
            if ev is None:
                ev = self.st.submit(req)
            emitted = ""
            finish = "stop"
            stop_toks = set(req.stop_tokens)
            # fail a request on which the engine makes no progress for this
            # long instead of parking the client thread forever
            stall_s = float(os.environ.get("VLUT_REQUEST_STALL_S", "600"))
            last_n, last_progress = -1, time.monotonic()
            try:
                while True:
                    done = ev.wait(0.02)
                    now = time.monotonic()
                    with self.st.lock:
                        out = list(req.output)
                    if len(out) != last_n:
                        last_n, last_progress = len(out), now
                    if not done and now - last_progress > stall_s:
                        self.st.cancel(req)
                        finish = "timeout"
                        break
                    text = self.st.tok.decode(
                        [t for t in out if t not in stop_toks])
                    hit = None
                    for s in stops:
                        j = text.find(s)
                        if j != -1 and (hit is None or j < hit):
                            hit = j
                    if hit is not None:
                        text = text[:hit]
                        self.st.cancel(req)
                        if on_delta and len(text) > len(emitted):
                            on_delta(text[len(emitted):])
                        emitted = text
                        break
                    # hold back a suffix that may start a stop string
                    safe = len(text)
                    for s in stops:
                        for k in range(1, len(s)):
                            if text.endswith(s[:k]):
                                safe = min(safe, len(text) - k)
                    if on_delta and safe > len(emitted):
                        on_delta(text[len(emitted):safe])
                        emitted = text[:safe]
                    if done:
                        if on_delta and len(text) > len(emitted):
                            on_delta(text[len(emitted):])
                        emitted = text
                        if req.error:
                            finish = "error"
                        elif (len(req.output) >= req.max_new_tokens
                              and (not out or out[-1] not in stop_toks)):
                            finish = "length"
                        break
            finally:
                self.st.finish(req)
            return emitted, finish

        def _completion(self, body):
            prompt = body.get("prompt", "")
            ids = prompt if isinstance(prompt, list) else self.st.tok.encode(
                prompt)
            req = self._make_request(ids, body)
            stops = self._stop_strings(body)
            extra = ({"tokens": req.output} if body.get("return_tokens")
                     else {})
            if body.get("stream"):
                self._sse_start()
                text, finish = self._run_collect(
                    req, stops,
                    lambda d: self._sse({"content": d, "stop": False}))
                self._sse({
                    "content": "", "stop": True,
                    "stopped_limit": finish == "length",
                    "tokens_predicted": len(req.output),
                    "tokens_evaluated": len(req.prompt), **extra})
                self.wfile.write(b"data: [DONE]\n\n")
                return
            text, finish = self._run_collect(req, stops)
            if finish == "error":
                self._json(400, {"error": {
                    "message": req.error, "type": "invalid_request_error"}})
                return
            resp = {
                "content": text,
                "tokens_predicted": len(req.output),
                "tokens_evaluated": len(req.prompt),
                "stop": True,
                "stopped_limit": finish == "length",
                **extra,
            }
            if req.n_probs:
                resp["completion_probabilities"] = self._probs_payload(req)
            self._json(200, resp)

        def _chat(self, body):
            from vlut_tpu_torch.runtime.grammar import tool_call_gbnf

            tools = body.get("tools")
            ids = self.st.tok.apply_chat_template(body.get("messages", []),
                                                  tools=tools)
            tc = body.get("tool_choice")
            if tools and (tc == "required" or isinstance(tc, dict)):
                # "required" or a named function: the output is tool calls,
                # constrained by a grammar from the tools' schemas
                sel = tools
                if isinstance(tc, dict):
                    want = (tc.get("function") or {}).get("name")
                    sel = [t for t in tools
                           if t.get("function", t).get("name") == want]
                    if not sel:
                        self._json(400, {"error": {
                            "message": f"unknown tool {want!r}",
                            "type": "invalid_request_error"}})
                        return
                body = {**body, "grammar": tool_call_gbnf(
                    sel, parallel=tc == "required")}
            elif tools and tc in (None, "auto"):
                # "auto": prose is free until the model opens a tool call,
                # the schema grammar holds from there on
                body = {**body, "grammar": tool_call_gbnf(tools),
                        "grammar_lazy": True,
                        "grammar_triggers": ["<tool_call>"]}
            req = self._make_request(ids, body)
            stops = self._stop_strings(body)
            created = int(time.time())
            head = {"id": f"chatcmpl-{req.rid if req.rid >= 0 else created}",
                    "created": created, "model": self.st.model_name}
            tokens = lambda r: ({"tokens": r.output}  # noqa: E731
                                if body.get("return_tokens") else {})
            if body.get("stream"):
                self._sse_start()
                text, finish = self._run_collect(
                    req, stops, lambda d: self._sse({
                        **head, "object": "chat.completion.chunk",
                        "choices": [{"index": 0, "delta": {"content": d},
                                     "finish_reason": None}]}))
                self._sse({**head, "object": "chat.completion.chunk",
                           "choices": [{"index": 0, "delta": {},
                                        "finish_reason": finish,
                                        **tokens(req)}]})
                self.wfile.write(b"data: [DONE]\n\n")
                return
            n_choices = max(1, int(body.get("n", 1)))
            if n_choices > 1:
                # n siblings with seeds seed + j, in flight together (the
                # engine's prefix reuse shares their prompt)
                reqs = [req]
                for j in range(1, n_choices):
                    sib = self._make_request(ids, body)
                    sib.sampler = dataclasses.replace(
                        sib.sampler, seed=req.sampler.seed + j)
                    reqs.append(sib)
                evs = [self.st.submit(r) for r in reqs]
                results = [(r, *self._run_collect(r, stops, ev=e))
                           for r, e in zip(reqs, evs)]
                n_out = sum(len(r.output) for r in reqs)
                self._json(200, {
                    **head, "object": "chat.completion",
                    "choices": [
                        {"index": j,
                         "message": {"role": "assistant", "content": txt},
                         "finish_reason": fin, **tokens(r)}
                        for j, (r, txt, fin) in enumerate(results)],
                    "usage": {
                        "prompt_tokens": len(req.prompt) * n_choices,
                        "completion_tokens": n_out,
                        "total_tokens": len(req.prompt) * n_choices + n_out}})
                return
            text, finish = self._run_collect(req, stops)
            reasoning, text = _split_reasoning(text)
            calls, text = _parse_tool_calls(text) if tools else ([], text)
            message: dict[str, Any] = {"role": "assistant", "content": text}
            if reasoning:
                message["reasoning_content"] = reasoning
            if calls:
                message["tool_calls"] = [
                    {"id": f"call_{i}", "type": "function",
                     "function": {"name": c.get("name", ""),
                                  "arguments": json.dumps(c.get(
                                      "arguments", c.get("parameters", {})))}}
                    for i, c in enumerate(calls)]
                message["content"] = text or None
                finish = "tool_calls"
            choice: dict[str, Any] = {"index": 0, "message": message,
                                      "finish_reason": finish, **tokens(req)}
            if req.n_probs:
                choice["logprobs"] = {"content": [
                    {"token": e["token"], "logprob": e["logprob"],
                     "top_logprobs": [{"token": t["token"],
                                       "logprob": t["logprob"]}
                                      for t in e["top_logprobs"]]}
                    for e in self._probs_payload(req)]}
            self._json(200, {
                **head, "object": "chat.completion", "choices": [choice],
                "usage": {"prompt_tokens": len(req.prompt),
                          "completion_tokens": len(req.output),
                          "total_tokens": len(req.prompt) + len(req.output)}})

        def _infill(self, body):
            """Fill-in-middle: ``input_prefix`` and ``input_suffix`` around
            the tokenizer's FIM tokens where it has them, else a completion
            of the prefix."""
            prefix = body.get("input_prefix", "")
            suffix = body.get("input_suffix", "")
            tok = self.st.tok
            fim = [getattr(tok, f"fim_{w}_token_id", None)
                   for w in ("prefix", "suffix", "middle")]
            if None not in fim:
                ids = ([fim[0]] + tok.encode(prefix, add_bos=False)
                       + [fim[1]] + tok.encode(suffix, add_bos=False)
                       + [fim[2]])
            else:
                ids = tok.encode(prefix, add_bos=True)
            req = self._make_request(ids, body)
            text, _ = self._run_collect(req, self._stop_strings(body))
            self._json(200, {
                "content": text, "tokens_predicted": len(req.output),
                "stop": True,
                **({"tokens": req.output} if body.get("return_tokens")
                   else {})})

        def _embedding(self, body):
            inp = body.get("input", body.get("content", ""))
            if isinstance(inp, str):
                inp = [inp]
            ids_list = [x if isinstance(x, list) else self.st.tok.encode(x)
                        for x in inp]
            vecs = self.st.embed(ids_list,
                                 pooling=body.get("pooling", "mean"))
            n_tok = sum(len(x) for x in ids_list)
            self._json(200, {
                "object": "list",
                "data": [{"object": "embedding", "index": i,
                          "embedding": v.tolist()}
                         for i, v in enumerate(vecs)],
                "model": self.st.model_name,
                "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok}})

        def _rerank(self, body):
            docs = body.get("documents", [])
            q_ids = self.st.tok.encode(body.get("query", ""))
            d_ids = [self.st.tok.encode(d, add_bos=False) for d in docs]
            scores = self.st.rerank(q_ids, d_ids)
            order = sorted(range(len(scores)), key=lambda i: -scores[i])
            top_n = int(body.get("top_n", len(docs)))
            self._json(200, {
                "model": self.st.model_name,
                "results": [{"index": i, "relevance_score": scores[i]}
                            for i in order[:top_n]]})

        def _slot_action(self, path: str, query: str, body):
            """save / restore / erase of one slot's cached prefix."""
            try:
                slot_id = int(path.split("/")[2])
            except (IndexError, ValueError):
                self._json(400, {"error": "bad slot id"})
                return
            action = (parse_qs(query).get("action") or [""])[0]
            eng = self.st.engine
            if not 0 <= slot_id < eng.n_slots:
                self._json(400, {"error": "slot id out of range"})
                return
            name = body.get("filename", f"slot{slot_id}")
            with self.st.lock:
                if action == "save":
                    data = eng.save_slot(slot_id)
                    self.st.slot_files[name] = data
                    self._json(200, {
                        "id_slot": slot_id, "filename": name,
                        "n_saved": len(eng.slots[slot_id].history),
                        "n_bytes": len(data)})
                elif action == "restore":
                    if name not in self.st.slot_files:
                        self._json(404, {"error": f"no saved state {name}"})
                        return
                    eng.restore_slot(slot_id, self.st.slot_files[name])
                    self._json(200, {
                        "id_slot": slot_id,
                        "n_restored": len(eng.slots[slot_id].history)})
                elif action == "erase":
                    eng.slots[slot_id].history = []
                    self._json(200, {"id_slot": slot_id, "n_erased": 1})
                else:
                    self._json(400, {"error": f"unknown action {action!r}"})

    return Handler


def serve(engine: Engine, tokenizer, host: str = "127.0.0.1",
          port: int = 8080, model_name: str = "vlut-tpu",
          start_engine: bool = True,
          ) -> tuple[ThreadingHTTPServer, ServerState]:
    """Start the engine loop and the HTTP server (returns without
    blocking); ``port=0`` takes a free port (``httpd.server_address``).
    With ``start_engine=False`` requests queue until ``state.start()``."""
    httpd, router = serve_multi({model_name: (engine, tokenizer)}, host,
                                port, start_engine=start_engine)
    return httpd, router.states[model_name]


def serve_multi(models: dict[str, tuple[Engine, Any]],
                host: str = "127.0.0.1", port: int = 8080,
                default: str | None = None, start_engine: bool = True,
                ) -> tuple[ThreadingHTTPServer, Router]:
    """One engine loop per model behind one port, routed by the request's
    ``model`` field (``default``, or the first, when it has none).  The
    models of one device share one lock: their steps and forwards run one
    at a time, so none runs while another captures a CUDA graph."""
    router = Router()
    locks: dict[torch.device, threading.Lock] = {}
    for name, (engine, tok) in models.items():
        # a weight's device: cuda always with its index
        lock = locks.setdefault(engine.device, threading.Lock())
        state = ServerState(engine, tok, model_name=name, lock=lock)
        if start_engine:
            state.start()
        router.add(name, state, default=name == default)
    httpd = ThreadingHTTPServer((host, port), make_handler(router))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, router


def add_server_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model", required=True, action="append",
                    help="checkpoint dir, or NAME=DIR (repeatable: one "
                    "engine per model, routed by the request's model)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--no-context-shift", action="store_true",
                    help="reject over-context requests instead of "
                    "shifting/truncating")
    ap.add_argument("--cache-type", choices=("bf16", "q8"), default="bf16",
                    help="KV cache storage (q8 = int8 + scales)")
    ap.add_argument("--decode-attn", choices=("fused", "composed"),
                    default="fused",
                    help="decode attention: one fused kernel per layer, or "
                    "a row write and PyTorch attention")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ways (not ported: must be 1)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ways (not ported: must be 1)")
    ap.add_argument("--draft-model", default=None,
                    help="draft checkpoint for per-slot speculative decode")
    ap.add_argument("--draft-k", type=int, default=4)
    ap.add_argument("--lookahead", action="store_true",
                    help="per-slot draft-free windowed lookahead decode "
                    "(greedy requests only; others use the normal step)")
    ap.add_argument("--lookahead-window", type=int, default=8)
    ap.add_argument("--lookahead-ngram", type=int, default=3)
    ap.add_argument("--promote", choices=("i2", "i1"), default=None,
                    help="repack the weights to this format at load")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")


def start_from_args(args) -> tuple[ThreadingHTTPServer, Router]:
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.convert.quantize import promote
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    if args.tp != 1 or args.dp != 1:
        raise NotImplementedError("tp/dp serving is not ported to "
                                  "vlut_tpu_torch yet (ROADMAP Queue 1 "
                                  "item 6)")
    draft = None
    if args.draft_model:
        d_cfg, d_model, _ = load_checkpoint(args.draft_model,
                                            device=args.device)
        draft = (d_cfg, d_model)
    models = {}
    for spec in args.model:
        name, _, path = spec.rpartition("=")
        name = name or path
        cfg, model, _ = load_checkpoint(path, device=args.device)
        if args.promote:
            cfg, model = promote(cfg, model, args.promote)
        engine = Engine(
            cfg, model, n_slots=args.slots, max_len=args.ctx,
            kv_quant=args.cache_type == "q8",
            context_shift=not args.no_context_shift,
            decode_attn=args.decode_attn, draft=draft, k_draft=args.draft_k,
            lookahead=((args.lookahead_window, args.lookahead_ngram)
                       if args.lookahead else None))
        models[name] = (engine, Tokenizer(path))
    return serve_multi(models, args.host, args.port,
                       default=next(iter(models)))


def run_from_args(args) -> None:
    """Serve until interrupted."""
    httpd, router = start_from_args(args)
    print(f"listening on http://{httpd.server_address[0]}:"
          f"{httpd.server_address[1]} ({len(router.states)} model(s))",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        httpd.shutdown()
        httpd.server_close()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.serving.server")
    add_server_args(ap)
    run_from_args(ap.parse_args(argv))


if __name__ == "__main__":
    main()
