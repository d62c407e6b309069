"""HTTP completion server over the slot engine (port of
vlut_tpu/serving/server.py).

A stdlib ThreadingHTTPServer parks each request's thread on an event while
one engine thread drives ``Engine.step()`` (continuous batching).

  POST /completion, /completions, /v1/completions  — completion (+SSE)
  POST /tokenize, /detokenize                      — vocabulary round-trips
  GET  /health, /metrics, /slots, /props, /v1/models

Request fields as in the JAX package (prompt as text or token ids,
n_predict / max_tokens, the sampler fields, stop strings, stream,
ignore_eos, n_probs).  ``return_tokens: true`` adds the generated token ids
(``tokens``) to the answer, and to the last event of a stream.  Chat,
infill, embeddings, rerank, template expansion, slot actions and grammar
constraints are not ported yet and answer 501.

    python -m vlut_tpu_torch.serving.server --model DIR [--port 8080]
        [--slots 8] [--ctx 4096] [--cache-type bf16|q8]
        [--decode-attn fused|composed] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import urlparse

from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

NOT_PORTED_POST = (
    "/v1/chat/completions", "/infill", "/embedding", "/embeddings",
    "/v1/embeddings", "/rerank", "/reranking", "/v1/rerank",
    "/apply-template",
)
GRAMMAR_FIELDS = ("grammar", "json_schema", "regex", "guided_regex",
                  "response_format")


class ServerState:
    def __init__(self, engine: Engine, tokenizer, model_name: str = "vlut-tpu"):
        self.engine = engine
        self.tok = tokenizer
        self.model_name = model_name
        self.lock = threading.Lock()
        self.events: dict[int, threading.Event] = {}
        self.metrics = {
            "prompt_tokens_total": 0,
            "generated_tokens_total": 0,
            "requests_total": 0,
            "requests_errors_total": 0,
        }
        self.running = True
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


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        st = state

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj: Any):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _not_ported(self, what: str):
            self._json(501, {"error": {
                "message": f"{what} is not ported to vlut_tpu_torch yet",
                "type": "not_implemented"}})

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
            eng = self.st.engine
            if path == "/health":
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
                    {"id": self.st.model_name, "object": "model",
                     "owned_by": "vlut-tpu"}]})
            elif path in ("/", "/index.html"):
                self._not_ported("the web UI")
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
            path = urlparse(self.path).path
            try:
                if path in ("/completion", "/completions", "/v1/completions"):
                    self._completion(body)
                elif path == "/tokenize":
                    ids = self.st.tok.encode(
                        body.get("content", ""),
                        add_bos=bool(body.get("add_special", False)))
                    self._json(200, {"tokens": ids})
                elif path == "/detokenize":
                    self._json(200, {
                        "content": self.st.tok.decode(body.get("tokens", []))})
                elif path in NOT_PORTED_POST or path.startswith("/slots/"):
                    self._not_ported(f"POST {path}")
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
                         on_delta=None) -> tuple[str, str]:
            """Drive req to completion; returns (text, finish_reason) and
            calls on_delta(new_text) as tokens stream in."""
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
            if any(body.get(f) for f in GRAMMAR_FIELDS):
                self._not_ported("grammar-constrained completion")
                return
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

    return Handler


def serve(engine: Engine, tokenizer, host: str = "127.0.0.1",
          port: int = 8080, model_name: str = "vlut-tpu",
          start_engine: bool = True,
          ) -> tuple[ThreadingHTTPServer, ServerState]:
    """Start the engine loop and the HTTP server (returns without
    blocking); ``port=0`` takes a free port (``httpd.server_address``).
    With ``start_engine=False`` requests queue until ``state.start()``."""
    state = ServerState(engine, tokenizer, model_name=model_name)
    if start_engine:
        state.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state


def add_server_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model", required=True)
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
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")


def start_from_args(args) -> tuple[ThreadingHTTPServer, ServerState]:
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    if args.tp != 1 or args.dp != 1:
        raise NotImplementedError("tp/dp serving is not ported to "
                                  "vlut_tpu_torch yet (ROADMAP Queue 1 "
                                  "item 13)")
    cfg, model, _ = load_checkpoint(args.model, device=args.device)
    engine = Engine(cfg, model, n_slots=args.slots, max_len=args.ctx,
                    kv_quant=args.cache_type == "q8",
                    context_shift=not args.no_context_shift,
                    decode_attn=args.decode_attn)
    return serve(engine, Tokenizer(args.model), args.host, args.port,
                 model_name=str(args.model))


def run_from_args(args) -> None:
    """Serve until interrupted."""
    httpd, _ = start_from_args(args)
    print(f"listening on http://{httpd.server_address[0]}:"
          f"{httpd.server_address[1]}", flush=True)
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
