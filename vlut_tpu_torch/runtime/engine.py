"""Slot engine: continuous batching over a fixed set of KV-cache slots (port
of vlut_tpu/runtime/engine.py).

Requests queue up; between decode steps the engine admits them into free
slots (the slot whose cached history shares the longest prefix with the
prompt, whose rows are then reused), prefills the prompts in batched
groups by length bucket (prompts longer than the largest bucket first feed
full-bucket chunks), samples each first token, and then runs one decode
step over all slots at a time (idle slots included: their write lands on
the scratch row ``max_len - 1``).  A slot one row from capacity shifts its
context (keeps ``n_keep`` tokens, drops half of the rest, re-rotates the
moved keys' rotary dims on each rope layer with that layer's table).

Prefill runs eagerly, so nothing is compiled per shape: the bucket sizes
only set the prefill groups and the chunk size, kept as in the JAX package
so that the same requests see the same computation.  Prefill rows are
written in place into their slots' cache rows, and each layer reads back
only the slots of its group.

The decode step is one program per sampler feature set, as the JAX
engine keys its jitted step: forward, pad-vocab mask, sampler chain and
ring update over static tensors (:meth:`Engine._decode_step`).  (The JAX
key also holds ``k_probs > 0``; here log-probs are computed outside the
program, so it is the same program with or without them.)  On the card it
is captured once as a CUDA graph (:mod:`runtime.step_graph`), after one
eager step of the same key, and replayed; every program of an engine
shares one memory pool.  The host fills the static tokens and lengths
through a pinned copy, draws the step's noise from the per-slot
generators into static tensors, replays, and reads the next tokens back
with one ``.tolist()``.  Log-probs, admission, prefill, context shift and
``fork_slot`` stay on the host, eager.  On the CPU, or with
``cuda_graph=False`` (the eager A/B), the same step runs eagerly.

The other step programs, each one graph in the same pool:

* the **grammar step**: the decode step with an (n_slots, V_p) bool mask
  of allowed tokens as a static tensor, filled from a pinned host buffer
  before each replay (the masks come from each request's
  ``GrammarSampler`` on the host); keyed by (features, "grammar"), so the
  program without a grammar stays free of transfers;
* the **speculative round** (``draft=``): k+1 greedy draft decodes over
  the draft's own cache, each argmax fed to the next on the device, then
  one target forward over the k+1 rows and the accepted counts;
* the **lookahead round** (``lookahead=(W, G)``): one forward of
  T = 1 + (G-1)(W+1) rows per slot under a (B, T, S) mask, with its window,
  n-gram pool, pointer and Jacobi carry as static tensors.

Speculation and lookahead run only while every active slot is greedy and
featureless (no grammar, no log-probs) and has the rows' headroom; else
the normal step runs (and the draft cache does not advance).  Their tokens
equal plain greedy decoding.  ``save_slot`` / ``restore_slot`` move a
slot's rows through the JAX package's npz format (``runtime/state.py``);
a restore writes the cache in place.

Not ported (each raises ``NotImplementedError``): multi-device meshes and
recurrent models (ROADMAP Queue 1 items 6 and 7).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models.transformer import (
    DECODE_ATTN,
    TransformerLM,
    forward,
    fuse_projections,
    init_kv_cache,
    quantize_head,
    shift_tables,
    unstack_layers,
)
from vlut_tpu_torch.runtime import kv_cache as kvc
from vlut_tpu_torch.runtime import speculative as spec_mod
from vlut_tpu_torch.runtime import state as state_mod
from vlut_tpu_torch.runtime.sampling import (
    NEG_INF,
    SamplerParams,
    draw_noise,
    features_of,
    init_state,
    noise_shapes,
    row_generator,
    sample_ex,
    stack_params,
)
from vlut_tpu_torch.runtime.step_graph import step_runner

PENALTY_WINDOW = 64
N_KEEP = 4  # prompt tokens a context shift keeps


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to vlut_tpu_torch yet (ROADMAP Queue 1 "
        f"item {item})")


def _window_mask(cnt: torch.Tensor, last_n: torch.Tensor | None = None):
    """(B, PENALTY_WINDOW) bool: the ring entries a row's penalties see (the
    first ``cnt`` written, and only the last ``last_n`` of them)."""
    pos = torch.arange(PENALTY_WINDOW, device=cnt.device)[None, :]
    valid = pos < cnt[:, None]
    if last_n is not None:
        valid &= pos >= (cnt - last_n)[:, None]
    return valid


def _mask_pad_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """lm_head may be vocab-padded (models/dims.py)."""
    v = logits.shape[-1]
    if v == vocab_size:
        return logits
    return logits.masked_fill(
        torch.arange(v, device=logits.device) >= vocab_size, NEG_INF)


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 64
    sampler: SamplerParams = dataclasses.field(default_factory=SamplerParams)
    stop_tokens: tuple[int, ...] = ()
    # optional GBNF constraint (runtime.grammar.GrammarSampler bound to the
    # engine's vocab pieces); reset at admission
    grammar: Any = None
    # top-k logprobs to record per generated token (0 = off)
    n_probs: int = 0
    # filled by the engine:
    rid: int = -1
    output: list[int] = dataclasses.field(default_factory=list)
    # per generated token: (token ids (K,), logprobs (K,), chosen logprob)
    logprobs: list[tuple[Any, Any, float]] = dataclasses.field(
        default_factory=list)
    done: bool = False
    # set instead of raising when a request cannot be served (a prompt
    # longer than the context with context_shift off)
    error: str | None = None


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    length: int = 0  # prompt tokens in KV
    generated: int = 0
    # token history materialized in this slot's KV rows (prefix reuse)
    history: list[int] = dataclasses.field(default_factory=list)
    # tokens whose KV rows are live for the active request
    kv_hist: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PerfCounters:
    """Prompt and decode token counts and host-clock seconds."""

    n_prompt_tokens: int = 0
    t_prompt_s: float = 0.0
    n_decode_tokens: int = 0
    t_decode_s: float = 0.0
    n_decode_steps: int = 0
    n_reused_tokens: int = 0
    n_shifted_tokens: int = 0
    # decode-step captures (CUDA graphs), kept out of t_decode_s
    n_captures: int = 0
    t_capture_s: float = 0.0
    # the decode steps (or rounds) replayed from a graph, inside t_decode_s:
    # the steady state of a graphed engine
    n_replays: int = 0
    t_replay_s: float = 0.0
    # speculative / lookahead rounds: proposals made and accepted
    n_spec_drafted: int = 0
    n_spec_accepted: int = 0
    n_spec_rounds: int = 0
    # host time building grammar masks, inside t_decode_s
    t_grammar_s: float = 0.0

    def summary(self) -> str:
        pp = self.n_prompt_tokens / self.t_prompt_s if self.t_prompt_s else 0
        tg = self.n_decode_tokens / self.t_decode_s if self.t_decode_s else 0
        return (
            f"prompt: {self.n_prompt_tokens} tok in "
            f"{self.t_prompt_s*1e3:.0f} ms ({pp:.1f} tok/s) | "
            f"decode: {self.n_decode_tokens} tok in "
            f"{self.t_decode_s*1e3:.0f} ms ({tg:.1f} tok/s) | "
            f"reused: {self.n_reused_tokens} tok"
        )


@dataclasses.dataclass
class _StepProgram:
    """One step program: the noise it draws (shapes and static tensors; none
    for a greedy round) and its runner (``runtime.step_graph.step_runner``)."""

    shapes: dict[str, tuple]
    noise: dict[str, torch.Tensor]
    run: Any


class Engine:
    """Single-device slot engine over a :class:`TransformerLM`, on the
    model's device; the model is served as the fused, unrolled tree (left
    unfused where a LoRA needs it) with a bf16 or int8 (``kv_quant``)
    cache.  ``draft=(cfg, model[, (d2t, t2d)])`` speculates with a draft
    model (k_draft proposals per round), ``lookahead=(W, G)`` with the
    draft-free lookahead; the two exclude each other.  ``cuda_graph=False``
    runs every step program eagerly on the card too."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: TransformerLM,
        n_slots: int = 8,
        max_len: int | None = None,
        kv_quant: bool = False,
        context_shift: bool = True,
        head_quant: bool = False,
        draft: Any = None,
        k_draft: int = 4,
        lookahead: tuple[int, int] | None = None,
        prefill_buckets: tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024),
        mesh: Any = None,
        decode_attn: str = "fused",
        cuda_graph: bool = True,
    ):
        if mesh is not None:
            raise _not_ported("multi-device serving (mesh=)", "6")
        if lookahead is not None and draft is not None:
            raise ValueError("lookahead and draft are mutually exclusive "
                             "decode modes")
        if type(cfg).__name__ == "MambaConfig":
            raise _not_ported("recurrent models", "7")
        if decode_attn not in DECODE_ATTN:
            raise ValueError(f"decode_attn must be one of {DECODE_ATTN}")
        self.cfg = cfg
        if head_quant:
            params = quantize_head(params)
        self.params = unstack_layers(fuse_projections(params, cfg), cfg)
        self.device = self.params.device
        self.n_slots = n_slots
        self.max_len = max_len or cfg.max_seq_len
        self.decode_attn = decode_attn
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= self.max_len) or (self.max_len,)
        self.cache = init_kv_cache(cfg, n_slots, self.max_len,
                                   device=self.device, quantized=kv_quant)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: list[Request] = []
        self._next_rid = 0

        dev = self.device
        self.ring = torch.full((n_slots, PENALTY_WINDOW), -1,
                               dtype=torch.int32, device=dev)
        self.ring_cnt = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._sp = stack_params([SamplerParams()] * n_slots, device=dev)
        self._sampler_state = init_state(n_slots, dev)
        # one seeded generator per slot, made when a request that samples
        # is admitted there
        self._gens: list[torch.Generator | None] = [None] * n_slots
        self._features: tuple[str, ...] = ()
        # the decode step's static inputs, (tokens, lengths), filled from a
        # pinned host copy; one program per key
        self._step_in = torch.zeros((2, n_slots), dtype=torch.long,
                                    device=dev)
        self._host_in = torch.zeros((2, n_slots), dtype=torch.long,
                                    pin_memory=dev.type == "cuda")
        self.cuda_graph = cuda_graph and dev.type == "cuda"
        self._steps: dict[tuple[str, ...], _StepProgram] = {}
        # one pool for every program's graph: replays run one at a time on
        # one stream and each step's outputs are read before the next
        # replay, so a graph may reuse what another freed at its capture
        self._pool = (torch.cuda.graph_pool_handle() if self.cuda_graph
                      else None)

        # the grammar step's (n_slots, V_p) allowed-token mask: a static
        # tensor filled from a pinned host buffer
        self._mask = None
        self._host_mask = None
        self._spec = None
        if draft is not None:
            d_cfg, d_model = draft[0], draft[1]
            self._spec = {
                "cfg": d_cfg,
                "params": unstack_layers(fuse_projections(d_model, d_cfg),
                                         d_cfg),
                "k": k_draft,
                "cache": init_kv_cache(d_cfg, n_slots, self.max_len,
                                       device=dev),
                "vmap": (spec_mod.VocabMap(draft[2][0], draft[2][1], dev)
                         if len(draft) > 2 and draft[2] is not None
                         else None),
            }
        self._la = None
        if lookahead is not None:
            w, g = lookahead
            self._la = {
                "window": w, "ngram": g,
                "round": spec_mod.make_lookahead_round(cfg, w, g,
                                                       decode_attn),
                "state": spec_mod.la_state(n_slots, w, g, device=dev),
            }
            self._la["t_total"] = self._la["round"].t_total

        self.context_shift = context_shift
        self._rope_tables = None
        self._replayed = False
        self.perf = PerfCounters()

    # --- host API ------------------------------------------------------------

    def submit(self, req: Request) -> int:
        req.rid = self._next_rid
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    def _bucket(self, t: int) -> int:
        for b in self.prefill_buckets:
            if t <= b:
                return b
        # longer prompts run chunked: full largest-bucket rounds first, the
        # remainder lands here
        return self.prefill_buckets[-1]

    @staticmethod
    def _common_prefix(a: list[int], b: list[int]) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    @staticmethod
    def _pow2_at_most(n: int, cap: int) -> int:
        p = 1
        while p * 2 <= min(n, cap):
            p *= 2
        return p

    def _admit(self):
        # stage 1: assign queued requests to free slots, preferring the slot
        # whose cached history shares the longest prefix with the prompt
        staged: list[list] = []
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s.req is None]
            if not free:
                break
            req = self.queue.pop(0)
            prompt = req.prompt
            if not prompt:
                req.done = True
                continue
            if len(prompt) > self.max_len - 1:
                if not self.context_shift:
                    req.error = (
                        f"prompt ({len(prompt)} tokens) exceeds context "
                        f"({self.max_len}); enable context_shift to "
                        f"truncate")
                    req.done = True
                    continue
                # keep the n_keep head and the newest tail
                keep = min(N_KEEP, self.max_len // 4)
                prompt = prompt[:keep] + prompt[-(self.max_len - 1 - keep):]
                req.prompt = prompt
            i = max(free, key=lambda s: self._common_prefix(
                self.slots[s].history, prompt))
            reuse = min(self._common_prefix(self.slots[i].history, prompt),
                        len(prompt) - 1)
            if self._spec is not None:
                # the draft cache holds no tracked prefix: both models see
                # the whole prompt
                reuse = 0
            slot = self.slots[i]
            slot.req = req
            slot.length = len(prompt)
            slot.generated = 0
            slot.history = list(prompt)
            slot.kv_hist = list(prompt)
            if self._la is not None:
                # start each request with a clean window and pool
                st = self._la["state"]
                st["win"][i] = 0
                st["pool"][i] = -1
                st["ptr"][i] = 0
                st["jac"][i] = -1
            # [slot, kv offset, remaining tokens, true prefix reuse]
            staged.append([i, req, reuse, prompt[reuse:], reuse])
        if not staged:
            return

        # stage 1b: prompts longer than the largest bucket feed full-bucket
        # chunks; round k carries chunk k of every long prompt as one
        # batched forward
        big = self.prefill_buckets[-1]
        while True:
            rounds = [it for it in staged if len(it[3]) > big]
            if not rounds:
                break
            for g0 in range(0, len(rounds), self.n_slots):
                batch = rounds[g0:g0 + self.n_slots]
                m = self._pow2_at_most(len(batch), self.n_slots)
                self._prefill_group(
                    big, [(it[0], it[2], it[3][:big]) for it in batch[:m]])
                for it in batch[:m]:
                    it[2] += big
                    it[3] = it[3][big:]

        # stage 2: group by prefill bucket; each group is one batched forward
        by_bucket: dict[int, list] = {}
        for item in staged:
            by_bucket.setdefault(self._bucket(len(item[3])), []).append(item)
        for tb, group in sorted(by_bucket.items()):
            g = 0
            while g < len(group):
                m = self._pow2_at_most(len(group) - g, self.n_slots)
                chunk = group[g:g + m]
                g += m
                last_logits = self._prefill_group(
                    tb, [(i, off, new) for i, req, off, new, _ in chunk])
                self.perf.n_reused_tokens += sum(c[4] for c in chunk)
                for r, (i, req, off, new, _) in enumerate(chunk):
                    self._first_token(i, req, last_logits[r])

        active = [(s.req.sampler if s.req else SamplerParams(temperature=0.0))
                  for s in self.slots]
        # in place: a captured step reads these tensors
        for k, v in stack_params(active, device=self.device).items():
            self._sp[k].copy_(v)
        self._features = features_of(active)

    @torch.inference_mode()
    def _prefill_group(self, tb: int, rows) -> torch.Tensor:
        """One batched prefill forward over ``rows``, a list of (slot,
        kv offset, tokens) with len(tokens) <= tb; writes their KV rows in
        place and returns the (m, V) logits at each row's last token."""
        m = len(rows)
        t0 = time.perf_counter()
        dev = self.device
        toks = torch.zeros((m, tb), dtype=torch.long)
        pos = torch.zeros((m, tb), dtype=torch.long)
        slots = torch.zeros((m,), dtype=torch.long)
        nv = torch.zeros((m,), dtype=torch.long)
        for r, (i, off, new) in enumerate(rows):
            toks[r, :len(new)] = torch.tensor(new, dtype=torch.long)
            pos[r] = off + torch.arange(tb)
            slots[r] = i
            nv[r] = len(new)
        logits, _ = forward(
            self.params, self.cfg, toks.to(dev), pos.to(dev), self.cache,
            logits_at=torch.clamp(nv - 1, min=0).to(dev), slots=slots.to(dev),
            decode_attn=self.decode_attn)
        logits = logits[:, 0]
        if self._spec is not None:
            # the draft prefills the same rows of its own cache (the prompt
            # translated into its vocabulary)
            sp = self._spec
            toks_d = toks.to(dev)
            if sp["vmap"] is not None:
                toks_d = sp["vmap"].to_draft(toks_d)
            forward(sp["params"], sp["cfg"], toks_d, pos.to(dev),
                    sp["cache"], logits_at=torch.clamp(nv - 1, min=0).to(dev),
                    slots=slots.to(dev), decode_attn=self.decode_attn)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.perf.n_prompt_tokens += int(nv.sum())
        self.perf.t_prompt_s += time.perf_counter() - t0
        return logits

    @torch.inference_mode()
    def _first_token(self, i: int, req: Request, last_logits: torch.Tensor):
        """Seed slot i's sampler state and sample its first token from the
        prefill logits."""
        dev = self.device
        tail = req.prompt[-PENALTY_WINDOW:]
        ring = torch.full((PENALTY_WINDOW,), -1, dtype=torch.int32)
        ring[:len(tail)] = torch.tensor(tail, dtype=torch.int32)
        self.ring[i] = ring.to(dev)
        self.ring_cnt[i] = len(tail)
        s = req.sampler
        draws = s.temperature > 0 or s.mirostat_tau > 0
        self._gens[i] = row_generator(0, s.seed, i, dev) if draws else None
        # a new request starts with fresh sampler state (mirostat mu)
        for v in self._sampler_state.values():
            v[i] = 0
        logits = _mask_pad_vocab(last_logits[None].to(torch.float32),
                                 self.cfg.vocab_size)
        row_mask = None
        if req.grammar is not None:
            req.grammar.reset()
            row_mask = torch.from_numpy(
                self._grammar_row(req, self.params.n_logits))[None].to(dev)
        tok, row_state = sample_ex(
            logits, stack_params([s], device=dev), [self._gens[i]],
            {k: v[i:i + 1] for k, v in self._sampler_state.items()},
            self.ring[i:i + 1], _window_mask(self.ring_cnt[i:i + 1]),
            allowed_mask=row_mask, features=features_of([s]))
        for k, v in row_state.items():
            self._sampler_state[k][i] = v[0]
        first = int(tok[0])
        if req.n_probs:
            lp = torch.log_softmax(logits, dim=-1)
            top_lp, top_id = torch.topk(lp, req.n_probs, dim=-1)
            req.logprobs.append((top_id[0].cpu().numpy(),
                                 top_lp[0].cpu().numpy(),
                                 float(lp[0, first])))
        if req.grammar is not None and first not in req.stop_tokens:
            try:
                req.grammar.accept(first)
            except Exception:  # noqa: BLE001
                req.max_new_tokens = min(req.max_new_tokens, 1)
        self._push_token(i, first)

    def _maybe_context_shift(self, i: int):
        """When slot i is one row from capacity, drop the middle half of its
        context (keeping the first n_keep tokens) and re-rotate the moved
        keys."""
        slot = self.slots[i]
        used = slot.length + slot.generated - 1  # rows currently in KV
        if used < self.max_len - 1:
            return
        n_keep = min(N_KEEP, used - 1)
        n_discard = max(1, (used - n_keep) // 2)
        if self._rope_tables is None:
            self._rope_tables = shift_tables(self.cfg, self.device)
        kvc.seq_shift(self.cache, i, n_keep + n_discard, n_discard,
                      self._rope_tables)
        if slot.generated - 1 >= n_discard:
            slot.generated -= n_discard
        else:
            rem = n_discard - (slot.generated - 1)
            slot.generated = 1
            slot.length -= rem
        slot.kv_hist = slot.kv_hist[:n_keep] + slot.kv_hist[n_keep + n_discard:]
        self.perf.n_shifted_tokens += n_discard

    def _finish_if_done(self, i: int, tok: int):
        slot = self.slots[i]
        req = slot.req
        n_out = len(req.output)
        at_capacity = slot.length + slot.generated >= self.max_len - 1
        stop = tok in req.stop_tokens or n_out >= req.max_new_tokens
        if at_capacity and self.context_shift and not stop:
            self._maybe_context_shift(i)
            return
        if stop or at_capacity:
            req.done = True
            # KV holds exactly kv_hist's rows: the reusable cached prefix
            slot.history = list(slot.kv_hist)
            slot.req = None
            slot.length = 0
            slot.generated = 0

    def _push_token(self, i: int, tok: int):
        """Append a token sampled on the host path (the first token): the
        penalty ring is updated here."""
        self.ring[i, int(self.ring_cnt[i]) % PENALTY_WINDOW] = tok
        self.ring_cnt[i] += 1
        self._push_token_host_only(i, tok)

    def _push_token_host_only(self, i: int, tok: int):
        # the decode step already updated the ring on the device
        slot = self.slots[i]
        slot.req.output.append(tok)
        slot.generated += 1
        self._finish_if_done(i, tok)

    def _grammar_row(self, req: Request, width: int) -> np.ndarray:
        """(width,) bool allowed tokens of ``req``'s grammar (True past the
        vocabulary: the pad logits are already masked).  A wedged grammar
        (no token admissible) allows only EOS and the stop tokens, or, with
        none known, anything while capping the request at this token."""
        v = self.cfg.vocab_size
        row = req.grammar.mask()[:v]
        if not row.any():
            outs = [t for t in set(getattr(req.grammar, "eos_ids", ()))
                    | set(req.stop_tokens) if 0 <= t < v]
            row = np.zeros((v,), bool)
            if outs:
                row[outs] = True
            else:
                row[:] = True
                req.max_new_tokens = min(req.max_new_tokens,
                                         len(req.output) + 1)
        out = np.ones((width,), bool)
        out[:v] = row
        return out

    def _grammar_mask(self, active: list[int]) -> bool:
        """Fill the pinned host mask with every active grammar's row (True
        elsewhere); False, and nothing filled, when no active slot has a
        grammar that constrains this step (a lazy grammar before its
        trigger does not)."""
        grams = [i for i in active
                 if self.slots[i].req.grammar is not None
                 and not getattr(self.slots[i].req.grammar, "inactive",
                                 False)]
        if not grams:
            return False
        t0 = time.perf_counter()
        if self._host_mask is None:
            shape = (self.n_slots, self.params.n_logits)
            self._host_mask = torch.ones(shape, dtype=torch.bool,
                                         pin_memory=self.device.type == "cuda")
            self._mask = torch.ones(shape, dtype=torch.bool,
                                    device=self.device)
        host = self._host_mask.numpy()
        host[:] = True
        for i in grams:
            host[i] = self._grammar_row(self.slots[i].req, host.shape[1])
        self.perf.t_grammar_s += time.perf_counter() - t0
        return True

    def _decode_step(self, features: tuple[str, ...],
                     noise: dict[str, torch.Tensor], grammar: bool = False):
        """The decode step a graph captures, over the static inputs
        (``_step_in``, ``_sp``, the ring, the sampler state, ``noise`` and,
        with ``grammar``, the allowed-token mask), all updated in place:
        forward over every slot (its KV rows written), pad-vocab mask,
        sampler chain, ring update.  Returns the (B,) next tokens and the
        (B, V) float32 logits."""
        tokens, lengths = self._step_in
        logits, _ = forward(self.params, self.cfg, tokens[:, None],
                            lengths[:, None], self.cache,
                            decode_attn=self.decode_attn)
        logits = _mask_pad_vocab(logits[:, 0].to(torch.float32),
                                 self.cfg.vocab_size)
        valid = _window_mask(self.ring_cnt, self._sp["penalty_last_n"])
        nxt, state = sample_ex(
            logits, self._sp, None, self._sampler_state, self.ring, valid,
            allowed_mask=self._mask if grammar else None, features=features,
            noise=noise)
        for k, v in state.items():
            if v is not self._sampler_state[k]:
                self._sampler_state[k].copy_(v)
        rows = torch.arange(self.n_slots, device=self.device)
        self.ring[rows, (self.ring_cnt % PENALTY_WINDOW).long()] = nxt.to(
            torch.int32)
        self.ring_cnt += 1
        return nxt, logits

    def _program(self, features: tuple[str, ...],
                 grammar: bool = False) -> _StepProgram:
        key = features + (("grammar",) if grammar else ())
        prog = self._steps.get(key)
        if prog is None:
            shapes = noise_shapes(self.n_slots, self.params.n_logits,
                                  features)
            noise = {name: torch.zeros(sh, device=self.device)
                     for name, sh in shapes.items()}
            prog = _StepProgram(shapes, noise, step_runner(
                lambda: self._decode_step(features, noise, grammar),
                self.device, self.cuda_graph, self._pool))
            self._steps[key] = prog
        return prog

    def _round_program(self, key: tuple[str, ...], fn) -> _StepProgram:
        """The program of a greedy round ``fn`` (no noise)."""
        prog = self._steps.get(key)
        if prog is None:
            prog = _StepProgram({}, {}, step_runner(
                fn, self.device, self.cuda_graph, self._pool))
            self._steps[key] = prog
        return prog

    def _spec_round(self):
        """The speculative round a graph captures, over ``_step_in``: k+1
        greedy draft decodes (the extra one writes the last proposal's KV
        so an all-accepted round leaves no hole in the draft cache), then
        one target forward over [fed token, k proposals].  Returns the (B,
        k+1) target tokens and (B,) accepted counts."""
        sp = self._spec
        tokens, lengths = self._step_in
        vm = sp["vmap"]
        props = spec_mod.draft_tokens(
            sp["params"], sp["cfg"], sp["cache"],
            vm.to_draft(tokens) if vm else tokens, lengths, sp["k"] + 1,
            self.decode_attn)[:, :sp["k"]]
        if vm:
            props = vm.to_target(props)
        return spec_mod.verify(self.params, self.cfg, self.cache, tokens,
                               props, lengths, self.decode_attn)

    def _la_round(self):
        """The lookahead round a graph captures, over ``_step_in`` and the
        lookahead state (updated in place)."""
        tokens, lengths = self._step_in
        return self._la["round"](self.params, self.cache, tokens, lengths,
                                 self._la["state"])

    def _run_step(self, prog: _StepProgram):
        """One decode step of ``prog``: its noise drawn, then its runner
        called (on the card: eager at the first call, captured at the
        second, replayed after)."""
        if prog.shapes:
            draw_noise(self._gens, prog.shapes, self.device, out=prog.noise)
        fresh = not prog.run.captured
        replays = getattr(prog.run, "replays", 0)
        out = prog.run()
        self._replayed = getattr(prog.run, "replays", 0) > replays
        if fresh and prog.run.captured:
            self.perf.n_captures += 1
            self.perf.t_capture_s += prog.run.capture_s
        return out

    def _count_step(self, t0: float, captures: float) -> None:
        """Add a step's (or round's) host seconds since ``t0`` less the
        captures made in it, and the same to the replay time when the step
        was replayed from a graph."""
        dt = time.perf_counter() - t0 - (self.perf.t_capture_s - captures)
        self.perf.t_decode_s += dt
        self.perf.n_decode_steps += 1
        if self._replayed:
            self.perf.t_replay_s += dt
            self.perf.n_replays += 1

    def step_programs(self) -> list[dict]:
        """Each step program: its key (the decode step's features, with
        "grammar" for the grammar step; "speculative" or "lookahead" for a
        round), and its graph's capture time, memory and replays (none on
        the CPU, with ``cuda_graph=False`` or before the capture)."""
        return [{"features": list(k), **p.run.stats()}
                for k, p in self._steps.items()]

    def _fill_inputs(self, active: list[int], idle_len: int) -> list[int]:
        """Write the fed tokens and the write rows of the step into the
        pinned host inputs (idle slots: token 0 at row ``idle_len``);
        returns the fed tokens."""
        host = self._host_in.numpy()
        host[0] = 0
        host[1] = idle_len
        for i in active:
            s = self.slots[i]
            host[0, i] = s.req.output[-1]
            host[1, i] = s.length + s.generated - 1
        return host[0].tolist()

    def _can_round(self, active: list[int], rows: int) -> bool:
        """A speculative or lookahead round covers the greedy featureless
        path (its tokens equal plain greedy decoding) while every active
        slot has ``rows`` rows of headroom; anything needing the sampler
        chain, a grammar or log-probs runs the normal step."""
        if self._features:
            return False
        for i in active:
            s = self.slots[i]
            if s.req.grammar is not None or s.req.n_probs:
                return False
            if s.length + s.generated - 1 + rows >= self.max_len - 1:
                return False
        return True

    def _commit_rounds(self, active, fed, tgt, n_acc, drafted: int):
        """Push each active slot's accepted tokens of a round."""
        for i in active:
            slot = self.slots[i]
            n = n_acc[i] + 1
            row = tgt[i][:n]
            # rows written this round that stay valid: the fed token and
            # the accepted proposals
            slot.kv_hist.extend([fed[i]] + row[:-1])
            self.perf.n_decode_tokens += n
            self.perf.n_spec_drafted += drafted
            self.perf.n_spec_accepted += n - 1
            for tok in row:
                self._push_token_host_only(i, tok)
                if slot.req is None:  # finished mid-row
                    break

    def _step_round(self, active: list[int], idle_len: int, key, fn,
                    drafted: int) -> bool:
        fed = self._fill_inputs(active, idle_len)
        t0 = time.perf_counter()
        self._step_in.copy_(self._host_in, non_blocking=True)
        captures = self.perf.t_capture_s
        tgt, n_acc = self._run_step(self._round_program(key, fn))
        tgt, n_acc = tgt.tolist(), n_acc.tolist()
        self._count_step(t0, captures)
        self.perf.n_spec_rounds += 1
        self._commit_rounds(active, fed, tgt, n_acc, drafted)
        return True

    def _step_speculative(self, active: list[int]) -> bool:
        # idle slots park at the tail row; prefix reuse is off in draft
        # mode, so their round's writes touch no cached prefix
        k = self._spec["k"]
        return self._step_round(active, self.max_len - 1,
                                ("speculative", f"k={k}"), self._spec_round, k)

    def _step_lookahead(self, active: list[int]) -> bool:
        la = self._la
        # a lookahead round writes t_total rows from an idle slot's parking
        # row, so its cached prefix is only kept below them
        cap = self.max_len - la["t_total"] - 1
        for s in self.slots:
            if s.req is None and len(s.history) > cap:
                s.history = s.history[:cap]
        return self._step_round(
            active, cap, ("lookahead", f"W={la['window']}",
                          f"G={la['ngram']}"), self._la_round,
            la["ngram"] - 1)

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine iteration: admit new requests, decode all active
        slots (a speculative or lookahead round where it applies).  Returns
        True while work remains."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        if not active:
            return bool(self.queue)
        if self._spec and self._can_round(active, self._spec["k"] + 2):
            return self._step_speculative(active)
        if self._la and self._can_round(active, self._la["t_total"] + 1):
            return self._step_lookahead(active)
        # idle slots still run; their row write lands on row max_len - 1,
        # which is never part of a reusable prefix
        fed = self._fill_inputs(active, self.max_len - 1)
        k_probs = max(self.slots[i].req.n_probs for i in active)
        t0 = time.perf_counter()
        grammar = self._grammar_mask(active)
        self._step_in.copy_(self._host_in, non_blocking=True)
        if grammar:
            self._mask.copy_(self._host_mask, non_blocking=True)
        captures = self.perf.t_capture_s
        nxt, logits = self._run_step(self._program(self._features, grammar))
        if k_probs:
            lp = torch.log_softmax(logits, dim=-1)
            top_lp, top_id = torch.topk(lp, k_probs, dim=-1)
            chosen = torch.gather(lp, 1, nxt[:, None])[:, 0]
            p_id, p_lp = top_id.cpu().numpy(), top_lp.cpu().numpy()
            p_chosen = chosen.cpu().tolist()
        nxt = nxt.tolist()
        self._count_step(t0, captures)
        self.perf.n_decode_tokens += len(active)
        for i in active:
            req = self.slots[i].req
            # the token fed this step had its KV row written
            self.slots[i].kv_hist.append(fed[i])
            if k_probs and req.n_probs:
                req.logprobs.append((p_id[i, :req.n_probs],
                                     p_lp[i, :req.n_probs], p_chosen[i]))
            tok = int(nxt[i])
            g = req.grammar
            if g is not None and tok not in req.stop_tokens:
                try:
                    g.accept(tok)
                except Exception:  # noqa: BLE001
                    # a grammar fault ends this request after this token,
                    # not the engine loop every other request depends on
                    req.max_new_tokens = min(req.max_new_tokens,
                                             len(req.output) + 1)
            self._push_token_host_only(i, tok)
        return True

    # --- sequence/state ops ----------------------------------------------------

    def save_slot(self, i: int) -> bytes:
        """Serialize slot i's cached prefix (the JAX package's npz)."""
        hist = self.slots[i].history
        return state_mod.save_slot_state(self.cache, i, len(hist), hist)

    def restore_slot(self, i: int, data: bytes) -> None:
        """Write a serialized prefix into idle slot i, in place; the next
        request admitted there reuses it through the prefix cache."""
        if self.slots[i].req is not None:
            raise RuntimeError(f"slot {i} is busy")
        self.slots[i].history = state_mod.load_slot_state(self.cache, i, data)
        self.slots[i].length = 0

    def fork_slot(self, src: int, dst: int) -> None:
        """Copy slot src's cached prefix to idle slot dst (seq_cp)."""
        if self.slots[dst].req is not None:
            raise RuntimeError(f"slot {dst} is busy")
        kvc.seq_cp(self.cache, src, dst, len(self.slots[src].history))
        self.slots[dst].history = list(self.slots[src].history)
        self.slots[dst].length = 0

    def cancel(self, rid: int) -> bool:
        """Abort a queued or running request.  A running slot keeps its KV
        history for prefix reuse."""
        for j, r in enumerate(self.queue):
            if r.rid == rid:
                self.queue.pop(j)
                r.done = True
                return True
        for slot in self.slots:
            if slot.req is not None and slot.req.rid == rid:
                slot.req.done = True
                slot.history = list(slot.kv_hist)
                slot.req = None
                slot.length = 0
                slot.generated = 0
                return True
        return False

    def run(self, reqs: list[Request], progress: bool = False) -> list[Request]:
        """Submit everything and loop until drained."""
        for r in reqs:
            self.submit(r)
        t0 = time.perf_counter()
        steps = 0
        while self.step():
            steps += 1
            if progress and steps % 32 == 0:
                done = sum(r.done for r in reqs)
                print(f"[engine] step {steps}, {done}/{len(reqs)} done, "
                      f"{time.perf_counter()-t0:.1f}s")
        return reqs
