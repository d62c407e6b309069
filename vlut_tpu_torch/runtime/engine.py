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
moved keys).

PyTorch runs eagerly, so nothing is compiled per shape: the bucket sizes
only set the prefill groups and the chunk size, kept as in the JAX package
so that the same requests see the same computation.  Prefill rows are
written in place into their slots' cache rows, and each layer reads back
only the slots of its group.

Not ported yet (each raises ``NotImplementedError``): multi-device meshes,
draft-model speculation and lookahead decoding, grammar-constrained
sampling, slot save/restore, and recurrent models (ROADMAP Queue 1 items
9 and 13).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models.dims import make_plan
from vlut_tpu_torch.models.transformer import (
    DECODE_ATTN,
    TransformerLM,
    forward,
    fuse_projections,
    init_kv_cache,
    quantize_head,
    unstack_layers,
)
from vlut_tpu_torch.ops.rope import rope_table
from vlut_tpu_torch.runtime import kv_cache as kvc
from vlut_tpu_torch.runtime.sampling import (
    NEG_INF,
    SamplerParams,
    features_of,
    init_state,
    row_generator,
    sample_ex,
    stack_params,
)

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
    grammar: Any = None  # not ported: a request with one is refused
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


class Engine:
    """Single-device slot engine over a :class:`TransformerLM`, on the
    model's device; the model is served as the fused, unrolled tree with a
    bf16 or int8 (``kv_quant``) cache."""

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
        lookahead: tuple[int, int] | None = None,
        prefill_buckets: tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024),
        mesh: Any = None,
        decode_attn: str = "fused",
    ):
        if mesh is not None:
            raise _not_ported("multi-device serving (mesh=)", "13")
        if draft is not None:
            raise _not_ported("draft-model speculative decoding", "9")
        if lookahead is not None:
            raise _not_ported("lookahead decoding", "9")
        if type(cfg).__name__ == "MambaConfig":
            raise _not_ported("recurrent models", "11")
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

        self.context_shift = context_shift
        self._rope_tables = None
        self.perf = PerfCounters()

    # --- host API ------------------------------------------------------------

    def submit(self, req: Request) -> int:
        if req.grammar is not None:
            raise _not_ported("grammar-constrained sampling", "9")
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
            slot = self.slots[i]
            slot.req = req
            slot.length = len(prompt)
            slot.generated = 0
            slot.history = list(prompt)
            slot.kv_hist = list(prompt)
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
        self._sp = stack_params(active, device=self.device)
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
        tok, row_state = sample_ex(
            logits, stack_params([s], device=dev), [self._gens[i]],
            {k: v[i:i + 1] for k, v in self._sampler_state.items()},
            self.ring[i:i + 1], _window_mask(self.ring_cnt[i:i + 1]),
            features=features_of([s]))
        for k, v in row_state.items():
            self._sampler_state[k][i] = v[0]
        first = int(tok[0])
        if req.n_probs:
            lp = torch.log_softmax(logits, dim=-1)
            top_lp, top_id = torch.topk(lp, req.n_probs, dim=-1)
            req.logprobs.append((top_id[0].cpu().numpy(),
                                 top_lp[0].cpu().numpy(),
                                 float(lp[0, first])))
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
            plan = make_plan(self.cfg)
            # unit-magnitude tables: stored keys already carry the mscale
            self._rope_tables = rope_table(
                self.cfg.max_seq_len, plan.hd, self.cfg.rope_theta,
                self.cfg.rope_scaling, pad_to=plan.hd_p, with_mscale=False,
                device=self.device)
        cos, sin = self._rope_tables
        kvc.seq_shift(self.cache, i, n_keep + n_discard, n_discard, cos, sin)
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

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine iteration: admit new requests, decode all active
        slots.  Returns True while work remains."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        if not active:
            return bool(self.queue)
        dev = self.device
        tokens = torch.zeros((self.n_slots,), dtype=torch.long)
        # idle slots still run; their row write lands on row max_len - 1,
        # which is never part of a reusable prefix
        lengths = torch.full((self.n_slots,), self.max_len - 1,
                             dtype=torch.long)
        for i in active:
            s = self.slots[i]
            tokens[i] = s.req.output[-1]
            lengths[i] = s.length + s.generated - 1
        k_probs = max(self.slots[i].req.n_probs for i in active)
        t0 = time.perf_counter()
        logits, _ = forward(self.params, self.cfg, tokens[:, None].to(dev),
                            lengths[:, None].to(dev), self.cache,
                            decode_attn=self.decode_attn)
        logits = _mask_pad_vocab(logits[:, 0].to(torch.float32),
                                 self.cfg.vocab_size)
        valid = _window_mask(self.ring_cnt, self._sp["penalty_last_n"])
        nxt, self._sampler_state = sample_ex(
            logits, self._sp, self._gens, self._sampler_state, self.ring,
            valid, features=self._features)
        rows = torch.arange(self.n_slots, device=dev)
        self.ring[rows, (self.ring_cnt % PENALTY_WINDOW).long()] = nxt.to(
            torch.int32)
        self.ring_cnt += 1
        if k_probs:
            lp = torch.log_softmax(logits, dim=-1)
            top_lp, top_id = torch.topk(lp, k_probs, dim=-1)
            chosen = torch.gather(lp, 1, nxt[:, None])[:, 0]
            p_id, p_lp = top_id.cpu().numpy(), top_lp.cpu().numpy()
            p_chosen = chosen.cpu().tolist()
        nxt = nxt.tolist()
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode_tokens += len(active)
        self.perf.n_decode_steps += 1
        for i in active:
            req = self.slots[i].req
            # the token fed this step had its KV row written
            self.slots[i].kv_hist.append(int(tokens[i]))
            if k_probs and req.n_probs:
                req.logprobs.append((p_id[i, :req.n_probs],
                                     p_lp[i, :req.n_probs], p_chosen[i]))
            self._push_token_host_only(i, int(nxt[i]))
        return True

    # --- sequence/state ops ----------------------------------------------------

    def save_slot(self, i: int) -> bytes:
        raise _not_ported("slot save/restore", "9")

    def restore_slot(self, i: int, data: bytes) -> None:
        raise _not_ported("slot save/restore", "9")

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
