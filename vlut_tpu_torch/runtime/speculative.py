"""Speculative decoding: draft-model propose, target verify (port of
vlut_tpu/runtime/speculative.py).

Every round a draft model decodes k tokens (or a matcher proposes them), the
target scores all k+1 positions in one forward, and each row accepts the
longest prefix where the target's greedy choice equals the proposal, so the
output equals plain greedy decoding of the target.

The JAX package runs the rounds as a ``jax.lax.while_loop`` inside one
jitted program.  Here each round is one step program over static tensors
(``runtime.step_graph.step_runner``: a CUDA graph on the card, captured at
its second round and replayed after; eager on the CPU or with
``cuda_graph=False``), and a host loop runs rounds until every row has
``max_new`` tokens, reading the rows' counts back after each round.  A
round's state (last token, lengths, output buffer and counts; the history of
prompt lookup; the window, n-gram pool, pool pointer and Jacobi carry of
lookahead) is updated in place, so every round computes what the JAX
function's loop body computes.

* :func:`make_speculative_fn`: draft model, k+1 draft decodes per round (the
  extra one writes the last proposal's KV so an all-accepted round leaves
  no hole), optional vocab translation (:func:`build_vocab_translation`);
* :func:`make_lookup_fn`: prompt lookup, the most recent earlier
  occurrence of the trailing n-gram proposes what followed it, else the
  previous round's target continuation (the Jacobi carry);
* :func:`make_lookahead_round` / :func:`make_lookahead_fn`: windowed
  lookahead, T = 1 + (G-1)(W+1) rows per round under a (B, T, S) mask.

Greedy only, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models.transformer import forward
from vlut_tpu_torch.runtime.kv_cache import max_len_of
from vlut_tpu_torch.runtime.step_graph import step_runner


def vocab_mask(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Logits past the vocabulary (a padded head) to -1e30."""
    v = logits.shape[-1]
    if v == vocab_size:
        return logits
    return logits.masked_fill(
        torch.arange(v, device=logits.device) >= vocab_size, -1e30)


def greedy(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    return torch.argmax(vocab_mask(logits.to(torch.float32), vocab_size),
                        dim=-1)


def n_accepted(tgt: torch.Tensor, props: torch.Tensor) -> torch.Tensor:
    """(B,) proposals accepted: the index of the first mismatch of
    ``tgt[:, :k]`` against ``props`` (k when all match)."""
    k = props.shape[1]
    return torch.cumprod((tgt[:, :k] == props).long(), dim=1).sum(dim=1)


def write_at(buf: torch.Tensor, rows: torch.Tensor,
             start: torch.Tensor) -> None:
    """buf[b, start[b] + j] = rows[b, j], in place; a block that would run
    past the buffer is shifted back to end at its last column, as
    ``jax.lax.dynamic_update_slice`` shifts it."""
    n = rows.shape[1]
    start = torch.clamp(start, max=buf.shape[1] - n)
    buf.scatter_(1, start[:, None] + torch.arange(n, device=buf.device),
                 rows.to(buf.dtype))


def draft_tokens(params_d, cfg_d: ModelConfig, cache_d: dict,
                 tok: torch.Tensor, lengths: torch.Tensor, n: int,
                 decode_attn: str = "fused") -> torch.Tensor:
    """n greedy draft decodes from draft ids ``tok`` at rows ``lengths``,
    each argmax fed to the next on the device; returns (B, n) draft ids."""
    out = []
    for j in range(n):
        lg, _ = forward(params_d, cfg_d, tok[:, None], (lengths + j)[:, None],
                        cache_d, decode_attn=decode_attn)
        tok = greedy(lg[:, 0], cfg_d.vocab_size)
        out.append(tok)
    return torch.stack(out, dim=1)


def verify(params_t, cfg_t: ModelConfig, cache_t: dict, last: torch.Tensor,
           props: torch.Tensor, lengths: torch.Tensor,
           decode_attn: str = "fused") -> tuple[torch.Tensor, torch.Tensor]:
    """One target forward over [last, props] at rows lengths..lengths+k;
    returns the (B, k+1) greedy target tokens and (B,) accepted counts."""
    k = props.shape[1]
    seq = torch.cat([last[:, None], torch.clamp(props, min=0)], dim=1)
    pos = lengths[:, None] + torch.arange(k + 1, device=last.device)
    lg, _ = forward(params_t, cfg_t, seq, pos, cache_t,
                    decode_attn=decode_attn)
    tgt = greedy(lg, cfg_t.vocab_size)
    return tgt, n_accepted(tgt, props)


class VocabMap:
    """Draft <-> target id translation on the device: ``d2t`` (draft id ->
    target id, -1 where the draft piece has none) and ``t2d``."""

    def __init__(self, d2t, t2d, device):
        self.d2t = torch.as_tensor(np.asarray(d2t), dtype=torch.long,
                                   device=device)
        self.t2d = torch.as_tensor(np.asarray(t2d), dtype=torch.long,
                                   device=device)

    def to_draft(self, tok_t: torch.Tensor) -> torch.Tensor:
        # untranslatable target ids feed draft token 0
        return torch.clamp(self.t2d[torch.clamp(tok_t, min=0)], min=0)

    def to_target(self, tok_d: torch.Tensor) -> torch.Tensor:
        # -1 (no target piece) never equals a target argmax: it self-rejects
        return self.d2t[torch.clamp(tok_d, min=0)]


def _run_rounds(round_fn: Callable, cnt: torch.Tensor, max_new: int,
                device, cuda_graph: bool) -> torch.Tensor:
    """Run ``round_fn`` (which returns the round's (B,) accepted counts)
    until every row's count reaches ``max_new`` or ``max_new`` rounds ran;
    returns the (max_new, B) accepted counts (zeros past the last round)."""
    run = step_runner(round_fn, device, cuda_graph)
    accs = torch.zeros((max_new, cnt.shape[0]), dtype=torch.long,
                       device=device)
    rnd = 0
    while rnd < max_new and int(cnt.min()) < max_new:
        accs[rnd] = run()
        rnd += 1
    return accs


def make_speculative_fn(cfg_t: ModelConfig, cfg_d: ModelConfig, k_draft: int,
                        max_new: int, vocab_map: tuple | None = None,
                        decode_attn: str = "fused",
                        cuda_graph: bool = True) -> Callable:
    """f(params_t, params_d, cache_t, cache_d, last, lengths) -> (out (B,
    max_new), n_generated (B,), accs (max_new, B), cache_t, cache_d), the
    caches updated in place.  ``last``/``lengths`` and the tokens are target
    ids; ``vocab_map`` (d2t, t2d) from :func:`build_vocab_translation`
    bridges a draft with another vocabulary."""

    @torch.inference_mode()
    def spec_generate(params_t, params_d, cache_t, cache_d, last, lengths):
        dev = last.device
        b = last.shape[0]
        vm = VocabMap(*vocab_map, dev) if vocab_map is not None else None
        last = last.to(torch.long).clone()
        lengths = lengths.to(torch.long).clone()
        out = torch.zeros((b, max_new + k_draft + 1), dtype=torch.long,
                          device=dev)
        cnt = torch.zeros((b,), dtype=torch.long, device=dev)

        def round_fn():
            props = draft_tokens(params_d, cfg_d, cache_d,
                                 vm.to_draft(last) if vm else last, lengths,
                                 k_draft + 1, decode_attn)[:, :k_draft]
            if vm:
                props = vm.to_target(props)
            tgt, n_acc = verify(params_t, cfg_t, cache_t, last, props,
                                lengths, decode_attn)
            write_at(out, tgt, cnt)
            cnt.copy_(torch.clamp(cnt + n_acc + 1, max=max_new))
            lengths.add_(n_acc + 1)
            last.copy_(torch.gather(tgt, 1, n_acc[:, None])[:, 0])
            return n_acc

        accs = _run_rounds(round_fn, cnt, max_new, dev, cuda_graph)
        return out[:, :max_new], cnt, accs, cache_t, cache_d

    return spec_generate


def _lookup_propose(history: torch.Tensor, hist_cnt: torch.Tensor,
                    ngram: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row: the k tokens after the most recent strictly earlier
    occurrence of the trailing n-gram of ``history[:hist_cnt]`` (-1 where
    there is none), and whether there was one."""
    h = history.shape[1]
    dev = history.device
    tail = torch.gather(history, 1, torch.clamp(hist_cnt - ngram, min=0)[
        :, None] + torch.arange(ngram, device=dev))
    idx = torch.arange(h - ngram - k, device=dev)
    win = history.unfold(1, ngram, 1)[:, :h - ngram - k]
    ok = (win == tail[:, None, :]).all(-1)
    ok &= (idx + ngram)[None, :] <= (hist_cnt - 1)[:, None]
    found = ok.any(dim=1)
    best = torch.where(ok, idx[None, :], torch.full_like(ok, -1,
                                                         dtype=torch.long))
    best = torch.clamp(best.amax(dim=1), min=0)
    props = torch.gather(history, 1, (best + ngram)[:, None]
                         + torch.arange(k, device=dev))
    return torch.where(found[:, None], props, torch.full_like(props, -1)), found


def _jacobi_next(tgt: torch.Tensor, n_acc: torch.Tensor, width: int,
                 k: int) -> torch.Tensor:
    """The next round's guesses: tgt[:, n_acc+1 : n_acc+1+k] of the first
    ``width`` target tokens, tail-padded with the last of them."""
    pad = torch.cat([tgt[:, :width], tgt[:, width - 1:width].expand(-1, k)],
                    dim=1)
    return torch.gather(pad, 1, (n_acc + 1)[:, None]
                        + torch.arange(k, device=tgt.device))


def make_lookup_fn(cfg: ModelConfig, k_draft: int, max_new: int,
                   ngram: int = 2, decode_attn: str = "fused",
                   jacobi_fallback: bool = True,
                   cuda_graph: bool = True) -> Callable:
    """Prompt-lookup (n-gram) speculative decoding, no draft model.

    f(params, cache, history, hist_cnt, last, lengths) -> (out (B,
    max_new), n_generated (B,), accs, cache): ``history`` (B, H) holds the
    prompt (and any earlier output) per row, ``hist_cnt`` its valid
    length, ``last`` the last decoded token.  Rows without an n-gram match
    propose the previous round's target continuation (``jacobi_fallback``)."""

    @torch.inference_mode()
    def lookup_generate(params, cache, history, hist_cnt, last, lengths):
        dev = last.device
        b, h = history.shape
        history = history.to(torch.long).clone()
        hist_cnt = hist_cnt.to(torch.long).clone()
        last = last.to(torch.long).clone()
        lengths = lengths.to(torch.long).clone()
        out = torch.zeros((b, max_new + k_draft + 1), dtype=torch.long,
                          device=dev)
        cnt = torch.zeros((b,), dtype=torch.long, device=dev)
        jac = torch.full((b, k_draft), -1, dtype=torch.long, device=dev)

        def round_fn():
            props, found = _lookup_propose(history, hist_cnt, ngram, k_draft)
            if jacobi_fallback:
                props = torch.where(found[:, None], props, jac)
            tgt, n_acc = verify(params, cfg, cache, last, props, lengths,
                                decode_attn)
            write_at(out, tgt, cnt)
            write_at(history, tgt, hist_cnt)
            n_new = n_acc + 1
            cnt.copy_(torch.clamp(cnt + n_new, max=max_new))
            hist_cnt.copy_(torch.clamp(hist_cnt + n_new, max=h))
            lengths.add_(n_new)
            last.copy_(torch.gather(tgt, 1, n_acc[:, None])[:, 0])
            jac.copy_(_jacobi_next(tgt, n_acc, k_draft + 1, k_draft))
            return n_acc

        accs = _run_rounds(round_fn, cnt, max_new, dev, cuda_graph)
        return out[:, :max_new], cnt, accs, cache

    return lookup_generate


def _la_structure(window: int, ngram: int):
    """Static round structure: (T, lvls, intra-round mask (T, T), rope
    offsets (T,)).  A round's rows are

      [ current | verification candidate (ngram-1) | W branches x (ngram-1) ]
    """
    lvls = ngram - 1
    t_total = 1 + lvls + window * lvls
    m_small = np.zeros((t_total, t_total), bool)
    m_small[:, 0] = True
    for i in range(t_total):
        m_small[i, i] = True
    for i in range(1, lvls + 1):  # verification rows 1..lvls
        m_small[i, 1:i + 1] = True
    for w in range(window):
        base = 1 + lvls + w * lvls
        for lv in range(lvls):
            m_small[base + lv, base:base + lv + 1] = True
    off = np.zeros((t_total,), np.int64)
    off[1:lvls + 1] = np.arange(1, lvls + 1)
    for w in range(window):
        base = 1 + lvls + w * lvls
        off[base:base + lvls] = np.arange(1, lvls + 1)
    return t_total, lvls, m_small, off


def _la_select_candidate(pool: torch.Tensor, ptr: torch.Tensor,
                         last: torch.Tensor, jac: torch.Tensor) -> torch.Tensor:
    """Per row: the most recent pool n-gram whose first token is the current
    token (its other tokens), else the Jacobi carry."""
    p = pool.shape[1]
    idx = torch.arange(p, device=pool.device)
    age = torch.remainder(ptr[:, None] - 1 - idx[None, :], p)  # 0 = newest
    keyed = pool[:, :, 0] == last[:, None]
    score = torch.where(keyed, -age, torch.full_like(age, -(p + 1)))
    best = torch.argmax(score, dim=1)
    cand = pool[torch.arange(pool.shape[0], device=pool.device), best, 1:]
    return torch.where(keyed.any(dim=1)[:, None], cand, jac)


def la_state(n: int, window: int, ngram: int, pool_size: int = 64,
             device="cpu") -> dict[str, torch.Tensor]:
    """A lookahead round's carried state for n rows: the window guesses,
    the n-gram pool and its pointer, and the Jacobi carry."""
    lvls = ngram - 1
    return {
        "win": torch.zeros((n, window, lvls), dtype=torch.long,
                           device=device),
        "pool": torch.full((n, pool_size, ngram), -1, dtype=torch.long,
                           device=device),
        "ptr": torch.zeros((n,), dtype=torch.long, device=device),
        "jac": torch.full((n, lvls), -1, dtype=torch.long, device=device),
    }


def make_lookahead_round(cfg: ModelConfig, window: int = 8, ngram: int = 3,
                         decode_attn: str = "fused") -> Callable:
    """One windowed-lookahead round (the JAX package's jitted
    ``la_round``): f(params, cache, last, lengths, state) -> (emitted (B,
    lvls+1), n_acc (B,)), ``state`` (:func:`la_state`) updated in place.
    The caller commits emitted[b, :n_acc[b]+1].  The T round tokens write
    cache rows lengths..lengths+T-1; only rows up to lengths+n_acc+1 stay
    valid, so callers leave T rows of headroom."""
    t_total, lvls, m_small_np, off_np = _la_structure(window, ngram)
    consts: dict = {}

    def la_round(params, cache, last, lengths, st):
        dev = last.device
        if dev not in consts:
            consts[dev] = (torch.from_numpy(m_small_np).to(dev),
                           torch.from_numpy(off_np).to(dev))
        m_small, off = consts[dev]
        b = last.shape[0]
        s_max = max_len_of(cache)
        win, pool, ptr, jac = st["win"], st["pool"], st["ptr"], st["jac"]
        cand = _la_select_candidate(pool, ptr, last, jac)
        seq = torch.cat([last[:, None], torch.clamp(cand, min=0),
                         win.reshape(b, window * lvls)], dim=1)
        pos = lengths[:, None] + off[None, :]
        s_idx = torch.arange(s_max, device=dev)
        rel = s_idx[None, None, :] - lengths[:, None, None]  # (B, 1, S)
        committed = s_idx[None, None, :] < lengths[:, None, None]
        in_round = (rel >= 0) & (rel < t_total)
        rel_c = torch.clamp(rel, 0, t_total - 1)
        block = m_small[torch.arange(t_total, device=dev)[None, :, None],
                        rel_c]  # (B, T, S)
        mask = committed | (in_round & block)
        lg, _ = forward(params, cfg, seq, pos, cache, decode_attn=decode_attn,
                        attn_mask=mask)
        tgt = greedy(lg, cfg.vocab_size)  # (B, T)
        n_acc = n_accepted(tgt, cand)
        emitted = tgt[:, :lvls + 1]
        jac.copy_(_jacobi_next(tgt, n_acc, lvls + 1, lvls))
        # window refinement (one Jacobi step) and n-gram harvest
        y_win = tgt[:, 1 + lvls:].reshape(b, window, lvls)
        grams = torch.cat([win, y_win[:, :, -1:]], dim=2)  # (B, W, ngram)
        idxs = torch.remainder(ptr[:, None] + torch.arange(window,
                                                           device=dev),
                               pool.shape[1])
        pool.scatter_(1, idxs[:, :, None].expand(-1, -1, ngram), grams)
        ptr.add_(window)
        win.copy_(y_win)
        return emitted, n_acc

    la_round.t_total = t_total
    return la_round


def make_lookahead_fn(cfg: ModelConfig, max_new: int, window: int = 8,
                      ngram: int = 3, pool_size: int = 64,
                      decode_attn: str = "fused",
                      cuda_graph: bool = True) -> Callable:
    """Windowed lookahead decoding (Fu et al. 2024; the reference's
    examples/lookahead): draft-free speculation from a 2-D Jacobi window
    and an n-gram pool, one forward per round under a custom mask.

    f(params, cache, last, lengths) -> (out (B, max_new), n_generated (B,),
    accs, cache)."""
    la_round = make_lookahead_round(cfg, window, ngram, decode_attn)
    lvls = ngram - 1

    @torch.inference_mode()
    def lookahead_generate(params, cache, last, lengths):
        dev = last.device
        b = last.shape[0]
        last = last.to(torch.long).clone()
        lengths = lengths.to(torch.long).clone()
        out = torch.zeros((b, max_new + lvls + 1), dtype=torch.long,
                          device=dev)
        cnt = torch.zeros((b,), dtype=torch.long, device=dev)
        st = la_state(b, window, ngram, pool_size, dev)

        def round_fn():
            emitted, n_acc = la_round(params, cache, last, lengths, st)
            write_at(out, emitted, cnt)
            n_new = n_acc + 1
            cnt.copy_(torch.clamp(cnt + n_new, max=max_new))
            lengths.add_(n_new)
            last.copy_(torch.gather(emitted, 1, n_acc[:, None])[:, 0])
            return n_acc

        accs = _run_rounds(round_fn, cnt, max_new, dev, cuda_graph)
        return out[:, :max_new], cnt, accs, cache

    return lookahead_generate


def build_vocab_translation(src_pieces, dst_pieces) -> np.ndarray:
    """src id -> dst id where the piece text maps to a dst token (its first
    id), -1 elsewhere.  Untranslatable proposals fail verification, so
    coverage gaps cost speed, never correctness."""
    index: dict[str, int] = {}
    for j, p in enumerate(dst_pieces):
        index.setdefault(p, j)
    out = np.full((len(src_pieces),), -1, np.int32)
    for i, p in enumerate(src_pieces):
        j = index.get(p)
        if j is not None:
            out[i] = j
    return out
