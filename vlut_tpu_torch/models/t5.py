"""T5 encoder-decoder, port of ``vlut_tpu/models/t5.py``.

``encode`` (bidirectional, relative position buckets), ``decode_logits``
(the teacher-forced decoder with cross-attention over the encoder output)
and a host ``generate`` loop that recomputes the decoder over the whole
output for each token.  T5's quirks kept: an RMS LayerNorm (eps 1e-6),
attention scores not scaled, one relative-bias table per stack shared by
its blocks, a tied head scaled by ``d_model ** -0.5``, an inner attention
width ``n_heads * d_kv`` apart from ``d_model``.  Weights are dense floats
(public T5 checkpoints are never ternary), held in float32 as the JAX
package promotes them in every product, so no kernel of the port runs
here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vlut_tpu_torch.device import full_float32
from vlut_tpu_torch.models.ssm import TreeLM


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int
    d_model: int
    d_kv: int
    d_ff: int
    n_layers: int          # encoder blocks
    n_dec_layers: int      # decoder blocks
    n_heads: int
    rel_buckets: int = 32
    rel_max_distance: int = 128
    ln_eps: float = 1e-6
    gated: bool = True     # t5 v1.1 / flan gated act; False = classic relu
    act: str = "gelu"      # dense_act_fn (gelu_new -> tanh gelu) | "relu"
    tie_embeddings: bool = True
    decoder_start_token_id: int = 0
    eos_id: int = 1
    max_seq_len: int = 512


def _rms(x, w, eps):
    x = x.to(torch.float32)
    v = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(v + eps) * w


def rel_bucket(rel: torch.Tensor, bidirectional: bool, n_buckets: int,
               max_dist: int) -> torch.Tensor:
    """HF ``T5Attention._relative_position_bucket`` (rel = mem_pos -
    q_pos).  The log bucket is ``max_exact + int(log(d / max_exact) /
    log(max_dist / max_exact) * (n - max_exact))`` in float32, each step
    rounded as the JAX package rounds it (a float32 log, division and
    product; the truncation toward zero); ``tests/test_torch_t5.py`` holds
    every distance equal to the JAX package's buckets."""
    ret = torch.zeros_like(rel)
    n = n_buckets
    if bidirectional:
        n //= 2
        ret = ret + (rel > 0).to(rel.dtype) * n
        rel_abs = rel.abs()
    else:
        rel_abs = torch.clamp(-rel, min=0)
    max_exact = n // 2
    is_small = rel_abs < max_exact
    ratio = torch.clamp(rel_abs, min=1).to(torch.float32) / max_exact
    scaled = (torch.log(ratio) / float(np.log(max_dist / max_exact))
              * (n - max_exact))
    log_big = max_exact + scaled.to(rel.dtype)
    log_big = torch.clamp(log_big, max=n - 1)
    return ret + torch.where(is_small, rel_abs, log_big)


def _rel_bias(table: torch.Tensor, q_len: int, k_len: int,
              bidirectional: bool, n_buckets: int, max_dist: int):
    """(buckets, H) table -> (1, H, q_len, k_len) additive bias."""
    ctx = torch.arange(q_len, device=table.device)[:, None]
    mem = torch.arange(k_len, device=table.device)[None, :]
    buckets = rel_bucket(mem - ctx, bidirectional, n_buckets, max_dist)
    return table[buckets].permute(2, 0, 1)[None]


def _attn(q, k, v, bias):
    """(B, T, H, d) x (B, S, H, d); bias (B|1, H, T, S).  Unscaled."""
    sc = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                      k.to(torch.float32)) + bias
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.to(torch.float32))


def _heads(x, w, h):
    y = x @ w
    return y.reshape(*x.shape[:-1], h, -1)


def _mlp(x, lp, cfg):
    h = _rms(x, lp["ffn_norm"], cfg.ln_eps)
    if cfg.gated:
        g = h @ lp["wi0"]
        u = h @ lp["wi1"]
        act = (torch.nn.functional.gelu(g, approximate="tanh")
               if cfg.act == "gelu" else torch.relu(g))
        a = act * u
    else:
        a = torch.relu(h @ lp["wi"])
    return x + a @ lp["wo_ffn"]


def _blocks(stack: dict[str, torch.Tensor], n: int) -> list[dict]:
    return [{k: v[i] for k, v in stack.items()} for i in range(n)]


@torch.inference_mode()
@full_float32()
def encode(model: TreeLM, cfg: T5Config, tokens: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder: (B, T) -> (B, T, D) float32."""
    p = model.params
    x = p["embed"][tokens].to(torch.float32)
    t = tokens.shape[1]
    pad = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).to(
        torch.float32)
    bias = _rel_bias(p["enc_rel_bias"], t, t, True, cfg.rel_buckets,
                     cfg.rel_max_distance) + pad
    h = cfg.n_heads
    for lp in _blocks(p["enc_layers"], cfg.n_layers):
        hh = _rms(x, lp["attn_norm"], cfg.ln_eps)
        q, k, v = (_heads(hh, lp[n], h) for n in ("wq", "wk", "wv"))
        att = _attn(q, k, v, bias).reshape(*x.shape[:-1], -1)
        x = _mlp(x + att @ lp["wo"], lp, cfg)
    return _rms(x, p["enc_final_norm"], cfg.ln_eps)


@torch.inference_mode()
@full_float32()
def decode_logits(model: TreeLM, cfg: T5Config, dec_tokens: torch.Tensor,
                  enc_out: torch.Tensor,
                  enc_mask: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass -> (B, T_dec, V) float32 logits."""
    p = model.params
    t = dec_tokens.shape[1]
    dev = dec_tokens.device
    x = p["embed"][dec_tokens].to(torch.float32)
    ar = torch.arange(t, device=dev)
    causal = torch.where(ar[None, :] <= ar[:, None], 0.0, -1e30).to(
        torch.float32)[None, None]
    self_bias = _rel_bias(p["dec_rel_bias"], t, t, False, cfg.rel_buckets,
                          cfg.rel_max_distance) + causal
    cross_bias = torch.where(enc_mask[:, None, None, :] > 0, 0.0, -1e30).to(
        torch.float32)
    h = cfg.n_heads
    for lp in _blocks(p["dec_layers"], cfg.n_dec_layers):
        hh = _rms(x, lp["attn_norm"], cfg.ln_eps)
        q, k, v = (_heads(hh, lp[n], h) for n in ("wq", "wk", "wv"))
        x = x + _attn(q, k, v, self_bias).reshape(*x.shape[:-1], -1) \
            @ lp["wo"]
        hh = _rms(x, lp["cross_norm"], cfg.ln_eps)
        q = _heads(hh, lp["cross_wq"], h)
        ck = _heads(enc_out, lp["cross_wk"], h)
        cv = _heads(enc_out, lp["cross_wv"], h)
        x = x + _attn(q, ck, cv, cross_bias).reshape(*x.shape[:-1], -1) \
            @ lp["cross_wo"]
        x = _mlp(x, lp, cfg)
    x = _rms(x, p["dec_final_norm"], cfg.ln_eps)
    head = p.get("lm_head")
    if head is None:
        # tied: T5 rescales by d_model ** -0.5 before the shared embedding
        x = x * (cfg.d_model ** -0.5)
        head = p["embed"].T
    return x @ head


@torch.inference_mode()
@full_float32()
def generate(model: TreeLM, cfg: T5Config, enc_tokens, n_new: int = 32,
             temp: float = 0.0, seed: int = 0) -> list[int]:
    """Greedy (or, with ``temp``, sampled from a generator seeded by
    ``seed``) seq2seq generation, the decoder recomputed over the whole
    output each step; stops after ``eos_id``."""
    dev = model.device
    enc = torch.as_tensor(np.atleast_2d(np.asarray(enc_tokens, np.int64)),
                          device=dev)
    mask = torch.ones_like(enc)
    enc_out = encode(model, cfg, enc, mask)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = [cfg.decoder_start_token_id]
    for _ in range(n_new):
        dec = torch.tensor([out], device=dev)
        logits = decode_logits(model, cfg, dec, enc_out, mask)[0, -1]
        if temp > 0:
            u = torch.rand(logits.shape, generator=gen, device=dev).clamp(
                min=torch.finfo(torch.float32).tiny)
            nxt = int((logits / temp - torch.log(-torch.log(u))).argmax())
        else:
            nxt = int(torch.argmax(logits))
        out.append(nxt)
        if nxt == cfg.eos_id:
            break
    return out[1:]

