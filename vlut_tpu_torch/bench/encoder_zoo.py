"""The encoder half of the non-transformer families on the card: each family
as a small random-weight model, held against the same model on the CPU,
and the full-width diffusion and encoder runs of ``chip_smoke.py`` phase
23.

Families (:data:`FAMILIES`): the checkpoints the JAX tests convert
(``tests/test_encoder.py``, ``test_encoder_variants.py``,
``test_archs_wave5.py``, ``test_t5.py``, ``test_gemma3n.py``): bert,
modernbert, neobert, nomic-bert, nomic-bert-moe, jina-bert-v2 and
jina-bert-v3 (its ``retrieval`` adapter), T5 gated and ungated, gemma3n;
their configs and tensor shapes are kept in ``encoder_families.json``
(:data:`STRUCTURES`, held by ``tests/test_torch_encoder_zoo.py`` to what
the JAX converters write) and filled with random values from a seed by
each tensor's role.  And three diffusion LMs: ``llada`` and ``dream``
(``tests/fixtures/tiny_real``'s trained weights run bidirectionally, in
place and shifted; llada's tree fused, so its projections take #1, dream's
unfused, #4) and ``llada_moe`` (the JAX test's llada_moe config from the
same file, the port's ``init_params``; every expert through #4), each
packed and as its float twin, through ``diffusion_generate``.

    python -m vlut_tpu_torch.bench.encoder_zoo [--family NAME ...]
        [--device cpu]

prints one JSON line per family (:func:`card_vs_cpu`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time

import numpy as np
import torch

from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models import encoder, gemma3n, t5
from vlut_tpu_torch.models import transformer as tt

STRUCTURES: dict = json.loads(
    (pathlib.Path(__file__).with_name("encoder_families.json")).read_text())
DIFFUSION = ("llada", "dream", "llada_moe")
FAMILIES = tuple(k for k in STRUCTURES if k != "llada_moe") + DIFFUSION
FIXTURE = pathlib.Path(__file__).resolve().parents[2] / "tests" / \
    "fixtures" / "tiny_real"
# float families: outputs within this share of the CPU's largest value
# (float32 products summed in another order on the card)
FLOAT_TOL = 1e-4
# pooled, unit-length embeddings: largest absolute difference
EMBED_TOL = 1e-5
TASKS = {"jina-bert-v3": "retrieval"}
_CONFIGS = {"encoder": encoder.EncoderConfig, "t5": t5.T5Config,
            "gemma3n": gemma3n.Gemma3nConfig}


def config_of(name: str):
    entry = STRUCTURES[name]
    mc = {k: tuple(v) if isinstance(v, list) else v
          for k, v in entry["config"].items()}
    if entry["family"] == "transformer":
        from vlut_tpu_torch.config import ModelConfig

        return ModelConfig(**mc)
    return _CONFIGS[entry["family"]](**mc)


def _values(key: str, shape: list[int], rng: np.random.Generator
            ) -> np.ndarray:
    """Random float32 values for one tensor by its role: norm gains and
    scales near 1, biases small, relative-bias tables and embeddings at
    0.5, matrices at 1 / sqrt(fan-in)."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf in ("a", "b"):  # a task adapter's LoRA factors
        return 0.1 * rng.standard_normal(shape)
    if ("norm" in leaf and not leaf.endswith("_b")) or \
            leaf == "altup_correct_scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if leaf.endswith("_b") or leaf in ("bq", "bk", "bv", "bo", "bqkv",
                                       "b_up", "b_down", "b_in"):
        return 0.02 * rng.standard_normal(shape)
    if "rel_bias" in leaf or "embed" in leaf:
        return 0.5 * rng.standard_normal(shape)
    if len(shape) >= 2:
        return rng.standard_normal(shape) / math.sqrt(shape[-2])
    return 0.1 * rng.standard_normal(shape)


def random_tree(tensors: dict, seed: int = 0) -> dict:
    """A tree of float32 CPU tensors, random from ``seed`` by each
    tensor's role (:func:`_values`), from dotted names to shapes
    (per-layer trees as lists)."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for key, shape in tensors.items():
        *parts, last = key.split(".")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = torch.from_numpy(
            _values(key, shape, rng).astype(np.float32))

    def listed(node):
        if not isinstance(node, dict):
            return node
        out = {k: listed(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[k] for k in sorted(out, key=int)]
        return out
    return listed(tree)


def family(name: str, seed: int = 0):
    """(cfg, tree of CPU tensors) of a float family, random from ``seed``
    in its checkpoint's layout."""
    return config_of(name), random_tree(STRUCTURES[name]["tensors"], seed)


# answerdotai/ModernBERT-base widths (its config.json: hidden 768, 22
# layers, 12 heads, intermediate 1152, vocabulary 50368, local attention
# 128 with a global layer every 3, rope thetas 160000 / 10000, norm eps
# 1e-5, 8192 positions, mean pooling) as the JAX converter maps them: the
# timed encoder of chip_smoke.py phase 23
MODERNBERT_BASE = encoder.EncoderConfig(
    arch="modernbert", vocab_size=50368, d_model=768, n_layers=22,
    n_heads=12, d_ff=1152, max_seq_len=8192, ln_eps=1e-5, pooling="mean",
    local_window=128, global_every=3, rope_theta_global=160000.0,
    rope_theta_local=10000.0)


def modernbert_layout(cfg) -> dict[str, tuple[int, ...]]:
    """A ModernBERT checkpoint's tensors and shapes (the JAX converter's
    stacked layout) at ``cfg``'s widths."""
    d, ff, n_l = cfg.d_model, cfg.d_ff, cfg.n_layers
    return {
        "embed": (cfg.vocab_size, d), "embed_norm": (d,), "final_norm": (d,),
        "layers.attn_norm": (n_l, d), "layers.wqkv": (n_l, d, 3 * d),
        "layers.wo": (n_l, d, d), "layers.mlp_norm": (n_l, d),
        "layers.w_in": (n_l, d, 2 * ff), "layers.w_out": (n_l, ff, d),
    }


def model_on(cfg, tree, device):
    from vlut_tpu_torch.convert.checkpoint import model_from_tree

    dev = resolve_device(device)

    def to(node):
        if isinstance(node, dict):
            return {k: to(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to(v) for v in node]
        return node.to(dev)
    return model_from_tree(cfg, to(tree))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def _float_family(name, cfg, cpu, card, seed):
    """A float family's outputs on the card against the CPU's."""
    from vlut_tpu_torch.convert.checkpoint import family_of

    rng = np.random.default_rng(seed)
    fam = family_of(cfg)
    out: dict = {}
    dev = card.device
    if fam == "encoder":
        b, t = 2, 24
        toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, t)))
        mask = torch.ones_like(toks)
        mask[1, t - 5:] = 0
        errs, emb = [], []
        for task in (None, TASKS.get(name)) if name in TASKS else (None,):
            want = encoder.forward_encoder(cpu, cfg, toks, mask, task=task)
            got = encoder.forward_encoder(card, cfg, toks.to(dev),
                                          mask.to(dev), task=task)
            valid = mask.bool()
            errs.append(_rel(got.cpu()[valid], want[valid]))
            ew = encoder.embed(cpu, cfg, toks, mask, task=task)
            eg = encoder.embed(card, cfg, toks.to(dev), mask.to(dev),
                               task=task)
            emb.append(float((eg.cpu() - ew).abs().max()))
        out.update(max_rel_err=max(errs), embed_abs_err=max(emb),
                   within_tol=max(errs) <= FLOAT_TOL
                   and max(emb) <= EMBED_TOL, equal=max(emb) <= EMBED_TOL)
    elif fam == "t5":
        enc = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 20)))
        dec = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 7)))
        mask = torch.ones_like(enc)
        mask[1, 16:] = 0
        ew = t5.encode(cpu, cfg, enc, mask)
        eg = t5.encode(card, cfg, enc.to(dev), mask.to(dev))
        lw = t5.decode_logits(cpu, cfg, dec, ew, mask)
        lg = t5.decode_logits(card, cfg, dec.to(dev), eg, mask.to(dev))
        prompt = rng.integers(2, cfg.vocab_size, 10)
        gw = t5.generate(cpu, cfg, prompt, n_new=8)
        gg = t5.generate(card, cfg, prompt, n_new=8)
        errs = [_rel(eg, ew), _rel(lg, lw)]
        out.update(max_rel_err=max(errs), tokens=gw, equal=gg == gw,
                   within_tol=max(errs) <= FLOAT_TOL)
    else:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
        lw = gemma3n.forward(cpu, cfg, toks)
        lg = gemma3n.forward(card, cfg, toks.to(dev))
        err = _rel(lg, lw)
        out.update(max_rel_err=err, within_tol=err <= FLOAT_TOL,
                   equal=torch.equal(lg.cpu().argmax(-1), lw.argmax(-1)))
    return out


def diffusion_pair(name: str, device, seed: int = 0):
    """(cfg, packed model on the CPU, on ``device``): ``llada`` (fused
    tree) and ``dream`` (shifted, unfused) over tiny_real's weights,
    ``llada_moe`` from its config by ``init_params``."""
    from vlut_tpu_torch.convert.checkpoint import (load_checkpoint,
                                                   model_from_tree)

    if name == "llada_moe":
        # the converter keeps LLaDA-MoE's mask id, past this vocabulary
        cfg = dataclasses.replace(config_of(name), mask_token_id=63)
        cpu = tt.init_params(cfg, seed=seed)
    else:
        cfg, cpu, _ = load_checkpoint(FIXTURE, device="cpu")
        cfg = dataclasses.replace(cfg, causal_attn=False, mask_token_id=255,
                                  diffusion_shift_logits=name == "dream")
        cpu = tt.TransformerLM(cfg, cpu.tree())
        if name == "llada":
            cpu = tt.fuse_projections(cpu, cfg)
    card = model_from_tree(cfg, tt._tree_to(cpu.tree(),
                                            resolve_device(device)))
    return cfg, cpu, card


# the packed diffusion families' kernels at T <= 64 (#1 for llada's
# fused tree, #4 for the others)
DIFFUSION_KERNELS = {"llada": ("ternary_gemm_decode",),
                     "dream": ("ternary_gemm_fused_quant",),
                     "llada_moe": ("ternary_gemm_fused_quant",)}


def _diffusion_family(name, device, counters, seed, prompt=24, n_new=16):
    """Each diffusion family packed and as its float twin: the denoise
    loop's tokens on the card, each of its layers from the CPU's input
    (each forward's layer outputs replaced in call order), equal to the
    CPU's; the free run's tokens are reported."""
    from vlut_tpu_torch.bench.zoo import layers_replaced
    from vlut_tpu_torch.runtime.diffusion import (DiffusionParams,
                                                  diffusion_generate)
    from vlut_tpu_torch.train.finetune import float_twin_params

    cfg, cpu, card = diffusion_pair(name, device, seed)
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, min(cfg.vocab_size, 255), prompt).tolist()
    out: dict = {}
    for kind in ("packed", "twin"):
        if kind == "twin":
            cpu, card = (float_twin_params(cpu, cfg),
                         float_twin_params(card, cfg))
        dp = DiffusionParams(steps=8, block_len=8, alg="low_confidence")
        want_layers, got_layers = [], []
        with layers_replaced(want_layers):
            want = diffusion_generate(cpu, cfg, ids, n_new, dp)
        with layers_replaced(got_layers, by=want_layers):
            got = diffusion_generate(card, cfg, ids, n_new, dp)
        if counters is not None and kind == "packed":
            counters[0]()
        free = diffusion_generate(card, cfg, ids, n_new, dp)
        launches = None
        if counters is not None and kind == "packed":
            launches = counters[1](f"diffusion_{name}",
                                   DIFFUSION_KERNELS[name])
        errs = [_rel(g, w) for g, w in zip(got_layers, want_layers)]
        out[kind] = {"tokens": want, "equal": got == want,
                     "free_equal": free == want,
                     "max_rel_layer_err": max(errs),
                     "forwards": len(want_layers) // cfg.n_layers,
                     "launches": launches,
                     "mask_left": cfg.mask_token_id in got}
    return {"equal": all(v["equal"] and not v["mask_left"]
                         for v in out.values()),
            "within_tol": all(v["max_rel_layer_err"] <= 2e-2
                              for v in out.values()), **out}


def card_vs_cpu(name: str, device, counters=None, seed: int = 0,
                source=None) -> dict:
    """One family on ``device`` against the CPU from the same weights.
    ``counters`` (reset, read) bracket a packed diffusion family's free run
    on the card, which must launch its kernels.  ``source`` (cfg, host
    tree) runs that float model under the label ``name`` instead."""
    t0 = time.perf_counter()
    if name in DIFFUSION and source is None:
        out = _diffusion_family(name, device, counters, seed)
    else:
        cfg, tree = source or family(name, seed)
        cpu, card = model_on(cfg, tree, "cpu"), model_on(cfg, tree, device)
        out = _float_family(name, cfg, cpu, card, seed)
    return {"family": name, **out, "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m vlut_tpu_torch.bench.encoder_zoo")
    ap.add_argument("--family", action="append", choices=list(FAMILIES))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    bad = []
    for name in args.family or FAMILIES:
        out = card_vs_cpu(name, args.device)
        print(json.dumps(out), flush=True)
        if not (out["within_tol"] and out["equal"]):
            bad.append(name)
    if bad:
        raise SystemExit(f"families out of tolerance or off the CPU's "
                         f"tokens: {bad}")


if __name__ == "__main__":
    main()
