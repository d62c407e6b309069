"""The recurrent families on the card: each family as a small random-weight
model, held against the same model on the CPU layer by layer, and the
families' full-width serving runs named.

Families (:data:`FAMILIES`): ``mamba`` (the port's ``init_params``, d 64,
2 layers, with an untied random head), and the checkpoints the JAX tests
convert (``tests/test_mamba2.py``, ``test_rwkv7.py``, ``test_hybrid.py``,
``test_archs_wave6.py``): Mamba2, RWKV7, arwkv7, RWKV6 and 11 hybrid
cases.  Their configs and tensor shapes are kept in
``recurrent_families.json`` (:data:`STRUCTURES`, which
``tests/test_torch_recurrent_zoo.py`` holds equal to what the JAX
converter writes); :func:`family` fills them with random values from a
seed, by the role of each tensor (norm gains near 1, decays and
interpolations in range, matrices at 1/sqrt(fan-in), Mamba2's projections
as packed random trits).

    python -m vlut_tpu_torch.bench.recurrent_zoo [--family NAME ...]
        [--device cpu]

prints one JSON line per family (:func:`card_vs_cpu`).  The full-width
runs: ``python -m vlut_tpu_torch.bench.engine --model mamba_2_8b``
(Mamba-2.8B's widths through the engine, ``chip_smoke.py`` phase 22) and
``codestral_mamba_7b`` (Mamba-Codestral-7B's widths) through
``cli.family_generate``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time

import numpy as np
import torch

from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models import hybrid, rwkv, ssm
from vlut_tpu_torch.ops.packing import pack_ternary

STRUCTURES: dict = json.loads(
    (pathlib.Path(__file__).with_name("recurrent_families.json")).read_text())
FAMILIES = ("mamba",) + tuple(STRUCTURES)
TOL = 2e-2      # a layer's output, of the largest value (as the CPU tests)
LOGIT_TOL = 1e-5  # the logits from the CPU's last hidden state
_CONFIGS = {"mamba2": ssm.Mamba2Config, "rwkv7": rwkv.Rwkv7Config,
            "rwkv6": rwkv.Rwkv6Config, "hybrid": hybrid.HybridConfig}


def _config(entry: dict):
    mc = {k: tuple(v) if isinstance(v, list) else v
          for k, v in entry["config"].items()}
    return _CONFIGS[entry["family"]](**mc)


def _values(key: str, shape: list[int], arch: str, stacked: bool,
            rng: np.random.Generator) -> np.ndarray:
    """Random float32 values for one tensor, by its role (``stacked``: its
    first dim is the layer)."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "A_log":
        # plamo2 stores -exp(A_log) (folded at convert)
        return (-rng.uniform(0.5, 4.0, shape) if arch == "plamo2"
                else np.log(rng.uniform(1.0, 16.0, shape)))
    if leaf in ("dt_bias", "dt_proj_b"):
        return np.log(np.expm1(rng.uniform(1e-3, 0.1, shape)))
    if leaf == "decay":
        return rng.uniform(-6.0, -1.0, shape)
    if (leaf.startswith(("lerp_", "maa_", "cm_lerp_")) and leaf not in
            ("maa_w1", "maa_w2")) or leaf == "k_a":
        return rng.uniform(0.0, 1.0, shape)
    if "norm" in leaf or leaf in ("D", "k_k") or (
            leaf.endswith("_w") and leaf.startswith(("ln", "pre_ln"))):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if leaf in ("embed", "lm_head"):
        return 0.5 * rng.standard_normal(shape)
    if len(shape) - stacked >= 2:  # a matrix (or a stack of experts')
        return rng.standard_normal(shape) / math.sqrt(shape[-2])
    return 0.1 * rng.standard_normal(shape)


def family(name: str, seed: int = 0):
    """(cfg, tree of CPU tensors) of one family, random from ``seed``."""
    if name == "mamba":
        cfg = ssm.MambaConfig(vocab_size=96, d_model=64, n_layers=2,
                              d_state=8)
        tree = ssm.init_params(cfg, seed=seed).tree()
        rng = np.random.default_rng(seed + 5)
        tree["embed"] = (tree["embed"].float() * 60).to(torch.bfloat16)
        tree["lm_head"] = torch.from_numpy(rng.standard_normal(
            (cfg.d_model, cfg.vocab_size)).astype(np.float32))
        return cfg, tree
    entry = STRUCTURES[name]
    cfg = _config(entry)
    arch = getattr(cfg, "arch", entry["family"])
    rng = np.random.default_rng(seed)
    flat = {}
    widths = ssm._proj_widths(cfg) if entry["family"] == "mamba2" else {}
    for key, shape in entry["tensors"].items():
        if key.endswith(".packed"):
            proj = key.split(".")[-2]
            k, n = widths[proj]
            flat[key] = torch.stack([pack_ternary(
                rng.integers(-1, 2, (k, n)), 0.05, "i2").packed
                for _ in range(shape[0])])
        elif key.endswith(".scale"):
            flat[key] = torch.full(shape, 0.05)
        else:
            stacked = (key.startswith("layers.")
                       and entry["family"] != "hybrid")
            flat[key] = torch.from_numpy(_values(
                key, shape, arch, stacked, rng).astype(np.float32))
    tree: dict = {}
    for key, v in flat.items():
        *parts, last = key.split(".")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    if entry["family"] == "hybrid":
        tree["layers"] = [tree["layers"][str(i)]
                          for i in range(len(tree["layers"]))]
    return cfg, tree


def model_on(cfg, tree, device):
    from vlut_tpu_torch.convert.checkpoint import model_from_tree

    return model_from_tree(cfg, ssm._tree_to(tree, resolve_device(device)))


def carries_state(cfg) -> bool:
    return not isinstance(cfg, hybrid.HybridConfig)


@torch.inference_mode()
def logits_run(model, cfg, tokens: torch.Tensor, n_decode: int,
               feed: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
    """float32 logits (on the host) at the last position of a prefill of
    ``tokens`` (B, T) and of ``n_decode`` steps, each fed ``feed[i]`` (B,)
    where given, else the greedy token: one-token steps with the carried
    state (Mamba, Mamba2, RWKV), or the whole sequence again (hybrids, as
    their ``generate``)."""
    dev = model.device
    v = cfg.vocab_size
    seq = tokens.to(dev)
    if isinstance(cfg, hybrid.HybridConfig):
        out = [hybrid.forward(model, cfg, seq)[:, -1, :v].float().cpu()]
        for i in range(n_decode):
            nxt = feed[i] if feed is not None else out[-1].argmax(-1)
            seq = torch.cat([seq, nxt.to(dev)[:, None]], 1)
            out.append(hybrid.forward(model, cfg, seq)[:, -1, :v].float()
                       .cpu())
        return out
    if isinstance(cfg, (ssm.MambaConfig, ssm.Mamba2Config)):
        mamba2 = isinstance(cfg, ssm.Mamba2Config)
        fwd = ssm.forward2 if mamba2 else ssm.forward
        st = (ssm.init_state2 if mamba2 else ssm.init_state)(
            cfg, seq.shape[0], dev)

        def step(t):
            return fwd(model, cfg, t, st, logits_last_only=True,
                       inplace=True)[0]
    else:
        fwd = rwkv.forward6 if isinstance(cfg, rwkv.Rwkv6Config) else (
            rwkv.forward)
        holder = {"st": rwkv.init_state(cfg, seq.shape[0], dev)}

        def step(t):
            lg, holder["st"] = fwd(model, cfg, t, holder["st"])
            return lg[:, -1:]
    out = [step(seq)[:, -1, :v].float().cpu()]
    for i in range(n_decode):
        nxt = feed[i] if feed is not None else out[-1].argmax(-1)
        out.append(step(nxt.to(dev)[:, None])[:, -1, :v].float().cpu())
    return out


@contextlib.contextmanager
def layers_replaced(seen: list, by: list | None = None):
    """Within: each layer's output (``ssm.layer_output``, which every
    family's forward calls once per layer) is appended to ``seen``
    (float32, on the host) and, with ``by``, replaced by ``by[i]`` (the
    CPU's output of the same call): each layer on the card then starts
    from the CPU's input."""
    hook = ssm.layer_output

    def hooked(x):
        seen.append(x.float().cpu())
        return x if by is None else by[len(seen) - 1].to(x.device, x.dtype)

    ssm.layer_output = hooked
    try:
        yield
    finally:
        ssm.layer_output = hook


def _rel_errs(got: list, want: list) -> list[float]:
    return [float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            for g, w in zip(got, want)]


def card_vs_cpu(name: str, device, counters=None, n_decode: int = 6,
                prompt: int = 24, batch: int = 2, seed: int = 0,
                source=None) -> dict:
    """One family on ``device`` and on the CPU from the same tree: a prefill
    of ``batch`` x ``prompt`` tokens and ``n_decode`` steps fed the CPU's
    greedy tokens.  Each layer on ``device`` takes the CPU's input
    (:func:`layers_replaced`); its output must come within :data:`TOL` of
    the CPU's largest value, the logits (from the CPU's last hidden state)
    within :data:`LOGIT_TOL`, and the greedy tokens must be the CPU's.
    ``free_rel_logit_err`` reports the logits with the card's layers left
    to run on their own outputs (not gated).  ``counters`` (reset, read)
    bracket the card's free run, the family's main path: a Mamba or Mamba2
    family must launch the ternary kernels (#4, and #3 at a prefill past
    64 rows).  ``source`` (cfg, host tree) runs that model under the label
    ``name`` instead."""
    cfg, tree = source or family(name, seed)
    cpu, card = model_on(cfg, tree, "cpu"), model_on(cfg, tree, device)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                           (batch, prompt)))
    t0 = time.perf_counter()
    want_layers, got_layers = [], []
    with layers_replaced(want_layers):
        want = logits_run(cpu, cfg, tokens, n_decode)
    feed = [w.argmax(-1) for w in want[:-1]]
    with layers_replaced(got_layers, by=want_layers):
        got = logits_run(card, cfg, tokens, n_decode, feed=feed)
    if counters is not None:
        counters[0]()
    free = logits_run(card, cfg, tokens, n_decode, feed=feed)
    ternary = isinstance(cfg, (ssm.MambaConfig, ssm.Mamba2Config))
    launches = None
    if counters is not None:
        expect = (("ternary_gemm_fused_quant", "ternary_gemm_tiled")
                  if ternary and batch * prompt > 64 else
                  ("ternary_gemm_fused_quant",) if ternary else ())
        launches = counters[1](f"recurrent_{name}", expect)
    errs = _rel_errs(got, want)
    layer_errs = _rel_errs(got_layers, want_layers)
    greedy = all(torch.equal(g.argmax(-1), w.argmax(-1))
                 for g, w in zip(got, want))
    return {"family": name, "config": type(cfg).__name__,
            "max_rel_logit_err": max(errs),
            "max_rel_layer_err": max(layer_errs),
            "layers_compared": len(layer_errs),
            "greedy_equal": greedy,
            "free_rel_logit_err": max(_rel_errs(free, want)),
            "within_tol": (max(layer_errs) <= TOL
                           and max(errs) <= LOGIT_TOL),
            "tokens": [int(w.argmax(-1)[0]) for w in want],
            "launches": launches, "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m vlut_tpu_torch.bench.recurrent_zoo")
    ap.add_argument("--family", action="append", choices=list(FAMILIES))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    bad = []
    for name in args.family or FAMILIES:
        out = card_vs_cpu(name, args.device)
        print(json.dumps(out), flush=True)
        if not (out["within_tol"] and out["greedy_equal"]):
            bad.append(name)
    if bad:
        raise SystemExit(f"families out of tolerance or off the CPU's "
                         f"greedy tokens: {bad}")


if __name__ == "__main__":
    main()
