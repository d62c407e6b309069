"""Multi-rank serving checks: each function runs in every rank of a group
started by ``parallel/distributed.py:launch`` (``chip_smoke.py`` phase 29
on one card, two gloo ranks sharing it; the same functions run on the CPU
at small sizes, ``tests/test_torch_parallel_bench.py``).

* :func:`serve_rank`: a preset through ``Engine(mesh=)`` (random weights
  from a seed, greedy requests of one prompt length): rank 0's tokens;
  its prefill and first decode step against the same steps on one device
  over the same tree and cache type (:func:`_step_reference`: the step
  layer by layer from the mesh's inputs); the census of one decode step;
  the ms per decode step past the first :data:`WARM_STEPS` beside a
  single-device engine's; each rank's kernel launches while the mesh
  engine ran;
* :func:`tiny_real_rank`: tiny_real's greedy tokens through
  ``Engine(mesh=)`` (the texts of ``chip_smoke.py`` phase 6);
* :func:`sp_rank` / :func:`pp_rank`: ``make_forward_sp`` /
  ``make_forward_pp`` at a preset's widths over a few layers, each rank's
  logits against the single-device forward (sp's also layer by layer,
  its ring attention before any int8 quantization).

The logits comparisons report the largest absolute difference beside the
largest logit, the layer ones the largest difference over the largest
value; the caller holds them to its tolerances.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vlut_tpu_torch import ops
from vlut_tpu_torch.bench import zoo
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.models.transformer import (
    forward,
    fuse_projections,
    init_kv_cache,
    init_params_fast,
    quantize_head,
)
from vlut_tpu_torch.parallel.census import comm_census
from vlut_tpu_torch.parallel.sharding import Mesh, make_mesh
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams

ROOT = pathlib.Path(__file__).resolve().parents[2]
# the limits phase 29 holds the readings to, each of the largest value.
# On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md) the sound cases
# read: logits 0.0, a layer 1.3e-3 (the decode step) and 2.1e-2 (sp's
# 512 rows, where one flipped int8 code moves a layer's largest
# difference), the ring's attention 7.9e-7; under FAULTS a layer 0.29
# and 1.15, the attention 1.43.
PREFILL_TOL = 1e-3  # logits: the K-sharded sums are exact
LAYER_TOL = 5e-2  # a layer's output from the reference's input to it
ATTN_TOL = 1e-5  # ring attention before any int8 quantization
# phase 29's flagship cases (chip_smoke.py), also run under each fault
FLAGSHIP_TP2 = dict(preset="llama3_8b_158", n_layers=None, dp=1, tp=2,
                    n_slots=32, ctx=256, prompt_len=128, new_tokens=10,
                    device="cuda:0")
FLAGSHIP_SP2 = dict(preset="llama3_8b_158", n_layers=2, b=2, t=512,
                    device="cuda:0")
# wiring faults phase 29's limits must catch: (file, text, the text with
# the fault), and the case whose readings show it
FAULTS = {
    # the K-sharded route quantizes with the shard's own max
    "shard_max_scale": (
        "vlut_tpu_torch/ops/matmul.py", "quantize_activations(x2d, tp_group)",
        "quantize_activations(x2d)",
        ("serve_rank", {**FLAGSHIP_TP2, "new_tokens": 2, "single": False})),
    # the ring's blocks travel without their positions
    "ring_positions_kept": (
        "vlut_tpu_torch/models/transformer.py",
        "kb, vb, kpb = ppermute((kb, vb, kpb), sp, perm)",
        "kb, vb, _ = ppermute((kb, vb, kpb), sp, perm)",
        ("sp_rank", FLAGSHIP_SP2)),
}
TEXTS = [b"The little model", b"reads the lines", b"of its own repo.",
         b"The", b"little model reads the lines of its own repo.", b"re"]


def _counts() -> dict[str, int]:
    return {f.__name__: f.launches for f in ops.COUNTED}


def _reset() -> None:
    for f in ops.COUNTED:
        f.launches = 0


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _cfg(preset: str, n_layers: int | None, ctx: int | None = None):
    cfg = PRESETS[preset]
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if ctx and ctx > cfg.max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=ctx)
    return cfg


def _err(got: torch.Tensor, want: torch.Tensor, vocab: int) -> dict:
    """The difference over the vocabulary (the pad columns cut)."""
    got, want = got[..., :vocab], want[..., :vocab]
    d = (got.to(torch.float32) - want.to(torch.float32)).abs()
    return {"max_abs_err": float(d.max()),
            "max_abs_logit": float(want.abs().max()),
            "argmax_equal": float((got.argmax(-1) == want.argmax(-1))
                                  .to(torch.float32).mean())}


# the steps a per-step time leaves out: a single-device engine's first
# step runs eagerly and its second captures the graph
WARM_STEPS = 2


def _steps_timed(eng, dev, times: list, first: list | None = None) -> None:
    """Wrap ``eng``'s decode step: each step's wall time (the device
    synchronized on both sides) into ``times``; with ``first``, the first
    step's output layers (``zoo.layers_replaced``) and logits into it."""
    run_step = eng._run_step

    def timed(prog):
        _sync(dev)
        t0 = time.perf_counter()
        if first is not None and not first:
            layers = []
            with zoo.layers_replaced(layers):
                out = run_step(prog)
            first.extend([layers, out[1].clone()])
        else:
            out = run_step(prog)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        return out

    eng._run_step = timed


def _ms_per_step(times: list) -> float:
    """Mean ms of the steps past :data:`WARM_STEPS`."""
    return 1e3 * sum(times[WARM_STEPS:]) / max(len(times) - WARM_STEPS, 1)


def _rel(got: list, want: list) -> float:
    """The largest difference of paired tensors, each over its own
    largest absolute value."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in zip(got, want))


def _step_reference(ref, cfg, prompts, nxt, ctx, dev, first_logits,
                    step_layers, step_logits) -> dict:
    """The mesh engine's prefill and first decode step against the same
    steps on one device over ``ref`` (the tree the mesh cut) and a
    single-device cache of the engine's type: the prefill logits; each
    layer of the step run from the mesh's input to it
    (``zoo.layers_replaced``), so no rounding carries from one layer into
    the next; the step's logits from the mesh's last layer (``step_logits``)
    and free-running from the single-device layers (``free_step_logits``,
    reported: a random model amplifies one flipped int8 code)."""
    n, t = len(prompts), len(prompts[0])
    toks = torch.tensor(prompts, device=dev)
    pos = torch.arange(t, device=dev)[None].expand(n, -1)
    cache = init_kv_cache(cfg, n, ctx, device=dev)
    step_pos = torch.full((n, 1), t, device=dev)
    layers = []
    with torch.inference_mode():
        want, _ = forward(ref, cfg, toks, pos, cache,
                          logits_at=torch.full((n,), t - 1, device=dev),
                          slots=torch.arange(n, device=dev))
        free, _ = forward(ref, cfg, nxt, step_pos, cache)
        with zoo.layers_replaced(layers, by=step_layers):
            held, _ = forward(ref, cfg, nxt, step_pos, cache)
    v = cfg.vocab_size
    return {"prefill_logits": _err(first_logits, want[:, 0], v),
            "step_layer_rel_err": _rel(step_layers, layers),
            "step_logits": _err(step_logits, held[:, 0], v),
            "free_step_logits": _err(step_logits, free[:, 0], v)}


def serve_rank(preset: str, n_layers: int | None, dp: int, tp: int,
               n_slots: int, ctx: int, prompt_len: int, new_tokens: int,
               device: str, seed: int = 0, single: bool = True) -> dict:
    """``preset`` served over a (dp, tp) mesh whose ranks all sit on
    ``device``; see the module docstring."""
    dev = torch.device(device)
    cfg = _cfg(preset, n_layers, ctx)
    model = quantize_head(init_params_fast(cfg, seed=seed, device=dev))
    mesh = make_mesh(dp=dp, tp=tp, devices=[dev] * (dp * tp))
    rng = np.random.default_rng(seed + 1)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, prompt_len)]
               for _ in range(n_slots)]

    def requests():
        return [Request(prompt=list(p), max_new_tokens=new_tokens,
                        sampler=SamplerParams(temperature=0.0))
                for p in prompts]

    eng = Engine(cfg, model, n_slots=n_slots, max_len=ctx, mesh=mesh)
    if mesh.rank != 0:
        _reset()
        eng.follow()
        _sync(dev)
        return {"rank": mesh.rank, "launches": _counts()}
    first, step, times = {}, [], []
    first_token = eng._first_token

    def keep_first(i, req, last_logits):
        first[i] = last_logits.clone()
        return first_token(i, req, last_logits)

    eng._first_token = keep_first
    _steps_timed(eng, dev, times, step)
    reqs = requests()
    _reset()
    _sync(dev)
    t0 = time.perf_counter()
    eng.run(reqs)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _counts()
    # the census of one more decode step, the other ranks running it too
    eng._send("step", eng._host_in)
    eng._step_in.copy_(eng._host_in)
    census = comm_census(eng._forward_step)
    out = {"rank": 0, "mesh": dict(mesh.shape), "backend": mesh.backend,
           "tokens": [r.output for r in reqs], "launches": launches,
           "census": census, "wall_s": wall,
           "decode_steps": eng.perf.n_decode_steps,
           "ms_per_step": _ms_per_step(times), "timed_steps": len(times)
           - WARM_STEPS, "graphed": eng.cuda_graph,
           "step_programs": eng.step_programs()}
    eng.close()
    del eng
    # the single-device steps over the tree the mesh engine cut: unfused
    # under attention tp, fused for a MoE model (its axis carries experts)
    ref = fuse_projections(model, cfg) if cfg.n_experts else model
    nxt = torch.tensor([[r.output[0]] for r in reqs], device=dev)
    out.update(_step_reference(
        ref, cfg, prompts, nxt, ctx, dev,
        torch.stack([first[i] for i in range(n_slots)]), *step))
    del ref, step
    if single:
        one = Engine(cfg, model, n_slots=n_slots, max_len=ctx)
        times1 = []
        _steps_timed(one, dev, times1)
        reqs1 = requests()
        one.run(reqs1)
        out["single_ms_per_step"] = _ms_per_step(times1)
        out["single_tokens_equal"] = sum(
            a.output == b.output for a, b in zip(reqs, reqs1)) / len(reqs)
        del one
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tiny_real_rank(dp: int, tp: int, device: str, kv_quant: bool = False,
                   decode_attn: str = "fused", single: bool = False) -> dict:
    """tiny_real through Engine(mesh=) on ``device`` (4 slots, ctx 256,
    greedy, 12 new tokens per text, the cache and decode attention asked):
    rank 0's tokens and launches; with ``single``, the single-device
    engine's tokens beside them."""
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint

    dev = torch.device(device)
    cfg, model, _ = load_checkpoint(ROOT / "tests" / "fixtures" / "tiny_real",
                                    device=dev)
    mesh = make_mesh(dp=dp, tp=tp, devices=[dev] * (dp * tp))

    def requests():
        return [Request(prompt=[2] + list(t), max_new_tokens=12,
                        sampler=SamplerParams(temperature=0.0))
                for t in TEXTS]

    eng = Engine(cfg, model, n_slots=4, max_len=256, mesh=mesh,
                 kv_quant=kv_quant, decode_attn=decode_attn)
    _reset()
    if mesh.rank != 0:
        eng.follow()
        _sync(dev)
        return {"rank": mesh.rank, "launches": _counts()}
    reqs = requests()
    eng.run(reqs)
    eng.close()
    _sync(dev)
    out = {"rank": 0, "mesh": dict(mesh.shape), "backend": mesh.backend,
           "tokens": [r.output for r in reqs], "launches": _counts(),
           "graphed": eng.cuda_graph, "step_programs": eng.step_programs()}
    if single:
        one = Engine(cfg, model, n_slots=4, max_len=256, kv_quant=kv_quant,
                     decode_attn=decode_attn)
        reqs1 = requests()
        one.run(reqs1)
        out["single_tokens"] = [r.output for r in reqs1]
    return out


def _inputs(cfg, b: int, t: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    toks = torch.tensor(rng.integers(3, cfg.vocab_size, (b, t)), device=dev)
    return toks, torch.arange(t, device=dev)[None].expand(b, -1)


@contextlib.contextmanager
def _outputs(name: str, seen: list):
    """Within: each output of ``models/transformer.py``'s function ``name``
    is appended to ``seen`` (float32, on the host), in call order."""
    f = getattr(tt, name)

    def g(*args, **kw):
        y = f(*args, **kw)
        seen.append(y.float().cpu())
        return y

    setattr(tt, name, g)
    try:
        yield
    finally:
        setattr(tt, name, f)


def sp_rank(preset: str, n_layers: int, b: int, t: int, device: str,
            seed: int = 0) -> dict:
    """make_forward_sp over an ("sp",) mesh of this group: this rank's T
    slice against the single-device forward's.  The logits free-running
    (reported); then each layer run from the single-device input to it
    (``zoo.layers_replaced``): its ring attention output against the dense
    attention's, before any int8 quantization (``attn_rel_err``), its
    output (``layer_rel_err``) and the logits from the last layer's
    single-device output (``held_logits``)."""
    from vlut_tpu_torch.parallel.spmd import make_forward_sp

    dev = torch.device(device)
    cfg = _cfg(preset, n_layers)
    model = init_params_fast(cfg, seed=seed, device=dev)
    world = torch.distributed.get_world_size()
    mesh = Mesh({"sp": world}, [dev] * world)
    toks, pos = _inputs(cfg, b, t, seed, dev)
    n = t // world
    cols = slice(mesh.coords["sp"] * n, (mesh.coords["sp"] + 1) * n)
    fwd = make_forward_sp(cfg, mesh)
    with torch.inference_mode():
        _reset()
        got = fwd(model, toks[:, cols], pos[:, cols])
        _sync(dev)
        launches = _counts()
        census = comm_census(fwd, model, toks[:, cols], pos[:, cols])
        want_layers, want_attn, layers, attn = [], [], [], []
        with zoo.layers_replaced(want_layers), _outputs("_attention",
                                                        want_attn):
            want, _ = forward(model, cfg, toks, pos, None)
        want_layers = [w[:, cols] for w in want_layers]
        with zoo.layers_replaced(layers, by=want_layers), _outputs(
                "_ring_attention", attn):
            held = fwd(model, toks[:, cols], pos[:, cols])
    v = cfg.vocab_size
    return {"rank": mesh.rank, "launches": launches, "census": census,
            **_err(got, want[:, cols], v),
            "attn_rel_err": _rel(attn, [w[:, cols] for w in want_attn]),
            "layer_rel_err": _rel(layers, want_layers),
            "held_logits": _err(held, want[:, cols], v)}


def pp_rank(preset: str, n_layers: int, b: int, t: int, device: str,
            seed: int = 0, n_microbatches: int = 2) -> dict:
    """make_forward_pp over a ("pp",) mesh of this group: the logits (every
    stage's) against the single-device forward's."""
    from vlut_tpu_torch.parallel.pipeline import make_forward_pp, stage_params

    dev = torch.device(device)
    cfg = _cfg(preset, n_layers)
    model = init_params_fast(cfg, seed=seed, device=dev)
    world = torch.distributed.get_world_size()
    mesh = Mesh({"pp": world}, [dev] * world)
    toks, pos = _inputs(cfg, b, t, seed, dev)
    stage = stage_params(model, mesh, cfg)
    fwd = make_forward_pp(cfg, mesh, n_microbatches=n_microbatches)
    with torch.inference_mode():
        _reset()
        got = fwd(stage, toks, pos)
        _sync(dev)
        launches = _counts()
        census = comm_census(fwd, stage, toks, pos)
        want, _ = forward(model, cfg, toks, pos, None)
    # the pipeline's head is the float one (bf16 lm_head or embed.T)
    return {"rank": mesh.rank, "launches": launches, "census": census,
            "stage_layers": len(stage.layers),
            **_err(got, want, cfg.vocab_size)}


def run_cases(cases: list) -> list:
    """Every case ``(name, kwargs)`` in order, in this rank."""
    out = []
    for name, kw in cases:
        out.append(globals()[name](**kw))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def fault_readings(name: str, timeout: float = 900.0) -> dict:
    """Rank 0's readings of the case of fault ``name`` (:data:`FAULTS`) in
    a copy of the package (and its built kernels) that holds the fault,
    two gloo ranks sharing the card."""
    path, text, broken, case = FAULTS[name]
    with tempfile.TemporaryDirectory(prefix="vlut_fault_") as tmp:
        copy = pathlib.Path(tmp) / "checkout"
        for part in ("vlut_tpu_torch", "build"):
            if (ROOT / part).is_dir():
                shutil.copytree(ROOT / part, copy / part,
                                ignore=shutil.ignore_patterns("__pycache__"))
        src = copy / path
        code = src.read_text()
        if code.count(text) != 1:
            raise RuntimeError(f"fault {name}: {text!r} not once in {path}")
        src.write_text(code.replace(text, broken))
        out = subprocess.run(
            [sys.executable, "-m", "vlut_tpu_torch.bench.mesh", "--case",
             json.dumps(case)], cwd=copy, capture_output=True, text=True,
            timeout=timeout)
    if out.returncode:
        raise RuntimeError(f"fault {name}: {out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="phase 29's readings under wiring faults: each fault "
                    "of FAULTS put into a copy of the checkout, its case "
                    "run there in two gloo ranks on one card; one JSON line "
                    "per fault")
    ap.add_argument("--fault", action="append", choices=sorted(FAULTS),
                    help="a fault to run (default: every one)")
    ap.add_argument("--case", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.case:
        from vlut_tpu_torch.parallel.distributed import launch

        name, kw = json.loads(args.case)
        res = launch("vlut_tpu_torch.bench.mesh:run_cases", ([(name, kw)],),
                     nprocs=2, backend="gloo", timeout=900)[0][0]
        print(json.dumps({k: v for k, v in res.items()
                          if k not in ("tokens", "launches",
                                       "step_programs")}))
        return
    for name in args.fault or sorted(FAULTS):
        print(json.dumps({"fault": name, **fault_readings(name)}),
              flush=True)


if __name__ == "__main__":
    main()
