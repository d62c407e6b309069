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
  its ring attention before any int8 quantization);
* :func:`train_rank`: the sharded train step against the single-device
  step, its trained tree packed and served on one device and at tp, and
  a slot saved and restored under the mesh (``chip_smoke.py`` phase 30).

The logits comparisons report the largest absolute difference beside the
largest logit, the layer ones the largest difference over the largest
value; the caller holds them to its tolerances.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
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
# the limits phase 30 holds the sharded train step to (JAX's own sharded
# test's): the loss relatively, each leaf after one SGD step as
# numpy.allclose
TRAIN_LOSS_RTOL, TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-3, 2e-5
# and each leaf kind's SGD update (lr x its gradient) against the
# single-device step's, as ||u_tp - u_1|| / ||u_1||.  On an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md) the sound step reads at most 8.0e-5 a kind,
# and under FAULTS' copy_to_sum every kind but the head 0.64 to 0.99
TRAIN_UPDATE_RTOL = 1e-3
# the steps phase 30 takes: SGD at TRAIN_LR, TRAIN_QAT_STEPS QAT steps, the
# weights and the batch from TRAIN_SEED
TRAIN_LR, TRAIN_QAT_STEPS, TRAIN_SEED = 0.1, 3, 30
# phase 30's flagship case (chip_smoke.py): llama3_8b_158's widths over 8
# of its 32 layers (the float32 twin at full depth is about 32 GB of
# weights alone, and the check needs a single-device step beside two
# ranks'), one seeded batch of 4 x 256 tokens
FLAGSHIP_TRAIN = dict(preset="llama3_8b_158", n_layers=8, b=4, t=256,
                      n_slots=8, ctx=256, prompt_len=64, new_tokens=8,
                      device="cuda:0")
# wiring faults phase 29's and phase 30's limits must catch: (file, text,
# the text with the fault), and the case whose readings show it
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
    # a column shard's replicated input gets only this rank's share of its
    # gradient (copy_to's backward without its sum)
    "copy_to_sum": (
        "vlut_tpu_torch/parallel/_comm.py",
        "return _all_reduce(dy, ctx.g, dist.ReduceOp.SUM), None",
        "return dy, None",
        ("train_rank", FLAGSHIP_TRAIN)),
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
    _, eng, finish = _serve(cfg, model, mesh, dev, n_slots, ctx, prompt_len,
                            new_tokens, seed, single)
    eng.close()
    del eng
    return finish()


def _serve(cfg, model, mesh, dev, n_slots: int, ctx: int, prompt_len: int,
           new_tokens: int, seed: int, single: bool):
    """:func:`serve_rank` over a built model and mesh: (this rank's
    readings, the mesh engine, a function that completes the readings and
    returns them).  Rank 0's engine still serves, the others following it,
    until rank 0 closes it; the function's single-device readings run
    after that."""
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
        out = {"rank": mesh.rank, "launches": _counts()}
        return out, eng, lambda: out
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
    # the engine serves on without the readings' hooks
    del eng._first_token, eng._run_step
    return out, eng, lambda: _serve_reference(
        cfg, model, dev, n_slots, ctx, prompts, reqs, first, step,
        requests if single else None, out)


def _serve_reference(cfg, model, dev, n_slots, ctx, prompts, reqs, first,
                     step, requests, out) -> dict:
    """The single-device readings of :func:`_serve` into ``out``: the
    prefill and first decode step against :func:`_step_reference`, and with
    ``requests`` a single-device engine's ms per step and tokens."""
    # the single-device steps over the tree the mesh engine cut: unfused
    # under attention tp, fused for a MoE model (its axis carries experts)
    ref = fuse_projections(model, cfg) if cfg.n_experts else model
    nxt = torch.tensor([[r.output[0]] for r in reqs], device=dev)
    out.update(_step_reference(
        ref, cfg, prompts, nxt, ctx, dev,
        torch.stack([first[i] for i in range(n_slots)]), *step))
    del ref, step
    if requests is not None:
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


def _leaf_err(got: torch.Tensor, want: torch.Tensor, got_grad: torch.Tensor,
              want_grad: torch.Tensor) -> dict:
    """One leaf after the step against another, and their SGD updates (lr x
    the gradient): the largest difference, the largest of |got - want| /
    (atol + rtol |want|) (at most 1 where allclose), ||u_got - u_want|| /
    ||u_want||, and the largest of |u_want| / (atol + rtol |want|): below
    1, allclose alone could not tell the update from none."""
    d = (got.float() - want.float()).abs()
    bound = TRAIN_ATOL + TRAIN_RTOL * want.float().abs()
    u = TRAIN_LR * want_grad.float()
    diff = float(torch.linalg.vector_norm(TRAIN_LR * got_grad.float() - u))
    norm = float(torch.linalg.vector_norm(u))
    return {"max_abs_err": float(d.max()),
            "allclose_ratio": float((d / bound).max()),
            "update_rel_err": diff / norm if norm else (
                math.inf if diff else 0.0),
            "update_over_bound": float((u.abs() / bound).max())}


def _flat(tree, key: str = "") -> list:
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat(v, f"{key}.{k}")]
    return [(key[1:], tree)]


def _at(tree, key: str):
    for k in key.split("."):
        tree = tree[k]
    return tree


def _timed(fn, dev) -> tuple:
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def _peak_gb(dev) -> float | None:
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def train_rank(preset: str, n_layers: int | None, b: int, t: int,
               n_slots: int, ctx: int, prompt_len: int, new_tokens: int,
               device: str) -> dict:
    """The sharded train step in every rank of a ("dp" 1, "tp" world) mesh
    on ``device``, then its trained tree served (``chip_smoke.py`` phase
    30; the CPU at tiny sizes in ``tests/test_torch_train_sharded.py``).

    (a) The float32 twin of ``preset`` (random packed weights from
    ``TRAIN_SEED``, the embedding and head made float32): rank 0 takes one
    SGD step of the whole tree on one device (``make_train_step``), then
    every rank one SGD step of its shard (``make_sharded_train_step``); each
    leaf and its gradient gathered back one at a time and held, on rank 0,
    to the single-device step's (:func:`_leaf_err`, the largest of each
    reading per leaf kind). (b) ``TRAIN_QAT_STEPS`` QAT steps of the shards
    (the same optimizer settings), the tree gathered in every rank and
    packed (``pack_params``, embedding and head back to bf16, the head int8
    as served); rank 0 serves it on one device, the CUDA-graphed step
    against the eager one (greedy tokens), then every rank at tp 2 through
    ``Engine(mesh=)`` (:func:`_serve`: the prefill and the first decode step
    layer by layer against one device). (c) On that engine slot 1 is saved
    and continued; a fresh mesh engine restores the file, saves it again
    (gathered from what each rank wrote) and continues alike; each rank
    returns its local rows of the slot, rank 0 also the file, and the file
    restored into a single-device engine read back."""
    from vlut_tpu_torch.parallel.sharding import gather_tree
    from vlut_tpu_torch.train import finetune as ft

    dev = torch.device(device)
    cfg = _cfg(preset, n_layers, ctx)
    world = torch.distributed.get_world_size()
    mesh = make_mesh(dp=1, tp=world, devices=[dev] * world)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    twin = ft.float_twin_params(init_params_fast(cfg, seed=TRAIN_SEED,
                                                 device=dev), cfg)
    tree = ft._map(twin.tree(), lambda v: v.to(torch.float32)
                   if v.is_floating_point() else v)
    del twin

    def sgd(ps):
        return torch.optim.SGD(ps, lr=TRAIN_LR)

    make, pspecs = ft.make_sharded_train_step(cfg, mesh, tree, sgd)
    local = ft.shard_dense(tree, pspecs, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    toks = torch.randint(3, cfg.vocab_size, (b, t), generator=gen,
                         device=dev)
    mask = torch.ones_like(toks, dtype=torch.bool)
    out: dict = {"rank": mesh.rank, "mesh": dict(mesh.shape),
                 "backend": mesh.backend, "layers": cfg.n_layers,
                 "batch": [b, t],
                 "master_params": sum(v.numel() for _, v in _flat(tree))}

    # (a) one SGD step on one device (rank 0), then at tp
    if mesh.rank == 0:
        ref = ft._map(tree, lambda v: v.requires_grad_(True)
                      if v.is_floating_point() else v)
        opt1 = sgd(ft.leaves(ref))
        loss1, out["single_step_ms"] = _timed(
            lambda: ft.make_train_step(cfg, opt1)(ref, toks, mask), dev)
        out["single_loss"] = float(loss1)
        del opt1
    del tree
    out["single_peak_gb"] = _peak_gb(dev)
    torch.distributed.barrier()
    step = make(local)
    loss, out["tp_step_ms"] = _timed(lambda: step(toks, mask), dev)
    out["tp_loss"] = float(loss)
    errs: dict = {}
    for key, leaf in _flat(local):
        whole = gather_tree(leaf, _at(pspecs, key), mesh)
        grad = gather_tree(leaf.grad, _at(pspecs, key), mesh)
        if mesh.rank == 0:
            kind = key.split(".")[-2] if key.endswith(".dense") else (
                key.split(".")[-1])
            want = _at(ref, key)
            e = _leaf_err(whole, want.detach(), grad, want.grad)
            want.grad = None
            prev = errs.get(kind)
            errs[kind] = e if prev is None else {
                k: max(prev[k], e[k]) for k in e}
        del whole, grad
    if mesh.rank == 0:
        del ref
        out["leaf_errors"] = errs
        out["loss_rel_err"] = abs(out["tp_loss"] - out["single_loss"]) / abs(
            out["single_loss"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) QAT steps at tp, the tree gathered and packed, then served
    qstep = ft.make_sharded_train_step(cfg, mesh, local, sgd, qat=True)[0](
        local)
    out["qat_losses"], out["qat_step_ms"] = [], []
    for _ in range(TRAIN_QAT_STEPS):
        loss, ms = _timed(lambda: qstep(toks, mask), dev)
        out["qat_losses"].append(float(loss))
        out["qat_step_ms"].append(ms)
    out["qat_step_ms_median_after_first"] = float(np.median(
        out["qat_step_ms"][1:]))
    del qstep
    whole = gather_tree(local, pspecs, mesh)
    del local
    packed, out["pack_ms"] = _timed(lambda: ft.pack_params(whole, cfg), dev)
    del whole
    packed = {k: (v.to(torch.bfloat16) if k in ("embed", "lm_head") else v)
              for k, v in packed.items()}
    model = quantize_head(tt.TransformerLM(cfg, packed))
    del packed
    out["train_peak_gb"] = _peak_gb(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    if mesh.rank == 0:
        # on one device: the graphed step against the eager one
        rng = np.random.default_rng(TRAIN_SEED + 2)
        prompts = [[int(v) for v in rng.integers(3, cfg.vocab_size,
                                                 prompt_len)]
                   for _ in range(n_slots)]
        toks_by = {}
        for graphed in (True, False):
            reqs = [Request(prompt=list(p), max_new_tokens=new_tokens,
                            sampler=SamplerParams(temperature=0.0))
                    for p in prompts]
            _reset()
            Engine(cfg, model, n_slots=n_slots, max_len=ctx,
                   cuda_graph=graphed).run(reqs)
            _sync(dev)
            name = "graphed" if graphed else "eager"
            out[f"single_{name}_launches"] = _counts()
            toks_by[name] = [r.output for r in reqs]
        out["single_graphed_equals_eager"] = (toks_by["graphed"]
                                              == toks_by["eager"])
    torch.distributed.barrier()

    # at tp through Engine(mesh=), then (c) slot 1 saved and continued
    _, eng, finish = _serve(cfg, model, mesh, dev, n_slots, ctx, prompt_len,
                            new_tokens, TRAIN_SEED, single=False)
    more = [5, 6, 7]
    if mesh.rank == 0:
        saved = eng.save_slot(1)
        hist = list(eng.slots[1].history)
        cont = Request(prompt=hist + more, max_new_tokens=new_tokens,
                       sampler=SamplerParams(temperature=0.0))
        eng.run([cont])
        out.update(saved=saved, saved_len=len(hist), cont=cont.output)
    eng.close()
    out["serve"] = finish()
    out["slot_rows"] = {k: [a[1, :prompt_len + new_tokens].float().cpu()
                            .numpy() for a in arrs]
                        for k, arrs in eng.cache.items()}
    del eng
    eng = Engine(cfg, model, n_slots=n_slots, max_len=ctx, mesh=mesh)
    if mesh.rank == 0:
        eng.restore_slot(1, saved)
        out["restored_reads_back_equal"] = _same_arrays(eng.save_slot(1),
                                                        saved)
        again = Request(prompt=hist + more, max_new_tokens=new_tokens,
                        sampler=SamplerParams(temperature=0.0))
        reused = eng.perf.n_reused_tokens
        eng.run([again])
        eng.close()
        out["restored_cont"] = again.output
        out["restored_reused"] = eng.perf.n_reused_tokens - reused
        one = Engine(cfg, model, n_slots=n_slots, max_len=ctx)
        one.restore_slot(1, saved)
        back = one.save_slot(1)
        out["single_reads_back_equal"] = _same_arrays(back, saved)
        del one
    else:
        eng.follow()
    del eng, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _same_arrays(a: bytes, b: bytes) -> bool:
    """Two slot files hold the same arrays, bit for bit."""
    import io

    with np.load(io.BytesIO(a)) as za, np.load(io.BytesIO(b)) as zb:
        return set(za.files) == set(zb.files) and all(
            za[k].tobytes() == zb[k].tobytes() for k in za.files)


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
        description="phase 29's and 30's readings under wiring faults: "
                    "each fault of FAULTS put into a copy of the checkout, "
                    "its case "
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
                                       "step_programs", "serve", "saved",
                                       "slot_rows")}))
        return
    for name in args.fault or sorted(FAULTS):
        print(json.dumps({"fault": name, **fault_readings(name)}),
              flush=True)


if __name__ == "__main__":
    main()
