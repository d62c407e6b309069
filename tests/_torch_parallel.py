"""Rank-side cases of the port's parallel tests.

The tests (``test_torch_parallel*.py``, ``test_torch_distributed.py``,
``test_torch_train_sharded.py``, ``test_torch_slots_mesh.py``) run these
in gloo ranks started by ``vlut_tpu_torch.parallel.distributed.
launch``, one group per world size, each rank running every case of its
group in order (:func:`run_cases`).  The ranks import the port only; the
weights arrive as the port's tensor tree of the JAX package's
``init_params`` (carried by the test process), so both sides compute on
the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.models.transformer import (
    TransformerLM,
    forward,
    init_kv_cache,
)
from vlut_tpu_torch.parallel.census import comm_census
from vlut_tpu_torch.parallel.sharding import (
    Mesh,
    cache_specs,
    make_mesh,
    shard_params,
    shard_tree,
)


def run_cases(cases: list) -> list:
    """Every case ``(name, args)`` in order, in this rank: the results."""
    return [globals()[name](*args) for name, args in cases]


def _model(preset: str, tree) -> TransformerLM:
    return TransformerLM(PRESETS[preset], tree)


def tp_forward(preset, tree, dp, tp, tokens, pos, at, census=False):
    """make_forward_tp on a (dp, tp) mesh over a stacked cache of 32 rows:
    this rank's rows' logits, the local cache's shape and the census of the
    call."""
    from vlut_tpu_torch.parallel.spmd import make_forward_tp

    cfg = PRESETS[preset]
    mesh = make_mesh(dp=dp, tp=tp)
    local = shard_params(_model(preset, tree), mesh, cfg)
    b = tokens.shape[0]
    cache = init_kv_cache(cfg, b, 32, dtype=torch.float32, layout="stacked")
    cache = shard_tree(cache, cache_specs(), mesh)
    n = b // dp
    rows = slice(mesh.coords["dp"] * n, (mesh.coords["dp"] + 1) * n)
    args = (local, cache, torch.as_tensor(tokens[rows]),
            torch.as_tensor(pos[rows]), torch.as_tensor(at[rows]))
    fwd = make_forward_tp(cfg, mesh)
    logits, cache = fwd(*args)
    out = {"rows": (rows.start, rows.stop), "logits": logits.numpy(),
           "cache_k": tuple(cache["k"].shape), "coords": mesh.coords}
    if census:
        out["census"] = comm_census(fwd, *args)
    return out


def single_forward(preset, tree, tokens, pos, at):
    """The port's single-device forward of the same inputs."""
    cfg = PRESETS[preset]
    cache = init_kv_cache(cfg, tokens.shape[0], 32, dtype=torch.float32)
    logits, _ = forward(_model(preset, tree), cfg, torch.as_tensor(tokens),
                        torch.as_tensor(pos), cache,
                        logits_at=torch.as_tensor(at))
    return logits.numpy()


def sharded_matmul(m: int, k: int, n: int, seed: int):
    """ternary_matmul with K split over a tp axis of this world's ranks,
    at M <= 64 (the small-M kernels' range): (this rank's result, the
    unsharded route's result through the global scale and the tiled GEMM,
    the route #4 would give with this shard's own max, the calls of #4)."""
    from vlut_tpu_torch.ops import matmul as mm
    from vlut_tpu_torch.ops import ternary_gemm as tg
    from vlut_tpu_torch.ops.packing import TernaryTensor, pack_ternary
    from vlut_tpu_torch.ops.quant import quantize_activations

    mesh = Mesh({"tp": torch.distributed.get_world_size()},
                [torch.device("cpu")] * torch.distributed.get_world_size())
    g = mesh.group("tp")
    rng = np.random.default_rng(seed)
    trits = rng.integers(-1, 2, (k, n)).astype(np.int8)
    x = rng.standard_normal((m, k)).astype(np.float32)
    # the shards' row maxima differ: a local-max route gives other codes
    x[:, : k // g.size] *= 3.0
    full = pack_ternary(trits, 0.07, "i2", 128)
    kl = k // g.size
    lo = g.index * kl
    part = pack_ternary(trits[lo:lo + kl], 0.07, "i2", 128)
    t_local = TernaryTensor(part.packed, part.scale, kl, n, "i2", 128)
    xt = torch.from_numpy(x)
    calls = []
    real = tg.ternary_gemm_fused_quant

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    mm.ternary_gemm.ternary_gemm_fused_quant = spy
    try:
        got = mm.ternary_matmul(xt[:, lo:lo + kl], t_local, tp_group=g)
    finally:
        mm.ternary_gemm.ternary_gemm_fused_quant = real
    xq, xs = quantize_activations(xt)
    want = mm.ternary_matmul_quantized(xq, xs, full)
    # #4 on each shard with its own max, then the sum of the partials
    local = mm.ternary_matmul(xt[:, lo:lo + kl], t_local)
    local_sum = local.clone()
    torch.distributed.all_reduce(local_sum, group=g.pg)
    return {"got": got.numpy(), "want": want.numpy(),
            "local_max_route": local_sum.numpy(), "fused_quant_calls": calls}


def ep_forward(tree, tokens, pos):
    """make_forward_ep of tiny_moe on an ("ep",) mesh of this world."""
    from vlut_tpu_torch.parallel.spmd import make_forward_ep, shard_params_ep

    cfg = PRESETS["tiny_moe"]
    world = torch.distributed.get_world_size()
    mesh = Mesh({"ep": world}, [torch.device("cpu")] * world)
    local = shard_params_ep(_model("tiny_moe", tree), mesh, cfg)
    fwd = make_forward_ep(cfg, mesh)
    args = (local, torch.as_tensor(tokens), torch.as_tensor(pos))
    return {"logits": fwd(*args).numpy(),
            "experts": len(local.layers[0].experts["w_gate"]),
            "census": comm_census(fwd, *args)}


def sp_forward(tree, tokens, pos):
    """make_forward_sp of tiny on an ("sp",) mesh: this rank's T slice."""
    from vlut_tpu_torch.parallel.spmd import make_forward_sp

    cfg = PRESETS["tiny"]
    world = torch.distributed.get_world_size()
    mesh = Mesh({"sp": world}, [torch.device("cpu")] * world)
    t = tokens.shape[1] // world
    cols = slice(mesh.coords["sp"] * t, (mesh.coords["sp"] + 1) * t)
    fwd = make_forward_sp(cfg, mesh)
    args = (_model("tiny", tree), torch.as_tensor(tokens[:, cols]),
            torch.as_tensor(pos[:, cols]))
    return {"cols": (cols.start, cols.stop), "logits": fwd(*args).numpy(),
            "census": comm_census(fwd, *args)}


def pp_forward(tree, tokens, pos, n_microbatches=2):
    """make_forward_pp of tiny on a ("pp",) mesh (one layer per stage)."""
    from vlut_tpu_torch.parallel.pipeline import make_forward_pp, stage_params

    cfg = PRESETS["tiny"]
    world = torch.distributed.get_world_size()
    mesh = Mesh({"pp": world}, [torch.device("cpu")] * world)
    stage = stage_params(_model("tiny", tree), mesh, cfg)
    fwd = make_forward_pp(cfg, mesh, n_microbatches=n_microbatches)
    args = (stage, torch.as_tensor(tokens), torch.as_tensor(pos))
    return {"logits": fwd(*args).numpy(), "layers": len(stage.layers),
            "census": comm_census(fwd, *args)}


def multihost_forward(preset, tree, tokens, pos, at):
    """tests/test_distributed.py's worker: join the group the environment
    names (VLUT_COORDINATOR / VLUT_NPROCS / VLUT_PROC_ID), make the
    global ("dp", "tp") mesh and run the tp forward over it."""
    import os

    from vlut_tpu_torch.parallel.distributed import (
        global_mesh,
        init_multihost,
    )
    from vlut_tpu_torch.parallel.spmd import make_forward_tp

    init_multihost(backend="gloo")
    init_multihost(backend="gloo")  # idempotent
    cfg = PRESETS[preset]
    mesh = global_mesh(dp=2)
    local = shard_params(_model(preset, tree), mesh, cfg)
    b = tokens.shape[0]
    cache = shard_tree(init_kv_cache(cfg, b, 32, dtype=torch.float32,
                                     layout="stacked"), cache_specs(), mesh)
    n = b // mesh.shape["dp"]
    rows = slice(mesh.coords["dp"] * n, (mesh.coords["dp"] + 1) * n)
    logits, _ = make_forward_tp(cfg, mesh)(
        local, cache, torch.as_tensor(tokens[rows]),
        torch.as_tensor(pos[rows]), torch.as_tensor(at[rows]))
    return {"rank": torch.distributed.get_rank(),
            "env_rank": int(os.environ["VLUT_PROC_ID"]),
            "shape": dict(mesh.shape), "coords": mesh.coords,
            "rows": (rows.start, rows.stop), "logits": logits.numpy()}


TEXTS = [b"The little model", b"reads the lines", b"of its own repo.",
         b"The", b"little model reads the lines of its own repo.", b"re"]


def engine_tokens(dp: int, tp: int, kv_quant: bool = False):
    """tiny_real through Engine(mesh=) (4 slots, ctx 256, six greedy
    requests of 12 tokens): rank 0's outputs; the others follow."""
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.runtime.engine import Engine, Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    from pathlib import Path

    fixture = Path(__file__).parent / "fixtures" / "tiny_real"
    cfg, model, _ = load_checkpoint(fixture, device="cpu")
    mesh = make_mesh(dp=dp, tp=tp)
    eng = Engine(cfg, model, n_slots=4, max_len=256, mesh=mesh,
                 kv_quant=kv_quant)
    if mesh.rank != 0:
        eng.follow()
        return None
    reqs = [Request(prompt=[2] + list(t), max_new_tokens=12,
                    sampler=SamplerParams(temperature=0.0)) for t in TEXTS]
    eng.run(reqs)
    eng.close()
    return {"outputs": [r.output for r in reqs],
            "cache_k": tuple(eng.cache["k"][0].shape)}


def engine_refusals():
    """The JAX engine's mesh refusals: (kind, message) of each."""
    from vlut_tpu_torch.config import ModelConfig
    from vlut_tpu_torch.models import ssm
    from vlut_tpu_torch.models.transformer import init_params
    from vlut_tpu_torch.runtime.engine import Engine

    out = []

    def refused(fn):
        try:
            fn()
        except ValueError as e:
            out.append(str(e))
        else:
            out.append(None)

    mesh = make_mesh(dp=2, tp=2)
    cfg = PRESETS["tiny"]
    model = init_params(cfg, seed=0)
    refused(lambda: Engine(cfg, model, n_slots=3, max_len=64, mesh=mesh))
    refused(lambda: Engine(cfg, model, n_slots=4, max_len=64, mesh=mesh,
                           lookahead=(4, 3)))
    refused(lambda: Engine(cfg, model, n_slots=4, max_len=64, mesh=mesh,
                           draft=(cfg, model)))
    m_cfg = ssm.MambaConfig(vocab_size=96, d_model=64, n_layers=1,
                            d_state=8)
    refused(lambda: Engine(m_cfg, ssm.init_params(m_cfg, seed=0),
                           n_slots=4, mesh=mesh))
    mla = PRESETS["tiny_mla"]
    refused(lambda: Engine(mla, init_params(mla, seed=0), n_slots=4,
                           max_len=64, mesh=mesh))
    moe = ModelConfig(arch="llama", vocab_size=256, d_model=128, n_layers=2,
                      n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
                      n_experts=3, n_experts_used=2, tp_pack=1)
    refused(lambda: Engine(moe, init_params(moe, seed=0), n_slots=4,
                           max_len=64, mesh=mesh))
    heads = ModelConfig(arch="llama", vocab_size=256, d_model=128,
                        n_layers=1, n_heads=2, n_kv_heads=1, d_ff=128,
                        max_seq_len=128)
    refused(lambda: Engine(heads, init_params(heads, seed=0), n_slots=4,
                           max_len=64, mesh=mesh))
    pack = ModelConfig(arch="llama", vocab_size=256, d_model=128,
                       n_layers=1, n_heads=4, n_kv_heads=2, d_ff=128,
                       max_seq_len=128, tp_pack=1)
    refused(lambda: Engine(pack, init_params(pack, seed=0), n_slots=4,
                           max_len=64, mesh=mesh))
    return out


def fail_on(rank: int):
    """Raise in one rank while the others wait on it in a collective."""
    if torch.distributed.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
    return "passed the barrier"


def ring_cases(cases: list) -> dict:
    """The port's ``_ring_attention`` over an ("sp",) mesh of this world,
    each case ``(name, kwargs, q, k, v, pos)`` (whole arrays; this rank
    takes its T slice): {name: this rank's output}, and the slice."""
    from vlut_tpu_torch.models import transformer as tt

    world = torch.distributed.get_world_size()
    mesh = Mesh({"sp": world}, [torch.device("cpu")] * world)
    out, cols = {}, None
    for name, kw, q, k, v, pos in cases:
        n = q.shape[1] // world
        cols = slice(mesh.coords["sp"] * n, (mesh.coords["sp"] + 1) * n)
        kw = {a: torch.as_tensor(b) if isinstance(b, np.ndarray) else b
              for a, b in kw.items()}
        p = torch.as_tensor(pos[:, cols])
        out[name] = tt._ring_attention(
            torch.as_tensor(q[:, cols]), torch.as_tensor(k[:, cols]),
            torch.as_tensor(v[:, cols]), p, p, q.shape[-1],
            mesh.group("sp"), **kw).numpy()
    return {"cols": (cols.start, cols.stop), "out": out}


def train_step(cfg_fields, tree, dp, tp, tokens, mask, qat, lr):
    """``make_sharded_train_step`` on a (dp, tp) mesh of this world: one SGD
    (``lr``) step of the twin ``tree``; rank 0's loss and the gathered tree
    after it (numpy), the others' None."""
    from vlut_tpu_torch.config import ModelConfig
    from vlut_tpu_torch.parallel.sharding import gather_tree
    from vlut_tpu_torch.train import finetune as pf

    cfg = ModelConfig(**cfg_fields)
    mesh = make_mesh(dp=dp, tp=tp)
    make, pspecs = pf.make_sharded_train_step(
        cfg, mesh, tree, lambda ps: torch.optim.SGD(ps, lr=lr), qat=qat)
    local = pf.shard_dense(tree, pspecs, mesh)
    step = make(local)
    loss = float(step(torch.as_tensor(tokens), torch.as_tensor(mask)))
    whole = gather_tree(local, pspecs, mesh)
    if mesh.rank != 0:
        return None
    return {"loss": loss, "tree": _numpy_tree(whole)}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


SLOT_PROMPT = [2] + list(b"The little model reads")
SLOT_OTHER = [2] + list(b"of its own repo.")
SLOT_MORE = list(b" the")
# rank 0's saved slot files of this group, by mesh
_SAVED: dict[str, bytes] = {}


def _slot_engine(dp: int, tp: int):
    from pathlib import Path

    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.runtime.engine import Engine

    fixture = Path(__file__).parent / "fixtures" / "tiny_real"
    cfg, model, _ = load_checkpoint(fixture, device="cpu")
    return Engine(cfg, model, n_slots=2, max_len=256,
                  mesh=make_mesh(dp=dp, tp=tp))


def _slot_request(prompt):
    from vlut_tpu_torch.runtime.engine import Request
    from vlut_tpu_torch.runtime.sampling import SamplerParams

    return Request(prompt=prompt, max_new_tokens=6,
                   sampler=SamplerParams(temperature=0.0))


def _continue(eng, hist):
    """history + SLOT_MORE through ``eng``: (tokens, tokens reused)."""
    req = _slot_request(hist + SLOT_MORE)
    reused = eng.perf.n_reused_tokens
    eng.run([req])
    return req.output, eng.perf.n_reused_tokens - reused


def slot_save(dp: int, tp: int):
    """tiny_real through Engine(mesh=) (2 slots, ctx 256): SLOT_OTHER in
    slot 0, SLOT_PROMPT in slot 1 (6 greedy tokens each); rank 0 saves
    slot 1 (kept in ``_SAVED``) and continues it uninterrupted.  Every
    rank returns its local KV rows of slot 1 (None where its dp group does
    not hold it); rank 0 the file and the continuation."""
    eng = _slot_engine(dp, tp)
    out = {"coords": eng.mesh.coords, "local": None}
    if eng.mesh.rank == 0:
        eng.run([_slot_request(SLOT_OTHER), _slot_request(SLOT_PROMPT)])
        saved = eng.save_slot(1)
        _SAVED[f"dp{dp}tp{tp}"] = saved
        out.update(saved=saved,
                   cont=_continue(eng, list(eng.slots[1].history)))
        eng.close()
    else:
        eng.follow()
    lo, hi = eng._rows
    if lo <= 1 < hi:
        out["local"] = {k: [a[1 - lo, :32].float().numpy() for a in arrs]
                        for k, arrs in eng.cache.items()}
    return out


def slot_restore(dp: int, tp: int, files: dict):
    """A fresh Engine(mesh=) restores each file (name -> npz bytes, or None
    for one this group saved) into slot 1, saves the slot again (gathered
    from the ranks that wrote it) and continues its history + SLOT_MORE:
    rank 0's {name: (tokens, tokens reused, the file saved again)}."""
    eng = _slot_engine(dp, tp)
    if eng.mesh.rank != 0:
        eng.follow()
        return None
    out = {}
    for name, data in files.items():
        eng.restore_slot(1, data if data is not None else _SAVED[name])
        again = eng.save_slot(1)
        out[name] = (*_continue(eng, list(eng.slots[1].history)), again)
    eng.close()
    return out


def slot_moe():
    """A MoE model (4 experts) through Engine(mesh=) at tp 2, whose axis
    carries the experts and whose KV heads stay whole on each rank: slot 1
    saved, then restored into a fresh engine and saved again (rank 0's
    two files)."""
    from vlut_tpu_torch.config import ModelConfig
    from vlut_tpu_torch.models.transformer import init_params
    from vlut_tpu_torch.runtime.engine import Engine

    cfg = ModelConfig(arch="llama", vocab_size=256, d_model=128, n_layers=2,
                      n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
                      n_experts=4, n_experts_used=2, tp_pack=1)
    model = init_params(cfg, seed=0)
    mesh = make_mesh(dp=1, tp=2)
    files = []
    for restore in (False, True):
        eng = Engine(cfg, model, n_slots=2, max_len=64, mesh=mesh)
        if mesh.rank != 0:
            eng.follow()
            continue
        if restore:
            eng.restore_slot(1, files[0])
        else:
            eng.run([_slot_request(SLOT_OTHER[:8]),
                     _slot_request(SLOT_PROMPT[:8])])
        files.append(eng.save_slot(1))
        eng.close()
    return files or None


def mesh_train(kw: dict):
    """``bench/mesh.py:train_rank`` (``chip_smoke.py`` phase 30) at the
    sizes ``kw`` gives."""
    from vlut_tpu_torch.bench.mesh import train_rank

    return train_rank(**kw)


def sharded_ce(logits, targets, mask, vocab_size):
    """``sharded_ce_loss`` over a ("tp",) mesh of this world: each rank
    takes its block of the (B, T, Vp) logits; its loss and the gradient of
    its block."""
    from vlut_tpu_torch.train.finetune import sharded_ce_loss

    world = torch.distributed.get_world_size()
    mesh = Mesh({"tp": world}, [torch.device("cpu")] * world)
    g = mesh.group("tp")
    v_local = logits.shape[-1] // world
    local = torch.as_tensor(logits[..., g.index * v_local:
                                   (g.index + 1) * v_local].copy())
    local.requires_grad_(True)
    loss = sharded_ce_loss(local, torch.as_tensor(targets), g, v_local,
                           mask=torch.as_tensor(mask), vocab_size=vocab_size)
    loss.backward()
    return {"loss": float(loss), "grad": local.grad.numpy()}


def train_refusal(cfg_fields, tree):
    """make_sharded_train_step of a twin with a tied head at tp = this
    world: the message it raises."""
    from vlut_tpu_torch.config import ModelConfig
    from vlut_tpu_torch.train import finetune as pf

    mesh = make_mesh(dp=1, tp=torch.distributed.get_world_size())
    try:
        pf.make_sharded_train_step(ModelConfig(**cfg_fields), mesh, tree,
                                   lambda ps: torch.optim.SGD(ps, lr=0.1))
    except ValueError as e:
        return str(e)
    return None
