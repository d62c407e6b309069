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

A Mamba model (``MambaConfig``) is served through the same slots, each
holding its conv and ssm state (``models/ssm.py``) in place of KV rows,
as the JAX engine serves it: a group's prompts prefill left-padded with a
``valid`` mask, from a zero state, and their final states are written
into the slots; a prompt past the largest prefill bucket first feeds full
largest-bucket chunks (no pads), each continuing its slot's state, and
its remainder joins the groups, continuing too (a pad step leaves the
state as it is); the decode step runs the one-token recurrence over every
slot and writes each active slot's state in place (an idle slot's state
stays as it is); the step is one CUDA graph as for a transformer.  A
recurrent slot has no prefix reuse, no context shift and no capacity
limit but the request's own; a draft model or lookahead (both need to
rewind the state) are refused with the JAX package's messages.
``save_slot`` / ``restore_slot`` / ``fork_slot`` move a slot's whole
state.

``mesh=`` (``parallel/sharding.py:Mesh``, ("dp", "tp")) serves over
several devices with the JAX engine's checks and messages
(``vlut_tpu/runtime/engine.py:152-196``).  Every rank builds the engine
over its shard: a dense model's weights and KV heads split over tp (the
unfused tree, as the JAX engine serves under attention tp), a MoE model's
experts split over the same axis (attention replicated and fused), the
slots split over dp (each dp group holds n_slots / dp of them).  Rank 0
is the engine the caller drives: it owns the requests, the sampler and
all host state, and before each device operation (a prefill group, a
decode step, a context shift, a fork, a slot save or restore) it sends
the operation's host inputs to the other ranks over a gloo group; they
run the same forward
on their shards (:meth:`Engine.follow`) and hold no request state, so the
ranks cannot part.  Each dp group runs its own slots' rows and the rows'
logits are gathered over dp (a prefill group's rows sum over dp, zero
where a group holds no row).  Under NCCL the decode step is one CUDA
graph per program on every rank, its collectives captured with it (on
the card so far only as one rank, which issues no collective); under
gloo (the CPU, or two ranks sharing one card) it runs eagerly, since
gloo's collectives cannot be captured.  A slot save gathers every KV head
of the slot over tp, from the dp group that holds it, into the same file
one device writes; a restore writes each rank's block of the heads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.models import ssm
from vlut_tpu_torch.models.dims import make_plan
from vlut_tpu_torch.models.transformer import (
    DECODE_ATTN,
    StackedLayers,
    TransformerLM,
    forward,
    fuse_projections,
    init_kv_cache,
    quantize_head,
    shift_tables,
    unstack_layers,
)
from vlut_tpu_torch.parallel._comm import all_gather, broadcast, psum
from vlut_tpu_torch.parallel.spmd import make_engine_forward
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


@torch.inference_mode()
def follow(mesh) -> None:
    """A rank other than 0 of ``mesh``: run the device operations rank 0's
    engines send (each on this rank's engine of the same index) until rank
    0 closes one of them."""
    import torch.distributed as dist

    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0, group=mesh.control)
        tag, op, args = msg[0]
        if op == "stop":
            return
        mesh.engines[tag]._apply(op, args)


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
    """Single-device slot engine over a :class:`TransformerLM` (or a
    Mamba ``RecurrentLM``, ``models/ssm.py``), on the model's device; the
    model is served as the fused, unrolled tree (left unfused where a LoRA
    needs it) with a bf16 or int8 (``kv_quant``) cache, or with
    ``unroll=False`` as the stacked tree over a stacked cache (one (L, ...)
    tensor per entry, its layer views updated in place: the JAX engine's
    ``unroll=False``).  An MLA model's cache holds one
    latent row per position (``init_kv_cache``).  ``draft=(cfg, model[,
    (d2t, t2d)])`` speculates with a draft model (k_draft proposals per
    round), ``lookahead=(W, G)`` with the draft-free lookahead; the two
    exclude each other.  ``cuda_graph=False`` runs every step program
    eagerly on the card too."""

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
        unroll: bool = True,
    ):
        self.mesh = mesh
        fuse = True
        if mesh is not None:
            fuse = self._check_mesh(cfg, mesh, n_slots, draft, lookahead)
        if lookahead is not None and draft is not None:
            raise ValueError("lookahead and draft are mutually exclusive "
                             "decode modes")
        # recurrent family (Mamba): per-slot conv/ssm state in place of KV
        # rows, served through the same slots with left-padded prefill
        self._recurrent = isinstance(cfg, ssm.MambaConfig)
        if self._recurrent:
            if draft is not None:
                raise ValueError(
                    "speculative decoding needs state rewind; recurrent "
                    "models cannot rewind (reference has the same limit)")
            if lookahead is not None:
                raise ValueError("lookahead needs KV row rewind; "
                                 "recurrent models cannot rewind")
            context_shift = False  # recurrent context never shifts
        elif not cfg.causal_attn:
            # the JAX engine serves it and attends every cache row, those
            # not yet written and another request's among them (ROADMAP
            # Queue 3)
            raise ValueError(
                "a causal_attn=False model attends both ways and decodes "
                "from no cache: `generate` denoises it (runtime/diffusion.py)"
                " and the server serves it embedding-only (/embedding, "
                "/v1/embeddings)")
        if decode_attn not in DECODE_ATTN:
            raise ValueError(f"decode_attn must be one of {DECODE_ATTN}")
        self.cfg = cfg
        if self._recurrent:
            self.params = params
        else:
            if head_quant:
                params = quantize_head(params)
            self.params = fuse_projections(params, cfg) if fuse else params
            if mesh is not None:
                from vlut_tpu_torch.parallel.sharding import shard_params

                self.params = shard_params(self.params, mesh, cfg)
            if unroll:
                self.params = unstack_layers(self.params, cfg)
            elif not isinstance(self.params.layers, StackedLayers):
                raise ValueError("unroll=False serves a stacked tree (a "
                                 "uniform stack)")
        self.device = self.params.device
        self.n_slots = n_slots
        self.max_len = max_len or cfg.max_seq_len
        self.decode_attn = decode_attn
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= self.max_len) or (self.max_len,)
        # the logits' width (the whole padded vocabulary under a mesh)
        self.n_logits = self.params.n_logits * getattr(self.params,
                                                       "head_shards", 1)
        if self._recurrent:
            self.cache = ssm.init_state(cfg, n_slots, self.device)
        else:
            self._init_rows(kv_quant, unroll, cuda_graph)
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
        self.cuda_graph = cuda_graph and dev.type == "cuda" and (
            mesh is None or mesh.backend == "nccl")
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

    # --- the mesh ------------------------------------------------------------

    @staticmethod
    def _check_mesh(cfg, mesh, n_slots, draft, lookahead) -> bool:
        """The JAX engine's refusals under a mesh; returns whether the tree
        may fuse (not under attention tp: a [q|k|v] concat does not
        column-shard)."""
        tp_m, dp_m = mesh.shape["tp"], mesh.shape["dp"]
        if isinstance(cfg, ssm.MambaConfig):
            raise ValueError("mesh serving: recurrent models not "
                             "supported (per-slot state, no tp dim)")
        if draft is not None or lookahead is not None:
            raise ValueError("mesh serving: speculative/lookahead "
                             "decode modes are single-device for now")
        if n_slots % dp_m:
            raise ValueError(f"n_slots={n_slots} must divide by dp={dp_m}")
        if tp_m == 1:
            return True
        if getattr(cfg, "kv_lora_rank", 0):
            raise ValueError("mesh serving: MLA caches have one "
                             "latent head; tp>1 unsupported")
        if getattr(cfg, "n_experts", 0):
            if cfg.n_experts % tp_m:
                raise ValueError(
                    f"tp={tp_m} must divide n_experts={cfg.n_experts} (the "
                    f"mesh axis shards experts for MoE models)")
            return True
        if cfg.n_heads % tp_m or cfg.n_kv_heads % tp_m:
            raise ValueError(f"tp={tp_m} must divide n_heads={cfg.n_heads} "
                             f"and n_kv_heads={cfg.n_kv_heads}")
        if make_plan(cfg).tp_pack % tp_m:
            raise ValueError(f"checkpoint packed with tp_pack="
                             f"{make_plan(cfg).tp_pack}; tp={tp_m} must "
                             f"divide it")
        return False

    def _head_sharded(self) -> bool:
        return getattr(self.params, "head_shards", 1) > 1

    def _init_rows(self, kv_quant: bool, unroll: bool,
                   cuda_graph: bool) -> None:
        """This rank's slots ``_rows`` (every slot on one device, its dp
        group's on a mesh), their cache (its KV heads under tp) and
        forward; on a mesh, the engine's place among the mesh's engines."""
        mesh, cfg = self.mesh, self.cfg
        dp = mesh.shape["dp"] if mesh is not None else 1
        n_local = self.n_slots // dp
        lo = mesh.coords["dp"] * n_local if mesh is not None else 0
        self._rows = (lo, lo + n_local)
        self._dp = mesh.group("dp") if mesh is not None else None
        self.cache = init_kv_cache(
            cfg, n_local, self.max_len, device=self.device,
            quantized=kv_quant, layout="layers" if unroll else "stacked",
            tp=self.params.tp)
        self._fwd = make_engine_forward(cfg, mesh, decode_attn=self.decode_attn)
        if mesh is None:
            return
        # the engines on one mesh, in the order every rank builds them: a
        # message names its engine by its index here
        engines = mesh.__dict__.setdefault("engines", [])
        self._tag = len(engines)
        engines.append(self)
        self._follow_run = None
        if self.device.type == "cuda" and cuda_graph and mesh.backend != "nccl":
            print(f"[engine] mesh over {mesh.backend}: the decode step runs "
                  "eagerly (gloo's collectives cannot be captured in a CUDA "
                  "graph)", flush=True)

    def _send(self, op: str, *args) -> None:
        """Rank 0 of a mesh: the next device operation and (copies of) its
        host inputs, to every other rank (:func:`follow`)."""
        if self.mesh is None or self.mesh.size == 1 or self.mesh.rank != 0:
            return
        import torch.distributed as dist

        args = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        dist.broadcast_object_list([(self._tag, op, args)], src=0,
                                   group=self.mesh.control)

    def _apply(self, op: str, args) -> None:
        """A follower: run device operation ``op`` on this rank's shard."""
        if op == "step":
            if self._follow_run is None:
                self._follow_run = step_runner(
                    self._forward_step, self.device, self.cuda_graph,
                    self._pool)
            self._step_in.copy_(args[0])
            self._follow_run()
        elif op == "prefill":
            self._prefill_rows(*args)
        elif op == "shift":
            self._shift_rows(*args)
        elif op == "fork":
            self._fork_rows(*args)
        elif op == "hidden":
            self.hidden(*args)
        elif op == "save":
            self._slot_rows(*args)
        elif op == "restore":
            self._restore_rows(*args)
        else:
            raise RuntimeError(f"unknown engine operation {op!r}")

    def follow(self) -> None:
        """A rank other than 0: run what rank 0's engines on this mesh send
        until one of them closes (:func:`follow`)."""
        follow(self.mesh)

    def close(self) -> None:
        """Rank 0 of a mesh: release the other ranks from :func:`follow`."""
        self._send("stop")

    def _forward_step(self) -> torch.Tensor:
        """The decode step's forward over this rank's slots: the (n_slots,
        V) logits, gathered over dp."""
        tokens, lengths = self._step_in
        lo, hi = self._rows
        logits, _ = self._fwd(self.params, self.cache, tokens[lo:hi, None],
                              lengths[lo:hi, None])
        return all_gather(logits[:, 0], self._dp, 0)

    def _prefill_rows(self, toks, pos, slots, nv) -> torch.Tensor:
        """A prefill group: each dp group runs the rows of its own slots;
        the (m, V) last-token logits summed over dp (zero rows where a
        group holds none)."""
        dev = self.device
        lo, hi = self._rows
        mine = ((slots >= lo) & (slots < hi)).nonzero()[:, 0]
        every = len(mine) == len(slots)
        # this rank holds every row (always on one device): no scatter
        sel = slice(None) if every else mine
        out = None if every else torch.zeros((len(slots), self.n_logits),
                                             device=dev)
        if len(mine):
            logits, _ = self._fwd(
                self.params, self.cache, toks[sel].to(dev), pos[sel].to(dev),
                logits_at=torch.clamp(nv[sel] - 1, min=0).to(dev),
                slots=(slots[sel] - lo).to(dev))
            if every:
                out = logits[:, 0]
            else:
                out[mine.to(dev)] = logits[:, 0]
        return psum(out, self._dp)

    def _shift_rows(self, i: int, start: int, count: int) -> None:
        if self._rope_tables is None:
            self._rope_tables = shift_tables(self.cfg, self.device)
        lo, hi = self._rows
        if lo <= i < hi:
            kvc.seq_shift(self.cache, i - lo, start, count, self._rope_tables)

    def _fork_rows(self, src: int, dst: int, length: int) -> None:
        lo, hi = self._rows
        if lo <= src < hi and lo <= dst < hi:
            kvc.seq_cp(self.cache, src - lo, dst - lo, length)
            return
        # the slots lie in two dp groups: the source rows summed over dp
        # (zeros where a group does not hold them), written where dst lies
        for arrs in kvc.to_layered(self.cache).values():
            for a in arrs:
                rows = (a[src - lo, :length] if lo <= src < hi
                        else torch.zeros_like(a[0, :length]))
                rows = psum(rows, self._dp)
                if lo <= dst < hi:
                    a[dst - lo, :length] = rows

    @torch.inference_mode()
    def hidden(self, toks: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states (B, T, D) of a cacheless forward (the
        server's embeddings and rerank); on a mesh every rank runs it on
        its shard (rank 0 sends it) and each gets the whole states."""
        self._send("hidden", toks.cpu(), pos.cpu())
        return self._fwd(self.params, None, toks.to(self.device),
                         pos.to(self.device), output="hidden")[0]

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
        if self._recurrent:
            # the JAX engine's message; the chunk rounds of stage 1b leave
            # only remainders of at most the largest bucket, so a prompt
            # never reaches it
            raise ValueError(
                f"prompt length {t} exceeds max bucket "
                f"{self.prefill_buckets[-1]} (recurrent models cannot "
                f"chunk prefill)")
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
            if self._spec is not None or self._recurrent:
                # the draft cache holds no tracked prefix, and a recurrent
                # state is cumulative: the whole prompt is prefilled
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
        # batched forward (a recurrent chunk continues its slot's state)
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
        if self._recurrent:
            logits = self._prefill_recurrent(tb, rows)
            self.perf.n_prompt_tokens += sum(len(r[2]) for r in rows)
            self.perf.t_prompt_s += time.perf_counter() - t0
            return logits
        toks = torch.zeros((m, tb), dtype=torch.long)
        pos = torch.zeros((m, tb), dtype=torch.long)
        slots = torch.zeros((m,), dtype=torch.long)
        nv = torch.zeros((m,), dtype=torch.long)
        for r, (i, off, new) in enumerate(rows):
            toks[r, :len(new)] = torch.tensor(new, dtype=torch.long)
            pos[r] = off + torch.arange(tb)
            slots[r] = i
            nv[r] = len(new)
        self._send("prefill", toks, pos, slots, nv)
        logits = self._prefill_rows(toks, pos, slots, nv)
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

    def _prefill_recurrent(self, tb: int, rows) -> torch.Tensor:
        """The group's prompts left-padded to ``tb`` (pads first, so each row
        ends in its unpadded state), run with the ``valid`` mask from a zero
        state, or, for a row at a kv offset above 0 (a long prompt's later
        chunk, stage 1b of :meth:`_admit`), from its slot's state; the
        final states are written into the rows' slots.  A full chunk has no
        pads.  Returns the (m, V) last-token logits."""
        m, dev = len(rows), self.device
        toks = torch.zeros((m, tb), dtype=torch.long)
        valid = torch.zeros((m, tb), dtype=torch.bool)
        for r, (_, _, new) in enumerate(rows):
            toks[r, tb - len(new):] = torch.tensor(new, dtype=torch.long)
            valid[r, tb - len(new):] = True
        slots = torch.tensor([i for i, _, _ in rows], device=dev)
        state = ssm.init_state(self.cfg, m, dev)
        carry = [r for r, (_, off, _) in enumerate(rows) if off > 0]
        if carry:
            at = torch.tensor(carry, device=dev)
            for k, a in state.items():
                a[:, at] = self.cache[k][:, slots[at]]
        logits, new = ssm.forward(
            self.params, self.cfg, toks.to(dev), state,
            logits_last_only=True, valid=valid.to(dev))
        for k, a in self.cache.items():
            a[:, slots] = new[k]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return logits[:, 0]

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
                self._grammar_row(req, self.n_logits))[None].to(dev)
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
        self._send("shift", i, n_keep + n_discard, n_discard)
        self._shift_rows(i, n_keep + n_discard, n_discard)
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
        # a recurrent state has no capacity: the request's own limit ends it
        at_capacity = (not self._recurrent
                       and slot.length + slot.generated >= self.max_len - 1)
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
            shape = (self.n_slots, self.n_logits)
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
        if self._recurrent:
            # the active slots' rows carry their row (>= 0), the idle ones -1
            logits, _ = ssm.forward(self.params, self.cfg, tokens[:, None],
                                    self.cache, inplace=True,
                                    hold=lengths < 0)
            logits = logits[:, 0]
        else:
            logits = self._forward_step()
        logits = _mask_pad_vocab(logits.to(torch.float32),
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
            shapes = noise_shapes(self.n_slots, self.n_logits,
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
        # which is never part of a reusable prefix (a recurrent idle slot is
        # marked -1 and keeps its state)
        fed = self._fill_inputs(active, -1 if self._recurrent
                                else self.max_len - 1)
        k_probs = max(self.slots[i].req.n_probs for i in active)
        t0 = time.perf_counter()
        grammar = self._grammar_mask(active)
        self._send("step", self._host_in)
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
        """Serialize slot i's cached prefix (the JAX package's npz; a
        recurrent slot's whole state).  On a mesh the file is the same as
        on one device: every KV head, from the dp group that holds the
        slot."""
        hist = self.slots[i].history
        if self._recurrent:
            return state_mod.save_recurrent_state(self.cache, i, hist)
        if self.mesh is None:
            return state_mod.save_slot_state(self.cache, i, len(hist), hist)
        self._send("save", i, len(hist))
        return state_mod.save_slot_state(self._slot_rows(i, len(hist)), 0,
                                         len(hist), hist)

    def _slot_rows(self, i: int, length: int) -> dict:
        """Every rank of a mesh: rows [0, length) of slot i as a one-slot
        layered cache, each layer's KV heads gathered over tp in axis order
        (where the heads are split: not under a MoE model's ep) and sent
        from the dp group that holds the slot (bit for bit)."""
        lo, hi = self._rows
        n_local = hi - lo
        tp = self._head_group()
        out: dict[str, list] = {}
        for name, arrs in kvc.to_layered(self.cache).items():
            out[name] = []
            for a in arrs:
                rows = (a[i - lo, :length] if lo <= i < hi
                        else torch.zeros_like(a[0, :length])).contiguous()
                rows = all_gather(rows, tp, 1)
                rows = broadcast(rows, self._dp, i // n_local)
                out[name].append(rows[None])
        return out

    def restore_slot(self, i: int, data: bytes) -> None:
        """Write a serialized prefix into idle slot i, in place; the next
        request admitted there reuses it through the prefix cache.  On a
        mesh each rank of the dp group that holds the slot writes its tp
        block of the heads."""
        if self.slots[i].req is not None:
            raise RuntimeError(f"slot {i} is busy")
        if self._recurrent:
            hist = state_mod.load_recurrent_state(self.cache, i, data)
        elif self.mesh is None:
            hist = state_mod.load_slot_state(self.cache, i, data)
        else:
            # checked here first: a follower that failed would end the mesh
            state_mod.load_slot_state(self.cache, None, data,
                                      self._head_block())
            self._send("restore", i, data)
            hist = self._restore_rows(i, data)
        self.slots[i].history = hist
        self.slots[i].length = 0

    def _head_group(self):
        """The mesh axis this rank's KV heads are split over: tp, or none
        (a MoE model's axis carries experts)."""
        return self.mesh.group("tp") if self.params.tp > 1 else None

    def _head_block(self) -> tuple[int, int]:
        """This rank's block of the KV heads: (index, count)."""
        g = self._head_group()
        return (g.index, g.size) if g is not None else (0, 1)

    def _restore_rows(self, i: int, data: bytes) -> list[int]:
        lo, hi = self._rows
        return state_mod.load_slot_state(
            kvc.to_layered(self.cache), i - lo if lo <= i < hi else None,
            data, self._head_block())

    def fork_slot(self, src: int, dst: int) -> None:
        """Copy slot src's cached prefix to idle slot dst (seq_cp)."""
        if self.slots[dst].req is not None:
            raise RuntimeError(f"slot {dst} is busy")
        if self._recurrent:
            for a in self.cache.values():
                a[:, dst].copy_(a[:, src])
        else:
            n = len(self.slots[src].history)
            self._send("fork", src, dst, n)
            self._fork_rows(src, dst, n)
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
