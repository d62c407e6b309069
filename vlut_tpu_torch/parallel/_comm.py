"""The collectives of the sharded forward, on ``torch.distributed``.

Each helper is the counterpart of a JAX collective inside ``shard_map``:
:func:`psum` (``all_reduce`` SUM), :func:`pmax` (``all_reduce`` MAX),
:func:`all_gather` (``all_gather_into_tensor``) and :func:`ppermute`
(``batch_isend_irecv``).  They take a :class:`Group` (one mesh axis) and
return new tensors, as the JAX ones do; over no group, or a group of one
rank, they return their input (XLA drops a collective over a size-1
axis).  Every collective a helper issues is recorded for
``parallel/census.py`` under the HLO op name JAX's census counts it by,
with the bytes of its result.

Gradients (the sharded train step): where autograd records, :func:`psum`
is Megatron's "g" (sum forward, identity backward: after a row shard, wo
and w_down, and wherever every rank goes on to compute the same value)
and :func:`copy_to` Megatron's "f" (identity forward, sum backward:
before a column shard, whose replicated input gets a partial gradient
from each rank's columns).  :func:`pmax` gives no gradient (JAX wraps
its ``pmax`` in ``stop_gradient``).  Where nothing records (the
engine's inference mode), they are the plain collectives.

Gloo on CUDA tensors (two ranks sharing one card, where NCCL refuses a
second rank on the device): the ops in :data:`GLOO_HOST_STAGED` are
copied to the host, run there and copied back, in the gloo branch only;
the others run on the CUDA tensors directly.  NCCL runs everything on the
card, and its collectives can be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

# gloo ops that do not take CUDA tensors: point-to-point sends and
# receives (gloo hands the tensor's pointer to its TCP transport)
GLOO_HOST_STAGED = frozenset({"ppermute"})

# the census of the call being counted (parallel/census.py), or None
_RECORD: list[tuple[str, int]] | None = None


@dataclasses.dataclass(frozen=True)
class Group:
    """One mesh axis as this rank sees it: the process group, its global
    ranks in axis order, this rank's index and the backend."""

    pg: Any
    ranks: tuple[int, ...]
    index: int
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


def _active(g: Group | None) -> bool:
    return g is not None and g.size > 1


def _record(op: str, t: torch.Tensor) -> None:
    if _RECORD is not None:
        _RECORD.append((op, t.numel() * t.element_size()))


def _staged(g: Group, name: str, x: torch.Tensor) -> bool:
    return g.backend == "gloo" and x.is_cuda and name in GLOO_HOST_STAGED


def _all_reduce(x: torch.Tensor, g: Group, op) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=g.pg)
    _record("all-reduce", out)
    return out


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SumForward(torch.autograd.Function):
    """Sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _SumBackward(torch.autograd.Function):
    """Identity forward, sum over the group backward."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.g, dist.ReduceOp.SUM), None


def psum(x: torch.Tensor, g: Group | None) -> torch.Tensor:
    """Sum of x over the group (``jax.lax.psum``); its gradient is the
    identity."""
    if not _active(g):
        return x
    if _recorded(x):
        return _SumForward.apply(x, g)
    return _all_reduce(x, g, dist.ReduceOp.SUM)


def copy_to(x: torch.Tensor, g: Group | None) -> torch.Tensor:
    """x as it is, its gradient summed over the group: the replicated input
    of a column-sharded product."""
    if not _active(g) or not _recorded(x):
        return x
    return _SumBackward.apply(x, g)


def pmax(x: torch.Tensor, g: Group | None) -> torch.Tensor:
    """Elementwise max of x over the group (``jax.lax.pmax``), without a
    gradient."""
    if not _active(g):
        return x
    return _all_reduce(x.detach(), g, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, g: Group | None, dim: int) -> torch.Tensor:
    """The group's x concatenated along ``dim`` in axis order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    if not _active(g):
        return x
    out = torch.empty((g.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=g.pg)
    _record("all-gather", out)
    return torch.cat(out.chunk(g.size, 0), dim=dim)


def broadcast(x: torch.Tensor, g: Group | None, src: int) -> torch.Tensor:
    """The x of the group's rank at axis index ``src``, in every rank, bit
    for bit.  Not a census op: it serves a slot save, which the JAX
    package makes by copying the sharded cache to the host."""
    if not _active(g):
        return x
    out = x.contiguous().clone()
    dist.broadcast(out, src=g.ranks[src], group=g.pg)
    return out


def ppermute(xs: tuple[torch.Tensor, ...], g: Group | None,
             perm: list[tuple[int, int]]) -> tuple[torch.Tensor, ...]:
    """Each tensor of ``xs`` sent along ``perm`` ((source, destination)
    axis indices); a rank no pair sends to gets zeros
    (``jax.lax.ppermute``)."""
    if not _active(g):
        return xs
    me = g.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    staged = _staged(g, "ppermute", xs[0])
    outs, ops, work = [], [], []
    for x in xs:
        x_c = x.contiguous()
        out = torch.zeros_like(x_c)
        if staged:
            x_c, out_c = x_c.cpu(), torch.zeros(x_c.shape, dtype=x_c.dtype)
        else:
            out_c = out
        for d in dst:
            ops.append(dist.P2POp(dist.isend, x_c, g.ranks[d], g.pg))
        for s in src:
            ops.append(dist.P2POp(dist.irecv, out_c, g.ranks[s], g.pg))
        work.append((out, out_c))
        _record("collective-permute", out)
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    for out, out_c in work:
        if out_c is not out:
            out.copy_(out_c)
        outs.append(out)
    return tuple(outs)

