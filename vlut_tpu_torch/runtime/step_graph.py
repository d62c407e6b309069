"""A decode step captured as one CUDA graph (the counterpart of the JAX
package's jitted step programs).

The JAX engine compiles its decode step, forward and sampler chain, once
per ``(features, k_probs)`` and calls the program with the cache donated
(``vlut_tpu/runtime/engine.py:452-504,1100-1112``); ``generate`` runs its
n steps as one jitted scan.  Here :func:`step_runner` wraps a step
function over static tensors; each call of the runner runs one step.  On
the card (:class:`StepGraph`) the first call runs the step eagerly, the
second captures it and replays it, and every later call replays it: the
host then launches one graph per step where it dispatched some 800
kernels one by one.  On the CPU, or with ``cuda_graph=False`` (the eager
A/B), every call runs the step eagerly (:class:`EagerStep`).

The rules a captured step keeps:

* the eager first call builds the kernels and allocates every workspace
  before the capture; a kernel wrapper that would have to allocate one
  inside the capture raises;
* its inputs are static tensors, written in place before each call, and
  its outputs are the tensors the capture returned, rewritten by each
  replay; a tensor reassigned instead of written in place is a stale
  pointer in the graph;
* nothing in it reads the device from the host (no ``.item()``,
  ``.tolist()``, ``.cpu()``, no draw from a per-row generator: the noise
  is drawn before each call into static tensors);
* a failed capture or replay raises: no path catches it and runs the step
  eagerly.

The kernel wrappers count their launches in Python (``ops.COUNTED``), so a
capture bumps the counters while it launches nothing; :class:`StepGraph`
takes those counts back after the capture and adds them again at every
replay, so a counter still counts launches.  A graph keeps the buffers the
wrappers held at its capture (``ops.held_buffers``) for as long as it
lives.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable

import torch

from vlut_tpu_torch import ops


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the two calls :class:`StepGraph`
    makes (a test stands a stub in for it on the CPU).  ``pool`` is a
    memory pool shared with other graphs (``torch.cuda.graph_pool_handle``)
    or None for a private one."""

    def __init__(self, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool

    def capture(self, fn: Callable[[], Any]) -> Any:
        # thread-local: the server's HTTP threads may run host work meanwhile
        with torch.cuda.graph(self.graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


class EagerStep:
    """``fn()`` run eagerly at every call (the CPU, or ``cuda_graph=False``
    on the card)."""

    captured = False

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def __call__(self) -> Any:
        return self.fn()

    def stats(self) -> dict:
        return {}


class StepGraph:
    """One step ``fn()`` over static tensors, returning its outputs
    (tensors, or a tuple or dict of them): eager at the first call,
    captured at the second, replayed from then on."""

    def __init__(self, fn: Callable[[], Any], graph=None):
        self.fn = fn
        self.graph = graph if graph is not None else CudaGraph()
        self.outputs: Any = None
        self.deltas: list[tuple[Any, int]] = []
        self.held: list = []
        self.capture_s = 0.0
        self.pool_bytes = 0  # device memory the capture added
        self.replays = 0
        self.warm = False
        self.captured = False

    def __call__(self) -> Any:
        if not self.warm:
            self.warm = True
            return self.fn()
        if not self.captured:
            self.capture()
        return self.replay()

    def capture(self) -> Any:
        t0 = time.perf_counter()
        before = {w: w.launches for w in ops.COUNTED}
        cuda = isinstance(self.graph, CudaGraph)
        if cuda:
            # the capture empties the cache first too: what it reserves
            # from here on is its pool's (collected first, so that no
            # unreachable engine's graph frees its pool meanwhile)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved() if cuda else 0
        try:
            outputs = self.graph.capture(self.fn)
        finally:
            # a wrapper first imported inside the capture counts from 0
            deltas = [(w, w.launches - before.get(w, 0)) for w in ops.COUNTED]
            for w, _ in deltas:
                w.launches = before.get(w, 0)
        if cuda:
            torch.cuda.synchronize()
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.perf_counter() - t0
        self.deltas = [(w, d) for w, d in deltas if d]
        self.held = ops.held_buffers()
        self.outputs = outputs
        self.captured = True
        return outputs

    def replay(self) -> Any:
        self.graph.replay()
        for w, d in self.deltas:
            w.launches += d
        self.replays += 1
        return self.outputs

    def stats(self) -> dict:
        if not self.captured:
            return {}
        return {"capture_ms": self.capture_s * 1e3,
                "pool_bytes": self.pool_bytes, "replays": self.replays,
                "launches_per_replay": {w.__name__: d
                                        for w, d in self.deltas}}


def step_runner(fn: Callable[[], Any], device: torch.device,
                cuda_graph: bool = True, pool=None):
    """The runner of step ``fn``: a :class:`StepGraph` on the card (its
    graph in ``pool``, see :class:`CudaGraph`), an :class:`EagerStep` on
    the CPU or with ``cuda_graph=False``."""
    if cuda_graph and torch.device(device).type == "cuda":
        return StepGraph(fn, CudaGraph(pool))
    return EagerStep(fn)
