"""The port's ops: kernel wrappers with their plain PyTorch versions.

Every wrapper that launches a kernel is registered with :func:`counted`:
its ``launches`` attribute counts the launches it made, and
:data:`COUNTED` lists it, so that a captured CUDA graph
(``runtime/step_graph.py``) can add its capture's counts at each replay.
A wrapper that keeps device buffers between calls (a workspace) names them
through :func:`holds_buffers`: a graph captured with them keeps them alive.
"""

from __future__ import annotations

from typing import Callable

COUNTED: list[Callable] = []
_BUFFERS: list[Callable[[], list]] = []


def counted(fn: Callable) -> Callable:
    """Registers kernel wrapper ``fn`` and sets its ``launches`` to 0."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def holds_buffers(fn: Callable[[], list]) -> Callable[[], list]:
    """Registers ``fn() -> [tensor, ...]``, the buffers a kernel may use
    across calls."""
    _BUFFERS.append(fn)
    return fn


def held_buffers() -> list:
    """Every registered wrapper's buffers, as they are now."""
    return [t for fn in _BUFFERS for t in fn()]
