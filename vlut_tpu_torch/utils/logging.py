"""Leveled logging and profiling hooks (port of ``vlut_tpu/utils/logging.py``).

A thin layer over stdlib logging: :func:`get_logger` returns a logger of
the port, the ``vlut_tpu_torch`` root configured once from the environment
(``VLUT_LOG_LEVEL=debug|info|warn|error``, ``VLUT_LOG_FILE=path``), as the
JAX package configures its own.  :func:`trace` wraps ``torch.profiler``
for an on-demand trace of the host and, where there is one, the card;
:func:`timed` logs a host-side phase's milliseconds.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time

ROOT = "vlut_tpu_torch"

_configured = False

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger ``name``; the first call gives the ``vlut_tpu_torch``
    root its level, a stderr handler (and a file handler under
    ``VLUT_LOG_FILE``) and stops it propagating to the root logger."""
    global _configured
    log = logging.getLogger(name)
    if not _configured:
        level = _LEVELS.get(
            os.environ.get("VLUT_LOG_LEVEL", "info").lower(), logging.INFO
        )
        root = logging.getLogger(ROOT)
        root.setLevel(level)
        fmt = logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        )
        h: logging.Handler = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        root.addHandler(h)
        path = os.environ.get("VLUT_LOG_FILE")
        if path:
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            root.addHandler(fh)
        root.propagate = False
        _configured = True
    return log


@contextlib.contextmanager
def trace(out_dir: str | None):
    """A ``torch.profiler`` scope (the host, and the card where there is
    one) that writes a Chrome trace (``*.pt.trace.json``) into ``out_dir``;
    a no-op when ``out_dir`` is falsy.  Open it in Perfetto or
    ``chrome://tracing``."""
    if not out_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(out_dir)))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        get_logger().info("profiler trace written to %s", out_dir)


@contextlib.contextmanager
def timed(label: str, log: logging.Logger | None = None):
    """Host-side phase timer (the reference prints per-phase perf lines)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        (log or get_logger()).info(
            "%s: %.1f ms", label, (time.perf_counter() - t0) * 1e3
        )
