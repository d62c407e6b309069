"""Starting the ranks: one host's processes, or a group across hosts (port
of vlut_tpu/parallel/distributed.py).

The JAX package runs one process per host over all of its devices; here
each device is a process of the default ``torch.distributed`` group, and
the backend is the caller's choice (``"nccl"`` on GPUs, ``"gloo"`` on the
CPU), never a fallback.

* One host: :func:`launch` runs every rank of a function as a child
  process and returns their results; :func:`start_ranks` makes the caller
  rank 0 and starts the others (the CLI's ``generate --tp/--dp`` and
  ``serve --tp/--dp``).  The ranks meet through a ``file://`` rendezvous
  in a fresh directory, every rank pins ``torch.set_num_threads(1)``, and
  a rank that exits with an error (or outlives the timeout) ends the
  others and fails the run.
* Several hosts: :func:`init_multihost` joins the group the
  ``VLUT_COORDINATOR`` / ``VLUT_NPROCS`` / ``VLUT_PROC_ID`` environment
  names (or torchrun's), one process per device, and :func:`global_mesh`
  puts tp inside a host and dp across hosts.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

_ROOT = pathlib.Path(__file__).resolve().parents[2]
# how long a collective may wait for a peer before the group fails
GROUP_TIMEOUT_S = 600


def _init(backend: str, init_method: str, world: int, rank: int,
          timeout_s: float = GROUP_TIMEOUT_S) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str = "nccl") -> None:
    """Join the default process group (idempotent).  ``coordinator``
    (host:port of rank 0, or a rendezvous URL such as ``file://PATH``),
    ``num_processes`` and ``process_id`` default to
    ``VLUT_COORDINATOR`` / ``VLUT_NPROCS`` / ``VLUT_PROC_ID``; with neither,
    torchrun's environment (``env://``)."""
    if dist.is_initialized():
        return
    addr = coordinator or os.environ.get("VLUT_COORDINATOR")
    if not addr:
        dist.init_process_group(backend, init_method="env://")
        return
    _init(backend, addr if "://" in addr else f"tcp://{addr}",
          num_processes or int(os.environ.get("VLUT_NPROCS", "1")),
          process_id if process_id is not None
          else int(os.environ.get("VLUT_PROC_ID", "0")))


def local_count() -> int:
    """Processes on this host: torchrun's ``LOCAL_WORLD_SIZE``, else one per
    visible GPU under NCCL, else one."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if dist.get_backend() == "nccl":
        return torch.cuda.device_count()
    return 1


def global_mesh(dp: int | None = None, tp: int | None = None):
    """("dp", "tp") mesh over every rank, tp contiguous within a host's
    processes (ranks are numbered host by host), dp across hosts."""
    from vlut_tpu_torch.parallel.sharding import Mesh

    n = dist.get_world_size()
    local = local_count()
    if tp is None:
        tp = min(local, n)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != {n} devices")
    if dist.get_backend() == "nccl":
        devices = [torch.device("cuda", r % local) for r in range(n)]
    else:
        devices = [torch.device("cpu")] * n
    return Mesh({"dp": dp, "tp": tp}, devices)


def _target(spec: str) -> Callable:
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)


def _picklable(args: tuple) -> tuple:
    """The arguments with an argparse namespace's functions dropped (a
    CLI's ``set_defaults(fn=...)``, which a child cannot import from the
    parent's ``__main__``)."""
    return tuple(argparse.Namespace(**{k: v for k, v in vars(a).items()
                                       if not callable(v)})
                 if isinstance(a, argparse.Namespace) else a for a in args)


def _spawn(spec: dict, rank: int, folder: pathlib.Path, capture: bool):
    spec = {**spec, "args": _picklable(spec["args"])}
    path = folder / f"spec{rank}.pkl"
    path.write_bytes(pickle.dumps({**spec, "rank": rank}))
    env = dict(os.environ)
    # the checkout, then the parent's import path (a test's helpers)
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p] + [p for p in sys.path if os.path.isdir(p)]))
    out = open(folder / f"rank{rank}.log", "wb") if capture else None
    return subprocess.Popen(
        [sys.executable, "-m", "vlut_tpu_torch.parallel.distributed",
         str(path)], env=env, cwd=str(_ROOT), stdout=out,
        stderr=subprocess.STDOUT if capture else None)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def launch(target: str, args: tuple = (), nprocs: int = 2,
           backend: str = "gloo", timeout: float = 300.0,
           folder: str | os.PathLike | None = None) -> list[Any]:
    """Run ``target(*args)`` ("module:function") in ``nprocs`` child ranks
    of a new group and return each rank's result, in rank order.  A rank
    that fails, or a run past ``timeout`` seconds, kills every rank and
    raises with the ranks' output."""
    own = folder is None
    folder = pathlib.Path(folder or tempfile.mkdtemp(prefix="vlut_ranks_"))
    folder.mkdir(parents=True, exist_ok=True)
    spec = {"target": target, "args": args, "world": nprocs,
            "backend": backend, "init": f"file://{folder / 'rendezvous'}",
            "out": str(folder)}
    try:
        return _launch(target, spec, nprocs, timeout, folder)
    finally:
        if own:
            shutil.rmtree(folder, ignore_errors=True)


def _launch(target, spec, nprocs, timeout, folder) -> list[Any]:
    procs = [_spawn(spec, r, folder, capture=True) for r in range(nprocs)]
    t_end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > t_end:
                _kill(procs)
                logs = "\n".join(
                    f"--- rank {r} ---\n"
                    + (folder / f"rank{r}.log").read_text(errors="replace")
                    [-4000:] for r in range(nprocs))
                why = (f"rank {failed[0]} failed" if failed
                       else f"timed out after {timeout:.0f} s")
                raise RuntimeError(f"{target}: {why}\n{logs}")
            time.sleep(0.05)
    finally:
        _kill(procs)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        logs = (folder / f"rank{bad[0]}.log").read_text(errors="replace")
        raise RuntimeError(f"{target}: rank {bad[0]} failed\n{logs[-4000:]}")
    return [pickle.loads((folder / f"result{r}.pkl").read_bytes())
            for r in range(nprocs)]


class Ranks:
    """The child ranks :func:`start_ranks` started.  A watcher thread ends
    this process if one of them fails (rank 0 would otherwise wait on it
    in a collective); :meth:`join` waits for them to finish."""

    def __init__(self, procs, folder: pathlib.Path):
        self.procs = procs
        self.folder = folder
        self._closing = False
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self._closing:
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code not in (None, 0) and not self._closing:
                    print(f"rank {r} exited with code {code}; ending the run",
                          file=sys.stderr, flush=True)
                    _kill(self.procs)
                    os._exit(1)
            time.sleep(0.1)

    def kill(self) -> None:
        self._closing = True
        _kill(self.procs)
        self._close()

    def _close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.folder, ignore_errors=True)

    def join(self, timeout: float = 120.0) -> None:
        t_end = time.monotonic() + timeout
        while (any(p.poll() is None for p in self.procs)
               and time.monotonic() < t_end):
            time.sleep(0.05)
        self._closing = True
        late = [r for r, p in enumerate(self.procs, 1) if p.poll() is None]
        _kill(self.procs)
        bad = [r for r, p in enumerate(self.procs, 1) if p.returncode != 0]
        self._close()
        if late or bad:
            raise RuntimeError(f"ranks {late or bad} did not finish cleanly")


def start_ranks(target: str, args: tuple = (), nprocs: int = 2,
                backend: str = "gloo") -> Ranks:
    """Make this process rank 0 of a new group of ``nprocs`` and start
    ranks 1.. as children running ``target(*args)``."""
    folder = pathlib.Path(tempfile.mkdtemp(prefix="vlut_ranks_"))
    spec = {"target": target, "args": args, "world": nprocs,
            "backend": backend, "init": f"file://{folder / 'rendezvous'}",
            "out": str(folder)}
    ranks = Ranks([_spawn(spec, r, folder, capture=False)
                   for r in range(1, nprocs)], folder)
    try:
        _init(backend, spec["init"], nprocs, 0)
    except BaseException:
        ranks.kill()
        raise
    return ranks


def run_as_ranks(target: str, args: tuple, nprocs: int, backend: str) -> Any:
    """``target(*args)`` in every rank of a group of ``nprocs``: this
    process as rank 0 and the others started beside it (:func:`start_ranks`),
    or, where the environment names a group across hosts
    (``VLUT_COORDINATOR``, or torchrun's), this process as its rank there
    (:func:`init_multihost`)."""
    if os.environ.get("VLUT_COORDINATOR") or os.environ.get(
            "TORCHELASTIC_RUN_ID"):
        init_multihost(backend=backend)
        return _target(target)(*args)
    ranks = start_ranks(target, args, nprocs, backend)
    try:
        out = _target(target)(*args)
    except BaseException:
        ranks.kill()
        raise
    ranks.join()
    return out


def backend_for(device) -> str:
    """The backend of a mesh on ``device``: NCCL on GPUs, gloo on the CPU."""
    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def rank_device(device):
    """This rank's device: on GPUs the host's GPU of its rank (ranks are
    numbered host by host), else ``device`` as given."""
    if dist.is_initialized() and torch.device(device or "cuda").type == "cuda":
        return torch.device("cuda",
                            dist.get_rank() % torch.cuda.device_count())
    return device


def _child(spec_path: str) -> None:
    spec = pickle.loads(pathlib.Path(spec_path).read_bytes())
    rank = spec["rank"]
    _init(spec["backend"], spec["init"], spec["world"], rank)
    result = _target(spec["target"])(*spec["args"])
    out = pathlib.Path(spec["out"]) / f"result{rank}.pkl"
    out.write_bytes(pickle.dumps(result))
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1])
