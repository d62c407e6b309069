"""The port's tp forward across a group joined from the environment, as
``tests/test_distributed.py`` runs the JAX package's across two processes.

A JAX process owns several devices; a port process owns one, so the
JAX test's two processes of four devices become four processes here, two
"hosts" of two (``LOCAL_WORLD_SIZE=2``): each joins the group named by
``VLUT_COORDINATOR`` (a ``file://`` rendezvous under ``tmp_path``) /
``VLUT_NPROCS`` / ``VLUT_PROC_ID`` through ``init_multihost``, and
``global_mesh(dp=2)`` puts tp inside a host and dp across hosts.  Each
process's rows are held against the JAX single-device forward at the JAX
test's tolerance (rtol = atol = 0.05).  A rank that fails ends the others
at once.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vlut_tpu.config import PRESETS
from vlut_tpu.models.transformer import forward, init_kv_cache, init_params
from vlut_tpu_torch.convert.from_jax import _convert
from vlut_tpu_torch.parallel.distributed import launch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = """
import pickle, sys
sys.path.insert(0, {tests!r})
import _torch_parallel as w
args = pickle.load(open({args!r}, "rb"))
out = w.multihost_forward(*args)
pickle.dump(out, open({out!r} + str(out["rank"]), "wb"))
# leave the group together: a rank whose peers exit first can abort in
# gloo's threads at exit
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def test_four_process_multihost_tp_forward(tmp_path):
    cfg = PRESETS["tiny_bitnet"]
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    b, t = 4, 6
    tokens = rng.integers(0, cfg.vocab_size, (b, t))
    pos = np.tile(np.arange(t), (b, 1))
    at = np.full((b,), t - 1)
    ref, _ = forward(params, cfg, jnp.asarray(tokens, jnp.int32),
                     jnp.asarray(pos, jnp.int32),
                     init_kv_cache(cfg, b, max_len=32, dtype=jnp.float32),
                     impl="xla", logits_at=jnp.asarray(at, jnp.int32))
    ref = np.asarray(ref)
    args = tmp_path / "args.pkl"
    args.write_bytes(pickle.dumps((
        "tiny_bitnet", _convert(jax.tree.map(np.asarray, params)), tokens,
        pos, at)))
    script = WORKER.format(tests=str(ROOT / "tests"), args=str(args),
                           out=str(tmp_path / "out"))
    procs = []
    for i in range(4):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        env.update(VLUT_COORDINATOR=f"file://{tmp_path / 'rendezvous'}",
                   VLUT_NPROCS="4", VLUT_PROC_ID=str(i), LOCAL_WORLD_SIZE="2",
                   PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    for i in range(4):
        r = pickle.loads((tmp_path / f"out{i}").read_bytes())
        assert r["rank"] == r["env_rank"] == i
        assert r["shape"] == {"dp": 2, "tp": 2}
        # tp inside a "host" (ranks 0-1, 2-3), dp across them
        assert r["coords"] == {"dp": i // 2, "tp": i % 2}
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["logits"], ref[lo:hi], rtol=0.05,
                                   atol=0.05)
        assert (r["logits"].argmax(-1) == ref[lo:hi].argmax(-1)).all()


def test_a_failing_rank_fails_the_group(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the launch fails at
    once with rank 1's error instead of waiting out the group's timeout."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch("_torch_parallel:fail_on", (1,), nprocs=2, timeout=120,
               folder=tmp_path)
