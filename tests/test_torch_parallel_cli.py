"""``generate --tp/--dp`` and ``serve --tp`` on the CPU (gloo ranks).

The CLI process becomes rank 0 and starts the others beside it
(``parallel/distributed.py:run_as_ranks``).  tiny_real's greedy text for
"The little model" (a request whose tokens the mesh and the single-device
engine share, ``test_torch_parallel_engine.py``) must equal the
single-device ``generate``'s; a ``serve --tp 2`` completion must answer
the single-device engine's tokens, its ``/slots`` save and restore must
move the served slot (the file as long as one device's), and the server
must shut its ranks down on SIGINT.
"""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from vlut_tpu_torch.cli import main as cli_main
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams
from vlut_tpu_torch.utils.tokenizer import Tokenizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_REAL = ROOT / "tests" / "fixtures" / "tiny_real"
ARGS = ["generate", "--model", str(TINY_REAL), "-p", "The little model",
        "-n", "12", "--temp", "0", "--device", "cpu"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--dp", "2"]],
                         ids=["tp2", "dp2"])
def test_generate_over_ranks_equals_one_device(flags, capsys):
    cli_main(ARGS)
    want = capsys.readouterr().out
    out = subprocess.run(
        [sys.executable, "-m", "vlut_tpu_torch.cli", *ARGS, *flags],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout == want and want.strip()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_serve_tp2_completion_and_shutdown():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vlut_tpu_torch.cli", "serve", "--model",
         str(TINY_REAL), "--port", str(port), "--slots", "2", "--ctx", "256",
         "--device", "cpu", "--tp", "2"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        t_end = time.monotonic() + 180
        while True:
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            assert time.monotonic() < t_end, "the server did not come up"
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                       timeout=5)
                break
            except OSError:
                time.sleep(0.5)
        got = _post(port, "/completion", {
            "prompt": "The little model", "n_predict": 8,
            "temperature": 0.0, "return_tokens": True})
        emb = _post(port, "/v1/embeddings", {"input": "The little model"})
        # the served slot saved, restored into the other, the first erased:
        # the same request again reuses the restored rows
        saved = _post(port, "/slots/0?action=save", {"filename": "a"})
        restored = _post(port, "/slots/1?action=restore", {"filename": "a"})
        _post(port, "/slots/0?action=erase", {})
        again = _post(port, "/completion", {
            "prompt": "The little model", "n_predict": 8,
            "temperature": 0.0, "return_tokens": True})
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stdout.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    ids = Tokenizer(str(TINY_REAL)).encode("The little model")
    req = Request(prompt=ids, max_new_tokens=8,
                  sampler=SamplerParams(temperature=0.0))
    eng = Engine(cfg, model, n_slots=2, max_len=256)
    eng.run([req])
    assert got["tokens"] == req.output
    assert saved["n_saved"] == restored["n_restored"] == len(
        eng.slots[0].history)
    # the file is the single-device engine's, byte count for byte count
    assert saved["n_bytes"] == len(eng.save_slot(0))
    assert again["tokens"] == req.output
    assert len(emb["data"][0]["embedding"]) == cfg.d_model


def _join_env(tmp_path, nprocs: int, rank: int) -> dict:
    """The environment of one process of a group across hosts
    (``parallel/distributed.py:init_multihost``), met through a ``file://``
    rendezvous under ``tmp_path``."""
    env = _env()
    env.update(VLUT_COORDINATOR=f"file://{tmp_path / 'rendezvous'}",
               VLUT_NPROCS=str(nprocs), VLUT_PROC_ID=str(rank))
    return env


def test_generate_joins_a_group_named_by_the_environment(tmp_path, capsys):
    """``generate --tp 2`` in two processes that join the group
    ``VLUT_COORDINATOR`` names, as on two hosts: the flags are checked
    against the group's two ranks, and rank 0 prints the single-device
    text."""
    cli_main(ARGS)
    want = capsys.readouterr().out
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vlut_tpu_torch.cli", *ARGS, "--tp", "2"],
        cwd=ROOT, env=_join_env(tmp_path, 2, r), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:] + (
        outs[1][1][-3000:])
    assert outs[0][0] == want and want.strip()
    assert outs[1][0] == ""


def test_generate_refuses_a_mesh_past_the_group(tmp_path):
    """The check counts the group's processes (VLUT_NPROCS), not this
    host's devices: ``--tp 2`` in a group of one is refused before it
    joins, naming the count."""
    out = subprocess.run(
        [sys.executable, "-m", "vlut_tpu_torch.cli", *ARGS, "--tp", "2"],
        capture_output=True, text=True, cwd=ROOT,
        env=_join_env(tmp_path, 1, 0), timeout=120)
    assert out.returncode != 0
    assert "--tp 2 x --dp 1 needs 2 devices; 1 processes" in out.stderr
