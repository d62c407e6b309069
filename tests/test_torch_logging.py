"""``vlut_tpu_torch/utils/logging.py``: the port's logger configured from
``VLUT_LOG_LEVEL`` / ``VLUT_LOG_FILE`` as the JAX package's is, the
profiler scope and the phase timer.

``get_logger`` configures the ``vlut_tpu_torch`` root once and stops it
propagating, which would hide every later record from ``caplog`` on the
same worker; the ``fresh`` fixture gives each test an unconfigured root
and restores its level, handlers and ``propagate`` afterwards.
"""

import json
import logging

import pytest

from vlut_tpu_torch.utils import logging as vlog


@pytest.fixture
def fresh(monkeypatch):
    root = logging.getLogger(vlog.ROOT)
    saved = (root.level, list(root.handlers), root.propagate)
    monkeypatch.setattr(vlog, "_configured", False)
    monkeypatch.delenv("VLUT_LOG_LEVEL", raising=False)
    monkeypatch.delenv("VLUT_LOG_FILE", raising=False)
    yield root
    for h in root.handlers:
        if h not in saved[1]:
            h.close()
    root.setLevel(saved[0])
    root.handlers[:] = saved[1]
    root.propagate = saved[2]


@pytest.mark.parametrize("env,level", [
    (None, logging.INFO), ("debug", logging.DEBUG), ("warn", logging.WARNING),
    ("WARNING", logging.WARNING), ("error", logging.ERROR),
    ("bogus", logging.INFO)])
def test_level_from_env(env, level, fresh, monkeypatch):
    if env is not None:
        monkeypatch.setenv("VLUT_LOG_LEVEL", env)
    log = vlog.get_logger("vlut_tpu_torch.convert.t5")
    assert log.name == "vlut_tpu_torch.convert.t5"
    assert fresh.level == level and not fresh.propagate
    assert log.getEffectiveLevel() == level
    n = len(fresh.handlers)
    vlog.get_logger()  # configured once
    assert len(fresh.handlers) == n


def test_log_file_gets_the_jax_format(fresh, monkeypatch, tmp_path):
    path = tmp_path / "vlut.log"
    monkeypatch.setenv("VLUT_LOG_FILE", str(path))
    vlog.get_logger("vlut_tpu_torch.train").warning("step %d", 3)
    for h in fresh.handlers:
        h.flush()
    line = path.read_text().strip()
    # "%(asctime)s %(levelname).1s %(name)s: %(message)s", time as H:M:S
    stamp, level, rest = line.split(" ", 2)
    assert len(stamp.split(":")) == 3
    assert (level, rest) == ("W", "vlut_tpu_torch.train: step 3")


def test_timed_logs_milliseconds(fresh):
    got = []

    class Keep(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())

    log = vlog.get_logger("vlut_tpu_torch.phase")
    log.addHandler(Keep())
    with vlog.timed("load", log):
        pass
    assert len(got) == 1 and got[0].startswith("load: ")
    assert got[0].endswith(" ms")


def test_trace_none_is_a_no_op(fresh, tmp_path, monkeypatch):
    import torch

    def refuse(*a, **k):
        raise AssertionError("the profiler must not start")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    for out in (None, ""):
        with vlog.trace(out):
            x = 1
    assert x == 1 and not list(tmp_path.iterdir())


def test_trace_writes_a_chrome_trace(fresh, tmp_path):
    import torch

    with vlog.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) or "mm" in str(
        e.get("name", "")) for e in events)
