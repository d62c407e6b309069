"""Collective census of one call (port of vlut_tpu/parallel/census.py).

The JAX package counts the collectives of a compiled program by parsing
XLA's HLO text (``census_from_hlo``).  PyTorch compiles no such program, so
here :func:`comm_census` counts the collectives the port's helpers
(``parallel/_comm.py``) issue during one call of ``fn``, under the same op
names, with the bytes of each result, as the HLO census reads them off
each op's result shape.
"""

from __future__ import annotations

from vlut_tpu_torch.parallel import _comm

_OPS = ("all-reduce", "all-gather", "reduce-scatter",
        "collective-permute", "all-to-all")


def comm_census(fn, *args, **kwargs) -> dict[str, dict[str, int]]:
    """{op: {"count": n, "bytes": b}} of the collectives issued by one call
    ``fn(*args, **kwargs)`` (ops that ran none are left out)."""
    if _comm._RECORD is not None:
        raise RuntimeError("comm_census calls do not nest")
    _comm._RECORD = []
    try:
        fn(*args, **kwargs)
        seen = _comm._RECORD
    finally:
        _comm._RECORD = None
    out = {op: {"count": 0, "bytes": 0} for op in _OPS}
    for op, nbytes in seen:
        out[op]["count"] += 1
        out[op]["bytes"] += nbytes
    return {op: v for op, v in out.items() if v["count"]}


def total_bytes(census: dict[str, dict[str, int]]) -> int:
    return sum(v["bytes"] for v in census.values())


def format_census(census: dict[str, dict[str, int]]) -> str:
    parts = ", ".join(
        f"{op} x{v['count']} = {v['bytes']/1e6:.3f} MB"
        for op, v in census.items()
    )
    t = total_bytes(census)
    return (f"{parts or 'no collectives'}"
            f"{f'; total {t/1e6:.3f} MB/step' if t else ''}")
