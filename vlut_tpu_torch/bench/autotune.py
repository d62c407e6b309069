"""The tiled GEMM's tiles and the small-M route, tuned on the card (port of
vlut_tpu/bench/autotune.py).

The JAX package sweeps its Pallas block shapes (bm, bn, bk) on a TPU and
keeps the winners in ``autotune_v5e.json``.  Here the same search runs over
what the Hopper kernels take:

* the tiled GEMM's (#3, ``csrc/ternary_gemm.cu``) tiles (BM, BN, splits),
  for which ``ops/ternary_gemm.py:tiled_plan`` is the default;
* the route of :func:`vlut_tpu_torch.ops.matmul.ternary_matmul` at M <= 64:
  ``"small"``, the fused-quant kernel (#4, ``csrc/decode_gemm.cu``), the
  default, or ``"tiled"``, the same int8 quantization then #3.  Both give
  the same int32 accumulator and the same ``(acc * xs) * ws`` epilogue, so
  the route changes the time, never the result.

``autotune_h100.json`` beside this file records the card it was measured
on (name, SM count, power limit).  The lookups read it only on a card of
that name; elsewhere, and on the CPU, they return None and the defaults
hold.  An entry is written only where the sweep beat the default by more
than the spread of its repeats.

    python -m vlut_tpu_torch.bench.autotune [-o FILE] [--fmt i2,i1]
        [-ns 32,...] [--shapes dxd,...]

prints one JSON line per shape and writes the table.  It needs a CUDA
device: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import pathlib
import subprocess
import time
from typing import Any

import torch

TABLE_FILE = pathlib.Path(__file__).with_name("autotune_h100.json")

# the M at which the main path launches #3: the engine's prefill buckets
# (16-1024, grouped in powers of two), the speculative verify (160), the
# lookahead round (352) and the flagship prefill (4096); keys round M up
# to 32
TILE_MS = (32, 64, 128, 160, 256, 352, 512, 1024, 4096)
# the M of the route sweep (M 128 only times #3: #4 takes M <= 64)
ROUTE_MS = (1, 8, 16, 32, 48, 64, 128)
# (tag, K, N) of the route sweep: the unfused flagship's projections, a
# Mixtral expert's (its gate / up and down are the flagship's), and
# mamba_2_8b's in_proj / out_proj
ROUTE_SHAPES = (("wq_wo", 4096, 4096), ("wk_wv", 4096, 1024),
                ("gate_up_expert", 4096, 14336),
                ("down_expert", 14336, 4096),
                ("mamba_in", 2560, 10240), ("mamba_out", 5120, 2560))
# the fused tree's projections at M 16-128: #1 against the composed path
# (measured for the record; ternary_matmul_fused does not route by it)
FUSED_SHAPES = (("qkv", 4096, 6144, "norm"), ("wo", 4096, 4096, "plain"),
                ("gateup", 4096, 28672, "norm"),
                ("down", 14336, 4096, "silu_mul"))
FUSED_MS = (16, 32, 64, 128)
ITERS = 20
REPEATS = 5


def _key(fmt: str, m: int, kp: int, np_: int) -> str:
    return f"{fmt}:{-(-max(m, 1) // 32) * 32}:{kp}:{np_}"


def _route_key(fmt: str, m: int, kp: int, np_: int) -> str:
    return f"route:{fmt}:{m}:{kp}:{np_}"


def device_name(index: int) -> str | None:
    """The name of CUDA device ``index``, or None without one."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(index)


@functools.lru_cache(maxsize=None)
def _read(path: str) -> dict[str, Any]:
    try:
        return json.loads(pathlib.Path(path).read_text())
    except FileNotFoundError:
        return {}


@functools.lru_cache(maxsize=None)
def load_table(index: int = 0) -> dict[str, Any]:
    """The table's entries where device ``index`` is the card they were
    measured on, else {}."""
    table = _read(str(TABLE_FILE))
    name = device_name(index)
    if name is None or table.get("card", {}).get("name") != name:
        return {}
    return table.get("entries", {})


@functools.lru_cache(maxsize=None)
def lookup(fmt: str, m: int, kp: int, np_: int,
           index: int = 0) -> tuple[int, int, int] | None:
    """Tuned (BM, BN, splits) of #3 for an (M, Kp) x (Kp, Np) GEMM, or
    None where the table has none (``tiled_plan`` then holds)."""
    hit = load_table(index).get(_key(fmt, m, kp, np_))
    return tuple(hit) if hit else None


@functools.lru_cache(maxsize=None)
def lookup_route(fmt: str, m: int, kp: int, np_: int,
                 index: int = 0) -> str | None:
    """The measured route at M <= 64 (``"small"`` | ``"tiled"``) of a
    weight shape, or None where it is untuned (``"small"`` then holds).
    A query at M rounds up to the nearest tuned M of the same weight
    shape, so entries at a few M cover the M between them."""
    pre, suf = f"route:{fmt}:", f":{kp}:{np_}"
    best: tuple[int, str] | None = None
    for key, v in load_table(index).items():
        if key.startswith(pre) and key.endswith(suf):
            km = int(key[len(pre):-len(suf)])
            if km >= m and (best is None or km < best[0]):
                best = (km, v)
    return best[1] if best else None


def reset() -> None:
    """Forget the cached table and lookups (after :data:`TABLE_FILE`
    changes)."""
    for f in (_read, load_table, lookup, lookup_route):
        f.cache_clear()


# --- the sweep (on the card) -------------------------------------------------

def candidates(m: int, np_: int, kp: int, fmt: str, sms: int):
    """Every (BM, BN, splits) that ``ternary_gemm.cu`` takes for the shape:
    BM x BN one of 32 x 128, 64 x 128, 128 x 128, 128 x 256 (Np a multiple
    of BN), splits a divisor of the pack blocks up to 16 leaving each
    split two blocks deep.  A split of K that takes the grid past two
    waves of ``sms`` blocks only adds workspace traffic, and is left out."""
    from vlut_tpu_torch.ops.packing import DEFAULT_BLOCK

    nb = kp // DEFAULT_BLOCK[fmt]
    for bm, bn in ((32, 128), (64, 128), (128, 128), (128, 256)):
        if np_ % bn:
            continue
        tiles = np_ // bn * -(-m // bm)
        for s in range(1, 17):
            if nb % s == 0 and (s == 1 or (nb // s >= 2
                                            and tiles * s <= 2 * sms)):
                yield bm, bn, s


def _samples(call, iters: int, n: int = REPEATS) -> list[float]:
    """``n`` replays of a CUDA graph of ``iters`` calls: us per call of
    each (device time from CUDA events)."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            call()
    g.replay()
    out = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) * 1e3 / iters)
    del g
    return out


def _in_turns(a, b, iters: int) -> tuple[list[float], list[float]]:
    """Samples of calls ``a`` and ``b`` taken in turns (a, b, b, a)."""
    sa, sb = _samples(a, iters), _samples(b, iters)
    sb += _samples(b, iters)
    sa += _samples(a, iters)
    return sa, sb


def _beats(challenger: list[float], default: list[float]) -> bool:
    """The challenger's slowest sample is faster than the default's
    fastest: a gain larger than the spread of either's repeats."""
    return max(challenger) < min(default)


class _Weights:
    """Copies of one random packed weight whose total exceeds the 50 MB
    L2, cycled per call, so each call streams its weight from memory."""

    def __init__(self, fmt, k, n, gen, dev):
        from vlut_tpu_torch.bench.kernels import (
            L_STACK, ROTATION_BYTES, rand_packed)
        from vlut_tpu_torch.ops.packing import padded_k

        p = rand_packed(fmt, k, n, gen, dev)
        copies = max(L_STACK, math.ceil(ROTATION_BYTES / p.numel()))
        self.copies = [p] + [p.clone() for _ in range(copies - 1)]
        self.kp, self.np_, self.i = padded_k(k, fmt), p.shape[1], 0
        # a graph of one call per copy: its replays cycle them all
        self.iters = max(ITERS, len(self.copies))
        self.ws = torch.ones((self.np_,), device=dev)

    def next(self) -> torch.Tensor:
        self.i = (self.i + 1) % len(self.copies)
        return self.copies[self.i]


def autotune(fmt: str, m: int, k: int, n: int, gen,
             out: dict[str, Any] | None = None) -> dict[str, Any]:
    """Sweep #3's tiles for one (M, K) x (K, N) GEMM on ``gen``'s CUDA
    device: every candidate once, then the fastest against ``tiled_plan``
    in turns.  Returns the record; its ``entry`` (also written into
    ``out`` under the shape's key) is the winning tiles where they beat
    the plan by more than the spread, else None."""
    from vlut_tpu_torch.ops import ternary_gemm as tg
    from vlut_tpu_torch.ops.packing import DEFAULT_BLOCK

    dev = gen.device
    sms = tg.sm_count(dev.index or 0)
    w = _Weights(fmt, k, n, gen, dev)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    xs = torch.ones((m, 1), device=dev)
    kb = DEFAULT_BLOCK[fmt]

    def call(plan):
        return lambda: tg._tiled_cuda(xq, w.next(), xs, w.ws, fmt, kb, k,
                                      torch.float32, plan=plan)

    plan = tg.tiled_plan(m, w.np_, w.kp, fmt, sms)
    us = {c: min(_samples(call(c), w.iters, n=3))
          for c in dict.fromkeys([plan, *candidates(m, w.np_, w.kp, fmt,
                                                    sms)])}
    best = min(us, key=us.get)
    rec = {"fmt": fmt, "m": m, "k": k, "n": n, "key": _key(fmt, m, w.kp,
                                                           w.np_),
           "plan": list(plan), "best": list(best),
           "us": {"x".join(map(str, c)): t for c, t in us.items()},
           "entry": None}
    if best != plan:
        sp, sb = _in_turns(call(plan), call(best), w.iters)
        rec.update(plan_us=[min(sp), max(sp)], best_us=[min(sb), max(sb)])
        if _beats(sb, sp):
            rec["entry"] = list(best)
            if out is not None:
                out[rec["key"]] = rec["entry"]
    return rec


def route_sweep(fmt: str, m: int, k: int, n: int, gen, dev, sms: int,
                tuned: dict[str, Any]) -> dict[str, Any]:
    """#4 (``"small"``) against quantize + #3 (``"tiled"``, at the tiles
    of ``tuned``, the tile entries, or ``tiled_plan``'s) at one M, in
    turns; at M > 64 #3 alone.  ``tiled_wins``: by more than the
    spread."""
    from vlut_tpu_torch.ops import ternary_gemm as tg
    from vlut_tpu_torch.ops.packing import DEFAULT_BLOCK

    w = _Weights(fmt, k, n, gen, dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    kb = DEFAULT_BLOCK[fmt]

    def small():
        return tg._decode_cuda(x, w.next(), w.ws, None, None, None, fmt, kb,
                               "plain", False, 0, 0.0, torch.float32)

    plan = tuned.get(_key(fmt, m, w.kp, w.np_)) or tg.tiled_plan(
        m, w.np_, w.kp, fmt, sms)

    def tiled():
        xq, xs = tg.kernel_quantize(x)
        return tg._tiled_cuda(xq, w.next(), xs, w.ws, fmt, kb, k,
                              torch.float32, plan=tuple(plan))

    rec = {"fmt": fmt, "m": m, "k": k, "n": n,
           "key": _route_key(fmt, m, w.kp, w.np_)}
    if m > tg.MAX_DECODE_M:
        st = _samples(tiled, w.iters)
        return {**rec, "tiled_us": [min(st), max(st)], "tiled_wins": None}
    ss, st = _in_turns(small, tiled, w.iters)
    return {**rec, "small_us": [min(ss), max(ss)],
            "tiled_us": [min(st), max(st)], "tiled_wins": _beats(st, ss)}


def fused_crossover(m: int, k: int, n: int, mode: str, gen,
                    dev) -> dict[str, Any]:
    """``ternary_matmul_fused``'s two paths at one M of a fused-tree
    projection (i2, bf16): #1 (M <= 64) and the composed prologue +
    quantize + #3 [+ residual], in turns."""
    from vlut_tpu_torch.ops import ternary_gemm as tg
    from vlut_tpu_torch.ops.quant import quantize_activations

    w = _Weights("i2", k, n, gen, dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    x2 = (torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
          if mode == "silu_mul" else None)
    g = torch.ones((k,), device=dev) if mode != "plain" else None
    res = (torch.randn((m, w.np_), generator=gen, device=dev).to(
        torch.bfloat16) if mode != "norm" else None)

    def decode():
        return tg._decode_cuda(x, w.next(), w.ws, x2, g, res, "i2", 128,
                               mode, False, k, 1e-5, torch.bfloat16)

    def composed():
        xq, xs = quantize_activations(tg.decode_input(x, x2, g, mode, False,
                                                      k, 1e-5))
        out = tg._tiled_cuda(xq, w.next(), xs, w.ws, "i2", 128, k,
                             torch.float32).to(torch.bfloat16)
        return out if res is None else res + out

    rec = {"m": m, "k": k, "n": n, "mode": mode}
    if m > tg.MAX_DECODE_M:
        sc = _samples(composed, w.iters)
        return {**rec, "composed_us": [min(sc), max(sc)]}
    sd, sc = _in_turns(decode, composed, w.iters)
    return {**rec, "decode_us": [min(sd), max(sd)],
            "composed_us": [min(sc), max(sc)]}


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> dict[str, Any]:
    from vlut_tpu_torch.bench.kernels import MODEL_SHAPES
    from vlut_tpu_torch.device import resolve_device
    from vlut_tpu_torch.ops import _build, ternary_gemm as tg

    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench."
                                 "autotune", description=__doc__.split(
                                     "\n")[0])
    ap.add_argument("-o", "--output", default=str(TABLE_FILE))
    ap.add_argument("--fmt", default="i2,i1")
    ap.add_argument("-ns", default=",".join(map(str, TILE_MS)),
                    help="comma-separated M of the tile sweep")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated tags (dxd, dxff, ffxd, qkv, "
                    "gateup) of the tile sweep")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    index = dev.index or 0
    t0 = time.time()
    _build.build_all()
    card = _card_line()
    sms = tg.sm_count(index)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fmts = args.fmt.split(",")
    entries: dict[str, Any] = {}
    measured: dict[str, Any] = {}
    _emit(card=card, sms=sms)

    shapes = []
    for model, (d, ff) in MODEL_SHAPES.items():
        shapes += [(model, "dxd", d, d), (model, "dxff", d, ff),
                   (model, "ffxd", ff, d)]
    # the load-time-fused widths of llama3_8b: qkv d -> q + 2 kv (GQA 4),
    # gate|up d -> 2 ff
    d, ff = MODEL_SHAPES["llama3_8b"]
    shapes += [("llama3_8b", "qkv", d, d + d // 2),
               ("llama3_8b", "gateup", d, 2 * ff)]
    if args.shapes:
        keep = set(args.shapes.split(","))
        shapes = [s for s in shapes if s[1] in keep]
    for fmt in fmts:
        for model, tag, k, n in shapes:
            for m in (int(x) for x in args.ns.split(",")):
                rec = autotune(fmt, m, k, n, gen, out=entries)
                _emit(tiles=f"{model} {tag}", **rec)
                torch.cuda.empty_cache()
                if rec["entry"]:
                    measured[rec["key"]] = {
                        k_: rec[k_] for k_ in ("plan", "plan_us", "best_us")}

    routes = {}
    for fmt in fmts:
        for tag, k, n in ROUTE_SHAPES:
            recs = [route_sweep(fmt, m, k, n, gen, dev, sms, entries)
                    for m in ROUTE_MS]
            for rec in recs:
                _emit(route=tag, **rec)
            torch.cuda.empty_cache()
            small = [r for r in recs if r["tiled_wins"] is not None]
            if any(r["tiled_wins"] for r in small):
                # every measured M of the shape, so that a query rounding
                # up finds the route of the M above it
                for r in small:
                    routes[r["key"]] = "tiled" if r["tiled_wins"] else "small"
                    measured[r["key"]] = {"small_us": r["small_us"],
                                          "tiled_us": r["tiled_us"]}
    entries.update(routes)
    for tag, k, n, mode in FUSED_SHAPES:
        for m in FUSED_MS:
            _emit(fused_crossover=tag, **fused_crossover(m, k, n, mode, gen,
                                                         dev))
        torch.cuda.empty_cache()

    table = {"card": {"name": torch.cuda.get_device_name(index),
                      "sms": sms, "nvidia_smi": card},
             "made_by": "python -m vlut_tpu_torch.bench.autotune",
             "entries": dict(sorted(entries.items())),
             "measured_us": dict(sorted(measured.items()))}
    pathlib.Path(args.output).write_text(json.dumps(table, indent=1) + "\n")
    _emit(wrote=args.output, entries=len(entries),
          seconds=time.time() - t0)
    return table


if __name__ == "__main__":
    main()
