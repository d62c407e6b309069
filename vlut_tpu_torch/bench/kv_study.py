"""The KV row writer (#5/#6, ``csrc/kv_update.cu``) on the card: checks,
and times in turns with other sources of the kernel.

    python -m vlut_tpu_torch.bench.kv_study [--variant NAME=DIR] [--reps N]

At every shape of :data:`SHAPES` (the flagship batched cache, the flagship
engine's bf16 and q8 caches, tiny_real's heads) a layer's update as the
composed decode path gives it (:func:`layer_update`: V a strided slice of
a fused qkv output, int64 starts; q8: the codes and both scale planes) is
checked bit for bit against the plain assignment with every build, then
timed as CUDA graphs of 20 calls (best of three replays), in turns: this
source (``pdl``), the same source launched without programmatic dependent
launch (``no_pdl``, a text edit built through ``compile_variants``), each
variant, and one ``index_put_`` per array (the library call), ``reps``
rounds in the order A B ... B A.  A variant directory holds another
``kv_update.cu`` of the same interface (for instance the parent commit's
``vlut_tpu_torch/csrc`` unpacked with ``git archive`` under ``build/``).
One JSON line per shape and build, in us per call, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import torch

from vlut_tpu_torch.bench.tiled_study import (
    compile_variants,
    graph_us,
    variant_source,
)
from vlut_tpu_torch.ops import kv_update
from vlut_tpu_torch.runtime.kv_cache import quantize_kv

# (label, B, S, Hkv, q8)
SHAPES = (("batched", 32, 184, 8, False), ("engine", 32, 2048, 8, False),
          ("engine_q8", 32, 2048, 8, True), ("tiny_real", 4, 256, 2, False),
          ("tiny_real_q8", 4, 256, 2, True))
# the launch without its programmatic stream serialization attribute
NO_PDL = [("  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n")]


def layer_update(gen, b: int, s: int, hkv: int, q8: bool, hd: int = 128,
                 g: int = 4):
    """(caches, rows, start): a layer's update as ``_SlotKV.update`` hands
    it to #5: K rows, V rows as a strided column slice of a fused bf16 qkv
    output, int64 starts spread over [0, S) (the first 0, the last S - 1);
    for q8 the codes and the scale planes, quantized as the layer does."""
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    qkv = randn(b, 1, (g + 2) * hkv * hd)
    qd, kvd = g * hkv * hd, hkv * hd
    k = qkv[..., qd:qd + kvd].reshape(b, 1, hkv, hd).contiguous()
    v = qkv[..., qd + kvd:].reshape(b, 1, hkv, hd)
    start = torch.linspace(0, s - 1, b, device=dev).long()
    cache = [randn(b, s, hkv, hd), randn(b, s, hkv, hd)]
    if not q8:
        return cache, [k, v], start
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    (kc, ksc), (vc, vsc) = quantize_kv(cache[0]), quantize_kv(cache[1])
    return [kc, vc, ksc, vsc], [kq, vq, ks, vs], start


def _variants(dirs: dict[str, pathlib.Path]) -> dict:
    """name -> call(caches, rows, start) for each variant directory."""
    libs = compile_variants(dirs, "kv_update.cu")
    calls = {}
    for name, lib in libs.items():
        lib.vlut_write_rows.argtypes = kv_update._lib().vlut_write_rows \
            .argtypes
        lib.vlut_write_rows.restype = ctypes.c_int
        calls[name] = (lambda c, r, st, _lib=lib:
                       kv_update._launch(c, r, st, lib=_lib))
    return calls


def _check(name, call, caches, rows, start) -> None:
    want = [c.clone() for c in caches]
    for c, u in zip(want, rows):
        kv_update._write_plain(c, u, start)
    call(caches, rows, start)
    torch.cuda.synchronize()
    if not all(torch.equal(c, w) for c, w in zip(caches, want)):
        raise SystemExit(f"{name}: differs from the plain assignment")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench."
                                 "kv_study", description=__doc__.split(
                                     "\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR of another kv_update.cu")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dirs = {"no_pdl": variant_source("kv_no_pdl", NO_PDL, "kv_update.cu"),
            **{n: pathlib.Path(d) for n, d in
               (v.split("=", 1) for v in args.variant)}}
    builds = {"pdl": kv_update._launch, **_variants(dirs)}
    for label, b, s, hkv, q8 in SHAPES:
        caches, rows, start = layer_update(gen, b, s, hkv, q8)
        idx = (torch.arange(b, device=start.device), start)
        builds["index_put"] = lambda c, r, st: [
            a.index_put_(idx, u[:, 0]) for a, u in zip(c, r)]
        for name, call in builds.items():
            _check(name, call, caches, rows, start)
        order = list(builds)
        times: dict[str, list[float]] = {n: [] for n in order}
        for rep in range(args.reps):
            for name in (order if rep % 2 == 0 else order[::-1]):
                times[name].append(graph_us(
                    lambda: builds[name](caches, rows, start), 20))
        nbytes = 2 * sum(u.numel() * u.element_size() for u in rows) + 8 * b
        for name, us in times.items():
            print(json.dumps({"shape": label, "B": b, "S": s, "Hkv": hkv,
                              "arrays": len(caches), "build": name, "us": us,
                              "bound_us": nbytes / 3.35e12 * 1e6,
                              "card": card}), flush=True)
        del caches, rows
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
