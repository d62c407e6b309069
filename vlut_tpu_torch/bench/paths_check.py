"""The fused-against-composed check (``bench/engine.py:compare_paths``,
``paths_ok``) sound and under wiring faults of the fused attention's output
(:data:`FAULTS`), at full width: the flagship (32 slots), falcon-7b
(``bench/zoo.py:FALCON_7B``, 16 slots: 71 heads over one) and
OuteTTS-0.2-500M (one slot: 14 heads over 2), random packed weights from a
seed, each cache prefilled with seeded prompts, then the next step
compared.  Prints one JSON line a model and case (the largest layer
difference, the layers' noise floor, the bound and the verdict) and exits
non-zero when the sound case fails or a fault passes.

    python -m vlut_tpu_torch.bench.paths_check [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from vlut_tpu_torch.bench import zoo
from vlut_tpu_torch.bench.engine import PATHS_X, compare_paths, paths_ok
from vlut_tpu_torch.bench.flagship import build_model
from vlut_tpu_torch.device import resolve_device
from vlut_tpu_torch.models import transformer as tt


def _drop_last_head(o: torch.Tensor) -> torch.Tensor:
    return o.index_fill(2, torch.tensor([o.shape[2] - 1], device=o.device),
                        0)


def _roll_value_columns(o: torch.Tensor) -> torch.Tensor:
    return torch.cat([o[..., :64].roll(1, -1), o[..., 64:]], -1)


# faults of the fused attention's output (B, 1, H, hdv): a head lost (a
# group's last head not stored), the value columns shifted by one (a
# misplaced V column)
FAULTS = {"drop_last_head": _drop_last_head,
          "roll_value_columns": _roll_value_columns}


@contextlib.contextmanager
def faulty(fault):
    """Within: every fused attention output (#7 / #8, or their plain
    versions on the CPU) passes through ``fault``."""
    attend = tt._SlotKV.fused_attend
    tt._SlotKV.fused_attend = lambda self, *a, **k: fault(attend(self, *a,
                                                                 **k))
    try:
        yield
    finally:
        tt._SlotKV.fused_attend = attend


@torch.inference_mode()
def check(cfg, model, slots: int, prompt: int, device,
          seed: int = 0) -> list[dict]:
    """:func:`compare_paths` at the step after ``slots`` seeded prompts of
    ``prompt`` tokens, sound and under each of :data:`FAULTS`."""
    dev = torch.device(device)
    cache = tt.init_kv_cache(cfg, slots, max_len=prompt + 8, device=dev)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        3, cfg.vocab_size, (slots, prompt + 1))).to(dev)
    tt.forward(model, cfg, ids[:, :prompt],
               torch.arange(prompt, device=dev).expand(slots, prompt), cache,
               logits_at=torch.full((slots,), prompt - 1, device=dev))
    out = []
    for name, fault in (("sound", None), *FAULTS.items()):
        with faulty(fault) if fault else contextlib.nullcontext():
            p = compare_paths(model, cfg, ids[:, prompt:],
                              torch.full((slots, 1), prompt, device=dev),
                              cache)
        floor = p["noise_floor"]["max_rel_layer_diff"]
        out.append({"case": name, "ok": paths_ok(p),
                    "max_rel_layer_diff": p["max_rel_layer_diff"],
                    "noise_floor": floor, "bound": PATHS_X * floor,
                    "max_rel_logit_diff": p["max_rel_logit_diff"]})
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench."
                                 "paths_check")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    models = (
        ("llama3_8b_158", lambda: build_model("llama3_8b_158", dev), 32, 256),
        ("falcon_7b", lambda: zoo.hf_model(zoo.FALCON_7B, dev, seed=19), 16,
         512),
        ("outetts_0_2_500m",
         lambda: build_model("outetts_0_2_500m", dev, seed=27), 1, 586))
    right = True
    for name, build, slots, prompt in models:
        cfg, model = build()
        for row in check(cfg, model, slots, prompt, dev):
            right &= row["ok"] is (row["case"] == "sound")
            print(json.dumps({"model": name, **row}), flush=True)
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0 if right else 1


if __name__ == "__main__":
    sys.exit(main())
