"""The vision families on the card: each tower family as a small
random-weight model, converted, encoded and spliced into its language
model on the card and on the CPU, and the full-width LLaVA-1.5-7B run of
``chip_smoke.py`` phase 26.

Families (``vision_families.json``, held by ``tests/test_torch_vision_zoo.py``
to the JAX vision tests' own sources): ``sources`` are HF directories
(their ``config.json`` and tensor shapes and dtypes) of llava, gemma3,
pixtral, mistral3, internvl, llama4, idefics3, glm4v, janus, lfm2-vl,
qwen3-vl, qwen2-vl, qwen2.5-vl and cogvlm, filled with random values from a
seed by each tensor's role (the language model's projections exact
ternary, so the conversion is lossless); ``twins`` are the towers no
converter writes (llava's MLP_NORM projector, MiniCPM-V's resampler,
Kimi-VL, LDP / LDPv2, GLM-Edge, CogVLM's EVA2-CLIP, Youtu-VL), as the
calls the JAX tests make: each function, its parameters' shapes, its
config and its input's shape.

    python -m vlut_tpu_torch.bench.vision_zoo [--family NAME ...]
        [--device cpu]

prints one JSON line per family (:func:`card_vs_cpu`).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import pathlib
import tempfile
import time

import numpy as np
import torch

from vlut_tpu_torch.device import resolve_device

STRUCTURES: dict = json.loads(
    (pathlib.Path(__file__).with_name("vision_families.json")).read_text())
SOURCES = tuple(STRUCTURES["sources"])
TWINS = tuple(STRUCTURES["twins"])
FAMILIES = SOURCES + TWINS
ROOT = pathlib.Path(__file__).resolve().parents[2]
# the sources whose splice into their language model is not run, and why;
# any other source's splice must run, and these must not
NO_SPLICE = {
    "llama4": "both packages refuse its text side (interleaved rope at a "
              "padded head width)",
    "glm4v": "the JAX test's source pairs the tower with a language model "
             "of another width",
    "lfm2_vl": "its text side is a hybrid (held by the hybrid converter's "
               "tests and phase 25)",
}
# float32 towers on the card: within this share of the CPU's largest value
# (cuBLAS and the CPU sum float32 products in other orders; TF32 off)
FLOAT_TOL = 1e-4
_MODULES = ("vision", "vision_ext", "vision_wave3", "qwen_vision")
# the port's tower and projector functions a family's encode runs
TOWER_FNS = (
    "encode_tower", "llava_project", "siglip_forward", "gemma3_project",
    "pixtral_forward", "pixtral_project", "minicpmv_resampler",
    "internvl_forward", "internvl_project", "llama4_vision_forward",
    "llama4_project", "idefics3_project", "glm4v_vision_forward",
    "janus_aligner", "lfm2vl_project", "kimivl_forward", "kimivl_project",
    "ldp_project", "ldpv2_project", "glm_edge_project",
    "qwen3vl_vision_forward", "cogvlm_vision_forward", "cogvlm_project",
    "youtuvl_vision_forward", "vision_forward",
)
_TOWER_PREFIXES = ("vision_tower.", "multi_modal_projector.", "vision_model.",
                   "connector.", "aligner.", "visual.", "model.vision_tower.",
                   "model.multi_modal_projector.", "model.vision_model.",
                   "model.visual.", "model.vision.")


def module_of(name: str):
    """The port's tower module that defines ``name``."""
    for m in _MODULES:
        mod = importlib.import_module(f"vlut_tpu_torch.models.{m}")
        if hasattr(mod, name):
            return mod
    raise KeyError(name)


# --- random sources --------------------------------------------------------

def _hf_values(name: str, shape: list[int], rng: np.random.Generator
               ) -> np.ndarray:
    """Random float32 values for one HF tensor by its role: norm gains near
    1, biases small, the language model's 2-D projections exact ternary at
    0.05, embeddings at 1, other matrices and convolutions at 1 /
    sqrt(fan-in), the rest at 0.1."""
    tower = name.startswith(_TOWER_PREFIXES)
    if "norm" in name.lower() and name.endswith("weight") or \
            name.endswith(("lambda_1", "lambda_2")):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name.endswith("bias"):
        return 0.02 * rng.standard_normal(shape)
    if "embed_tokens" in name:
        return rng.standard_normal(shape)
    if len(shape) == 2 and not tower and ".layers." in name:
        return 0.05 * rng.integers(-1, 2, size=shape)
    if len(shape) >= 2:
        return rng.standard_normal(shape) / math.sqrt(
            float(np.prod(shape[1:])))
    return 0.1 * rng.standard_normal(shape)


def write_source(name: str, dst: pathlib.Path, seed: int = 0
                 ) -> pathlib.Path:
    """The family's HF directory at ``dst``: its config.json and one
    safetensors file of random values (:func:`_hf_values`), in each
    tensor's stored dtype (BF16 rounded to nearest even)."""
    from vlut_tpu_torch.convert.checkpoint import write_safetensors

    entry = STRUCTURES["sources"][name]
    rng = np.random.default_rng(seed)
    arrays, bf16 = {}, set()
    for tname, (shape, dtype) in sorted(entry["tensors"].items()):
        if dtype in ("F32", "F16", "BF16", "F64"):
            a = _hf_values(tname, shape, rng).astype(np.float32)
            if dtype == "BF16":
                a = torch.from_numpy(a).to(torch.bfloat16).view(
                    torch.int16).numpy().view(np.uint16)
                bf16.add(tname)
            elif dtype != "F32":
                a = a.astype({"F16": np.float16, "F64": np.float64}[dtype])
        else:
            a = np.zeros(shape, {"I64": np.int64, "I32": np.int32,
                                 "U8": np.uint8, "BOOL": np.bool_}[dtype])
        arrays[tname] = a
    dst.mkdir(parents=True, exist_ok=True)
    (dst / "config.json").write_text(json.dumps(entry["config"]))
    write_safetensors(dst / "model.safetensors", arrays, frozenset(bf16))
    return dst


def same_outputs(a: pathlib.Path, b: pathlib.Path) -> list[str]:
    """The files (and arrays) in which two converted checkpoints differ:
    every safetensors file, array for array, and the meta."""
    from vlut_tpu_torch.convert.checkpoint import safetensors_arrays

    bad = []
    names = sorted(f.name for f in a.glob("*.safetensors"))
    if names != sorted(f.name for f in b.glob("*.safetensors")):
        return ["files"]
    for f in names:
        x, y = safetensors_arrays(a / f), safetensors_arrays(b / f)
        if sorted(x) != sorted(y):
            bad.append(f)
            continue
        bad += [f"{f}:{k}" for k in x if x[k].dtype != y[k].dtype
                or x[k].shape != y[k].shape
                or x[k].tobytes() != y[k].tobytes()]
    if (json.loads((a / "vlut_config.json").read_text())
            != json.loads((b / "vlut_config.json").read_text())):
        bad.append("vlut_config.json")
    return bad


# --- towers ------------------------------------------------------------------

@contextlib.contextmanager
def recorded(calls: list):
    """Within: every tower function of the port appends (name, args,
    kwargs, result) to ``calls`` (nested calls too)."""
    saved = []
    for name in TOWER_FNS:
        mod = module_of(name)
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            out = _real(*args, **kw)
            calls.append((_name, args, kw, out))
            return out

        saved.append((mod, name, real))
        setattr(mod, name, spy)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def _to(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def rel_err(got, want) -> float:
    """The largest error of ``got`` over the largest magnitude of ``want``
    (pairs of lists walked; inf on another shape or a non-finite value)."""
    if isinstance(want, (list, tuple)):
        return max([rel_err(g, w) for g, w in zip(got, want)] or [0.0])
    g, w = got.float().cpu(), want.float().cpu()
    if g.shape != w.shape or not torch.isfinite(g).all():
        return math.inf
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def towers_on(calls: list, device) -> dict[str, float]:
    """Each recorded CPU call again on ``device``, fed the CPU's inputs:
    the relative error of each function's result (the worst call)."""
    errs: dict[str, float] = {}
    with torch.inference_mode():
        for name, args, kw, want in calls:
            got = getattr(module_of(name), name)(*_to(args, device),
                                                  **_to(kw, device))
            errs[name] = max(errs.get(name, 0.0), rel_err(got, want))
    return errs


def _port_config(spec: dict):
    return getattr(module_of(spec["config"]), spec["config"])(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in spec["fields"].items()})


def _twin_values(name: str, shape: list[int], rng) -> np.ndarray:
    leaf = name.rsplit(".", 1)[-1]
    if ("ln" in leaf or "norm" in leaf) and not leaf.endswith("_b"):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if leaf.endswith("_b") or leaf[:1] == "b" and len(leaf) <= 6:
        return 0.02 * rng.standard_normal(shape)
    if len(shape) >= 2:
        return rng.standard_normal(shape) / math.sqrt(shape[-2])
    return 0.1 * rng.standard_normal(shape)


def twin_calls(name: str, seed: int = 0) -> list:
    """The twin's calls with random parameters and inputs, run on the CPU:
    (function, args, kwargs, result) each."""
    rng = np.random.default_rng(seed)

    def arg(spec):
        if "config" in spec:
            return _port_config(spec)
        if "array" in spec:
            return torch.from_numpy(
                rng.standard_normal(spec["array"]).astype(np.float32))
        if "value" in spec:
            v = spec["value"]
            return tuple(v) if isinstance(v, list) else v
        tree: dict = {}
        for key, shape in spec["params"].items():
            t = torch.from_numpy(
                _twin_values(key, shape, rng).astype(np.float32))
            if "." in key:
                top, leaf = key.split(".", 1)
                tree.setdefault(top, {})[leaf] = t
            else:
                tree[key] = t
        return tree

    out = []
    with torch.inference_mode():
        for call in STRUCTURES["twins"][name]:
            args = [arg(a) for a in call["args"]]
            kw = {k: arg(v) for k, v in call["kwargs"].items()}
            fn = getattr(module_of(call["fn"]), call["fn"])
            out.append((call["fn"], args, kw, fn(*args, **kw)))
    return out


# --- the splice --------------------------------------------------------------

def image_side(meta: dict) -> int:
    """The side of the square image a checkpoint's tower takes as is."""
    for key in ("vision_config", "siglip_config", "pixtral_config",
                "internvl_config", "llama4_vision_config", "idefics3_config",
                "glm4v_vision_config", "janus_config", "lfm2vl_config"):
        if key in meta:
            return meta[key]["image_size"]
    if "qwen3vl_vision_config" in meta:
        c = meta["qwen3vl_vision_config"]
        return c["pos_grid"] * c["patch_size"]
    c = meta["qwen_vision_config"]
    return 4 * c["patch_size"] * c["spatial_merge_size"]


def splice_run(model, cfg, embeds: torch.Tensor, n_decode: int,
               deepstack=None, mrope_pos=None, visual_expert: bool = False,
               feed: list | None = None) -> list[torch.Tensor]:
    """float32 logits (host) of one prefill over ``embeds`` (T, D) given as
    ``token_embeds`` [+ DeepStack planes, M-RoPE rows, cogvlm's visual
    experts], then ``n_decode`` cached decode steps fed ``feed[i]`` or the
    greedy token."""
    from vlut_tpu_torch.models import transformer as tt

    dev = model.device
    t = embeds.shape[0]
    cache = tt.init_kv_cache(cfg, 1, max_len=t + n_decode + 8, device=dev)
    planes = None if deepstack is None else tuple(
        p.to(dev)[None] for p in deepstack)
    with torch.inference_mode():
        lg, _ = tt.forward(
            model, cfg, torch.zeros((1, t), dtype=torch.long, device=dev),
            torch.arange(t, device=dev)[None], cache,
            token_embeds=embeds.to(dev)[None],
            logits_at=torch.tensor([t - 1], device=dev),
            deepstack_embeds=planes, visual_expert=visual_expert,
            mrope_pos=None if mrope_pos is None else mrope_pos.to(dev))
        out = [lg[:, 0, :cfg.vocab_size].float().cpu()]
        for i in range(n_decode):
            nxt = feed[i] if feed is not None else out[-1].argmax(-1)
            lg, _ = tt.forward(model, cfg, nxt.to(dev)[:, None],
                               torch.full((1, 1), t + i, device=dev), cache,
                               visual_expert=visual_expert)
            out.append(lg[:, 0, :cfg.vocab_size].float().cpu())
    return out


def splice_on(cpu_model, card_model, cfg, embeds, n_decode: int = 6,
              **kw) -> dict:
    """The splice on the card against the CPU, each layer fed the CPU's
    input (``bench/zoo.py:layers_replaced``) and the decode the CPU's
    greedy tokens: the worst relative logit and layer errors, whether the
    greedy tokens are the CPU's, and the CPU's tokens."""
    from vlut_tpu_torch.bench.zoo import TOL, _rel_errs, layers_replaced

    want_l, got_l = [], []
    with layers_replaced(want_l):
        want = splice_run(cpu_model, cfg, embeds, n_decode, **kw)
    feed = [w.argmax(-1) for w in want[:-1]]
    with layers_replaced(got_l, by=want_l):
        got = splice_run(card_model, cfg, embeds, n_decode, feed=feed, **kw)
    errs, layer = _rel_errs(got, want), _rel_errs(got_l, want_l)
    return {"max_rel_logit_err": max(errs), "max_rel_layer_err": max(layer),
            "within_tol": max(errs + layer) <= TOL,
            "greedy_equal": all(torch.equal(g.argmax(-1), w.argmax(-1))
                                for g, w in zip(got, want)),
            "tokens": [int(w.argmax(-1)[0]) for w in want]}


def _serving(ckpt: pathlib.Path, device):
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models import transformer as tt

    cfg, model, _ = load_checkpoint(ckpt, device=device)
    if not isinstance(model, tt.TransformerLM):
        return cfg, model
    return cfg, tt.unstack_layers(tt.fuse_projections(model, cfg), cfg)


def _source_case(name: str, device, seed: int, counters) -> dict:
    from vlut_tpu_torch.config import ModelConfig
    from vlut_tpu_torch.convert.convert import convert_hf
    from vlut_tpu_torch.models.qwen_vision import mrope_positions
    from vlut_tpu_torch.models.vision import encode_image_auto

    out: dict = {"family": name}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = pathlib.Path(d)
        src = write_source(name, d / "hf", seed)
        convert_hf(src, d / "card", device=device)
        convert_hf(src, d / "cpu", device="cpu")
        out["differing"] = same_outputs(d / "card", d / "cpu")
        meta = json.loads((d / "cpu" / "vlut_config.json").read_text())
        embeds = deepstack = grid = None
        if name != "cogvlm":
            side = image_side(meta)
            img = np.random.default_rng(seed).random((side, side, 3)).astype(
                np.float32)
            calls: list = []
            with recorded(calls), torch.inference_mode():
                embeds, fam = encode_image_auto(d / "cpu", img, device="cpu")
            out["tower"] = fam if isinstance(fam, str) else fam[0]
            if isinstance(fam, tuple):
                deepstack = fam[1]
            out["tower_rel_err"] = towers_on(calls, device)
            for key, mk in (("qwen_vision_config", "spatial_merge_size"),
                            ("qwen3vl_vision_config", "merge")):
                if key in meta:
                    grid = (side // meta[key]["patch_size"],) * 2
                    merge = meta[key][mk]
        try:
            cfg, cpu = _serving(d / "cpu", "cpu")
        except (ValueError, NotImplementedError) as e:
            cfg, skipped = None, f"text side refused: {e}"
        else:
            skipped = (
                "text side not a transformer" if not isinstance(
                    cfg, ModelConfig)
                else "tower and text widths differ" if embeds is not None
                and embeds.shape[-1] != cfg.d_model else None)
        out["splice"], out["splice_skipped"] = None, skipped
        if skipped is None:
            rng = np.random.default_rng(seed + 1)
            pre = rng.integers(3, cfg.vocab_size, 5).tolist()
            post = rng.integers(3, cfg.vocab_size, 4).tolist()
            if embeds is None:  # cogvlm: its visual pass over text rows
                emb = cpu.embed[torch.tensor(pre + post)]
                kw = {"visual_expert": True}
            else:
                from vlut_tpu_torch.models.vision import (
                    build_multimodal_embeds)

                emb = build_multimodal_embeds(cpu, embeds, pre, post)
                kw = {}
                n_img = embeds.shape[0]
                if deepstack is not None:
                    kw["deepstack"] = []
                    for f in deepstack:
                        plane = torch.zeros((emb.shape[0], emb.shape[1]))
                        plane[len(pre):len(pre) + n_img] = f.float()
                        kw["deepstack"].append(plane)
                if grid is not None and (cfg.rope_scaling or {}).get(
                        "mrope_section"):
                    kw["mrope_pos"] = torch.from_numpy(mrope_positions(
                        len(pre), grid, merge, len(post)))[None]
            _, card = _serving(d / "card", device)
            if counters is not None:
                counters[0]()
            out["splice"] = splice_on(cpu, card, cfg, emb, **kw)
            if counters is not None:
                out["launches"] = counters[1](
                    f"vision_{name}", splice_kernels(cfg, card, len(emb)))
    errs = list(out.get("tower_rel_err", {}).values())
    out["ok"] = (not out["differing"] and all(e <= FLOAT_TOL for e in errs)
                 and (skipped is None) == (name not in NO_SPLICE)
                 and (out["splice"] is None or (
                     out["splice"]["within_tol"]
                     and out["splice"]["greedy_equal"])))
    return out


def splice_kernels(cfg, model, rows: int) -> tuple[str, ...]:
    """The kernels a splice of a ``rows``-row prefill and its decode steps
    must launch on the card: ``bench/zoo.py:expected_kernels``, less the
    tiled GEMM (#3) where the prefill is short enough for the decode
    GEMMs."""
    from vlut_tpu_torch.bench.zoo import expected_kernels
    from vlut_tpu_torch.ops.ternary_gemm import MAX_DECODE_M

    return tuple(k for k in expected_kernels(cfg, model)
                 if k != "ternary_gemm_tiled" or rows > MAX_DECODE_M)


def card_vs_cpu(name: str, device, counters=None, seed: int = 0) -> dict:
    """One family on ``device`` against the CPU.  A source: written from
    the seed, converted on both (every file equal), encoded on the CPU
    through ``encode_image_auto`` with each tower function's call replayed
    on the card from the CPU's inputs (within :data:`FLOAT_TOL`), then the
    CPU's embeddings spliced into the language model on both (each layer
    fed the CPU's input, logits within ``bench/zoo.py:TOL``, the CPU's
    greedy tokens); cogvlm's visual-expert pass the same way.  A twin: its
    calls with random weights on the CPU, replayed on the card.
    A source in :data:`NO_SPLICE` must skip its splice and every other
    source must run it.  ``counters`` (reset, read) brackets the card's
    splice, which must launch :func:`splice_kernels`."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    (ROOT / "build").mkdir(exist_ok=True)
    if name in SOURCES:
        out = _source_case(name, dev, seed, counters)
    else:
        errs = towers_on(twin_calls(name, seed), dev)
        out = {"family": name, "tower_rel_err": errs,
               "ok": all(e <= FLOAT_TOL for e in errs.values())}
    out["seconds"] = time.perf_counter() - t0
    return out


# --- LLaVA-1.5-7B at full width ------------------------------------------------

def llava_1_5_7b():
    """(VisionConfig, text ModelConfig) at llava-hf/llava-1.5-7b-hf's
    widths: CLIP ViT-L/14-336 (feature layer -2, the default strategy: 576
    patch rows), a 1024 -> 4096 -> 4096 projector, Llama-2-7B's text."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.vision import VisionConfig

    return VisionConfig(d_llm=4096), PRESETS["llava_1_5_7b"]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench."
                                 "vision_zoo")
    ap.add_argument("--family", action="append", choices=FAMILIES)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    for name in args.family or FAMILIES:
        print(json.dumps(card_vs_cpu(name, args.device)), flush=True)


if __name__ == "__main__":
    main()
