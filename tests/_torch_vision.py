"""Shared checks of the port's vision towers against the JAX package's
(imported by ``tests/test_torch_vision*.py``).

:func:`recorded` runs a JAX vision test to its end with the named JAX tower
functions wrapped: each call's arguments and result are kept.
:func:`replay` then calls the port's function of the same name on the same
arguments (numpy / JAX arrays as torch tensors, each JAX config as the
port's config of the same name and fields) and holds its result to the JAX
result within ``tol`` of the largest magnitude.  So every tower and
projector is held on the parameters and inputs the JAX test itself builds,
each function fed the JAX function's own input.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
import sys
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.bench.vision_zoo import TOWER_FNS, module_of, rel_err
from vlut_tpu_torch.convert.from_jax import to_tensor, tower_from_numpy

torch.set_num_threads(1)

# float32 towers: the port's result within this share of the largest
# magnitude of the JAX result (float rounding: XLA's and torch's kernels
# sum and evaluate exp / tanh / erf in different orders)
TOL_F32 = 2e-6
# bf16 towers (the CLIP / llava path from a checkpoint): two bf16 steps of
# the largest magnitude (2 * 2^-8)
TOL_BF16 = 2 ** -7

_JAX_MODULES = ("vision", "vision_ext", "vision_wave3", "qwen_vision")


def to_torch(x, device="cpu"):
    """JAX / numpy arrays -> tensors (bf16 kept bf16), configs -> the
    port's, containers walked."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        name = type(x).__name__
        return getattr(module_of(name), name)(**dataclasses.asdict(x))
    if isinstance(x, dict) and "layers" in x:
        # a tower tree, through the port's reader of JAX trees
        import jax

        return tower_from_numpy(jax.tree.map(np.asarray, x), device)
    if isinstance(x, dict):
        return {k: to_torch(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [to_torch(v, device) for v in x]
    if isinstance(x, tuple):
        return tuple(to_torch(v, device) for v in x)
    if hasattr(x, "shape") and hasattr(x, "dtype") and not np.isscalar(x):
        return to_tensor(np.asarray(x)).to(device)
    return x


def recorded(test_fn, tmp_path, monkeypatch, names: tuple[str, ...]
             ) -> list[tuple[str, tuple, dict, Any]]:
    """Run the JAX test ``test_fn`` (given ``tmp_path`` where it takes one)
    with the JAX tower functions ``names`` (or the transformer's
    ``forward``) wrapped; returns (name, args, kwargs, result) of every
    call, in order."""
    import inspect

    test_mod = sys.modules[test_fn.__module__]
    calls: list[tuple[str, tuple, dict, Any]] = []

    def wrap(name, real):
        def spy(*args, **kw):
            out = real(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return spy

    for name in names:
        for m in _JAX_MODULES + ("transformer",):
            mod = importlib.import_module(f"vlut_tpu.models.{m}")
            if hasattr(mod, name):
                real = getattr(mod, name)
                monkeypatch.setattr(mod, name, wrap(name, real))
                if getattr(test_mod, name, None) is real:
                    monkeypatch.setattr(test_mod, name, getattr(mod, name))
                break
        else:
            raise KeyError(name)
    if inspect.signature(test_fn).parameters:
        test_fn(tmp_path)
    else:
        test_fn()
    return calls


def replay(calls, tol: float = TOL_F32, device="cpu") -> None:
    """Each recorded call through the port's function of the same name on
    the same arguments, its result within ``tol`` of the JAX result."""
    assert calls, "the JAX test made no tower call"
    for name, args, kw, want in calls:
        with torch.inference_mode():
            got = getattr(module_of(name), name)(*to_torch(args, device),
                                                 **to_torch(kw, device))
        compare(got, want, tol, name)


def compare(got, want, tol: float, what: str) -> float:
    """``bench/vision_zoo.py:rel_err`` of ``got`` against the JAX / numpy
    ``want`` (lists walked, of equal lengths), asserted <= ``tol``."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
    err = rel_err(got, to_torch(want))
    assert err <= tol, (what, err, tol)
    return err


def replay_forward(calls, tol: float) -> None:
    """Each recorded JAX ``forward`` call again through the port's
    ``forward``: a model built from the same parameter tree
    (``params_from_numpy``), the same tokens and positions, a fresh cache
    where the JAX call had one, and the same ``token_embeds``,
    ``mrope_pos``, ``attn_mask``, ``deepstack_embeds``, ``visual_expert``
    and ``logits_at``.  ``impl="dequant"`` stays; the JAX "xla" / Pallas
    impls are the port's "auto"; the logits within ``tol``."""
    import jax

    from vlut_tpu_torch.config import ModelConfig
    from vlut_tpu_torch.convert.from_jax import params_from_numpy
    from vlut_tpu_torch.models import transformer as tt

    assert calls, "the JAX test made no forward call"
    for _, args, kw, want in calls:
        params, cfg_j, tokens, positions = args[:4]
        cache = args[4] if len(args) > 4 else kw.get("kv_cache")
        cfg = ModelConfig(**dataclasses.asdict(cfg_j))
        model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
        toks = to_torch(tokens).long()
        pos = to_torch(positions).long()
        pc = (tt.init_kv_cache(cfg, toks.shape[0], max_len=64)
              if cache is not None else None)
        extra = {k: to_torch(kw[k]) for k in (
            "token_embeds", "mrope_pos", "attn_mask", "deepstack_embeds",
            "visual_expert", "logits_at") if k in kw}
        with torch.inference_mode():
            got, _ = tt.forward(model, cfg, toks, pos, pc,
                                impl="dequant" if kw.get("impl") == "dequant"
                                else "auto", **extra)
        compare(got, want[0], tol, "forward")


# the JAX package's tower and projector functions: the port's, with JAX's
# ``encode_image`` (tower and projector in one) where the port records its
# tower alone
TOWERS = tuple("encode_image" if n == "encode_tower" else n
               for n in TOWER_FNS)


def tower_case(module: str, test: str, tmp_path, monkeypatch) -> list:
    """Every tower call of the JAX test ``module::test`` replayed through
    the port (bf16 towers within ``TOL_BF16``, float32 ones within
    ``TOL_F32``); returns the calls."""
    fn = getattr(importlib.import_module(module), test)
    calls = recorded(fn, tmp_path, monkeypatch, TOWERS)
    for call in calls:
        bf16 = any(getattr(a, "dtype", None) is not None
                   and np.asarray(a).dtype.name == "bfloat16"
                   for a in _leaves(call[1]))
        replay([call], TOL_BF16 if bf16 else TOL_F32)
    return calls


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


# --- bench/vision_families.json: the families of the card's vision zoo ----

# the JAX tests whose HF source (their first convert_hf) the card's zoo
# fills with random values: zoo name -> (module, test)
ZOO_SOURCES = {
    "llava": ("test_vision", "test_convert_llava_roundtrip"),
    "gemma3": ("test_vision_ext", "test_gemma3_vision_parity"),
    "pixtral": ("test_vision_ext", "test_pixtral_parity"),
    "mistral3": ("test_vision_wave3", "test_mistral3_patch_merger_parity"),
    "internvl": ("test_vision_wave3", "test_internvl_vision_parity"),
    "llama4": ("test_vision_wave3", "test_llama4_vision_parity"),
    "idefics3": ("test_vision_wave3", "test_idefics3_parity"),
    "glm4v": ("test_vision_wave3", "test_glm4v_end_to_end_convert"),
    "janus": ("test_vision_wave3", "test_janus_pro_parity"),
    "lfm2_vl": ("test_vision_wave3", "test_lfm2_vl_parity"),
    "qwen3vl": ("test_vision_wave3", "test_qwen3vl_vision_converter_route"),
    "qwen2vl": ("test_qwen2vl", "test_qwen2vl_image_parity"),
    "qwen25vl": ("test_qwen2vl", "test_qwen25vl_image_parity"),
    "cogvlm": ("test_archs_wave5", "test_cogvlm_dual_expert"),
}
# the JAX tests whose towers have no converter (twins, the MLP_NORM
# projector, the resampler): zoo name -> (module, test)
ZOO_TWINS = {
    "llava_mlp_norm": ("test_vision", "test_mlp_norm_projector_variant"),
    "minicpmv": ("test_vision_ext", "test_minicpmv_resampler_torch_reference"),
    "kimivl": ("test_vision_wave3", "test_kimivl_twin"),
    "ldp": ("test_vision_wave3", "test_ldp_and_ldpv2_twins"),
    "glm_edge": ("test_vision_wave3", "test_glm_edge_adapter_twin"),
    "cogvlm_tower": ("test_vision_wave3", "test_cogvlm_vision_twin"),
    "youtuvl": ("test_vision_wave3", "test_youtuvl_vision_twin"),
}


def _spec(x):
    """A recorded argument as JSON: a tower tree as {dotted name: shape},
    a config as its class and fields, an array as its shape."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"config": type(x).__name__, "fields": dataclasses.asdict(x)}
    if isinstance(x, dict):
        flat = {}
        for k, v in x.items():
            if isinstance(v, dict):
                flat.update({f"{k}.{n}": list(np.shape(a))
                             for n, a in v.items()})
            else:
                flat[k] = list(np.shape(v))
        return {"params": flat}
    if hasattr(x, "shape") and not np.isscalar(x):
        return {"array": list(x.shape)}
    return {"value": list(x) if isinstance(x, tuple) else x}


def families(tmp_path, monkeypatch) -> dict:
    """The zoo's families from the JAX tests: each source's config.json
    and tensor shapes and dtypes, and each twin's tower calls (function,
    arguments as :func:`_spec` gives them)."""
    from _torch_convert import jax_source

    from vlut_tpu_torch.convert.checkpoint import safetensors_open

    out: dict = {"sources": {}, "twins": {}}
    for name, (mod, test) in ZOO_SOURCES.items():
        fn = getattr(importlib.import_module(mod), test)
        (tmp_path / name).mkdir()
        src, _ = jax_source(fn, tmp_path / name, monkeypatch)
        tensors = {}
        for f in sorted(src.glob("*.safetensors")):
            header = safetensors_open(f)[1]
            tensors.update({k: [v["shape"], v["dtype"]]
                            for k, v in header.items()})
        out["sources"][name] = {
            "config": json.loads((src / "config.json").read_text()),
            "tensors": tensors}
    for name, (mod, test) in ZOO_TWINS.items():
        fn = getattr(importlib.import_module(mod), test)
        (tmp_path / name).mkdir()
        calls = recorded(fn, tmp_path / name, monkeypatch, TOWERS)
        seen, specs = set(), []
        for fname, args, kw, _ in calls:
            if fname in seen:
                continue
            seen.add(fname)
            specs.append({"fn": fname, "args": [_spec(a) for a in args],
                          "kwargs": {k: _spec(v) for k, v in kw.items()}})
        out["twins"][name] = specs
    return out


FAMILIES_FILE = (pathlib.Path(__file__).resolve().parents[1] / "vlut_tpu_torch"
                 / "bench" / "vision_families.json")


def write_families() -> None:
    """Write ``bench/vision_families.json`` afresh (after a JAX test's
    source or a converter changes)."""
    import tempfile

    import pytest

    with tempfile.TemporaryDirectory() as d:
        mp = pytest.MonkeyPatch()
        try:
            data = families(pathlib.Path(d), mp)
        finally:
            mp.undo()
    FAMILIES_FILE.write_text(json.dumps(data, indent=1, sort_keys=True)
                             + "\n")
