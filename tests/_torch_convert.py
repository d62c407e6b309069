"""Shared checks of the port's HF converter against the JAX converter
(imported by ``tests/test_torch_convert*.py``).

Every case feeds one HF directory to both converters: the JAX
``convert_hf`` into one output, the port's (on the CPU) into another.  The
two checkpoints must be equal array for array (name, dtype, shape and
bytes, after each package reads its own safetensors file),
``vlut_config.json`` equal as parsed JSON, and the copied tokenizer files
equal byte for byte; ``config_from_hf`` of both packages equal field for
field.  :func:`jax_source` runs a JAX test up to its ``nth`` ``convert_hf``
call and returns the HF directory it handed over.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from typing import Any

import numpy as np
import torch

torch.set_num_threads(1)

_TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "tokenizer.model",
    "special_tokens_map.json", "vocab.json", "merges.txt",
    "generation_config.json",
)


class _Handed(Exception):
    pass


# the JAX package's converter modules, where a test may find a converter
_CONVERTER_MODULES = ("convert", "t5", "gemma3n", "encoder", "rwkv", "hybrid")


def jax_source(test_fn, tmp_path, monkeypatch, nth: int = 0,
               converter: str = "convert_hf"
               ) -> tuple[pathlib.Path, dict[str, Any]]:
    """Run a JAX test (or a ``functools.partial`` of a parametrized one) up
    to its ``nth`` call of ``converter`` (from 0): the source directory
    that call was handed, and its keyword arguments.  The converter is
    replaced in the test's module and in the JAX package's converter
    modules (a test may import it in its body).  The JAX test's earlier
    calls convert as they would."""
    import importlib

    mod = sys.modules[getattr(test_fn, "func", test_fn).__module__]
    homes = [importlib.import_module(f"vlut_tpu.convert.{m}")
             for m in _CONVERTER_MODULES]
    owners = [m for m in (*homes, mod) if hasattr(m, converter)]
    real = getattr(owners[-1], converter)
    seen: list[tuple[pathlib.Path, dict[str, Any]]] = []

    def record(src, dst, **kw):
        seen.append((pathlib.Path(src), kw))
        if len(seen) > nth:
            raise _Handed
        return real(src, dst, **kw)

    for owner in owners:
        monkeypatch.setattr(owner, converter, record)
    try:
        test_fn(tmp_path)
    except _Handed:
        pass
    for owner in owners:
        monkeypatch.setattr(owner, converter, real)
    return seen[nth]


def jax_arrays(ckpt: pathlib.Path) -> dict[str, np.ndarray]:
    from safetensors.numpy import load_file

    return load_file(str(ckpt / "model.safetensors"))


def port_arrays(ckpt: pathlib.Path) -> dict[str, np.ndarray]:
    from vlut_tpu_torch.convert.checkpoint import safetensors_arrays

    return safetensors_arrays(ckpt / "model.safetensors")


def assert_same_checkpoint(a: pathlib.Path, b: pathlib.Path) -> bool:
    """``a`` (the JAX converter's) and ``b`` (the port's) hold the same
    arrays (the vision sidecars' too), metadata and tokenizer files; returns whether the two
    safetensors files are equal byte for byte as well."""
    ja, pb = jax_arrays(a), port_arrays(b)
    assert sorted(ja) == sorted(pb), (sorted(set(ja) ^ set(pb)))
    for k in ja:
        x, y = ja[k], pb[k]
        assert (x.dtype, x.shape) == (y.dtype, y.shape), (k, x.dtype,
                                                          x.shape, y.dtype,
                                                          y.shape)
        if x.tobytes() != y.tobytes():
            bad = np.flatnonzero(x.reshape(-1).view(np.uint8)
                                 != y.reshape(-1).view(np.uint8))
            raise AssertionError(f"{k}: {bad.size} bytes differ, first at "
                                 f"{bad[:4]}")
    sidecars = sorted(f.name for f in a.glob("*.safetensors")
                      if f.name != "model.safetensors")
    assert sidecars == sorted(f.name for f in b.glob("*.safetensors")
                              if f.name != "model.safetensors")
    for f in sidecars:  # the vision towers' files, array for array
        from safetensors.numpy import load_file
        from vlut_tpu_torch.convert.checkpoint import safetensors_arrays

        x, y = load_file(str(a / f)), safetensors_arrays(b / f)
        assert sorted(x) == sorted(y), (f, sorted(set(x) ^ set(y)))
        for k in x:
            assert (x[k].dtype, x[k].shape) == (y[k].dtype, y[k].shape), (
                f, k)
            assert x[k].tobytes() == y[k].tobytes(), (f, k)
    ma = json.loads((a / "vlut_config.json").read_text())
    mb = json.loads((b / "vlut_config.json").read_text())
    assert ma == mb, {k: (ma.get(k), mb.get(k)) for k in set(ma) | set(mb)
                      if ma.get(k) != mb.get(k)}
    for f in _TOKENIZER_FILES:
        assert (a / f).exists() == (b / f).exists(), f
        if (a / f).exists():
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
    return ((a / "model.safetensors").read_bytes()
            == (b / "model.safetensors").read_bytes())


def assert_same_config(src: pathlib.Path) -> None:
    """``config_from_hf`` of both packages, field for field."""
    from vlut_tpu.convert.convert import config_from_hf as jax_cfg
    from vlut_tpu_torch.convert.convert import config_from_hf

    a = dataclasses.asdict(jax_cfg(src))
    b = dataclasses.asdict(config_from_hf(src))
    assert a == b, {k: (a[k], b[k]) for k in a if a[k] != b[k]}


def convert_both(src: pathlib.Path, tmp_path: pathlib.Path, fmt: str = "i2",
                 config: bool = True, **kw) -> pathlib.Path:
    """Convert ``src`` with both converters (the port on the CPU), hold the
    outputs equal (and ``config_from_hf`` where ``config``: the families
    the transformer path takes), and return the port's output."""
    from vlut_tpu.convert.convert import convert_hf as jax_convert
    from vlut_tpu_torch.convert.convert import convert_hf

    a, b = tmp_path / "conv_jax", tmp_path / "conv_port"
    cfg_a = jax_convert(src, a, fmt=fmt, **kw)
    cfg_b = convert_hf(src, b, fmt=fmt, device="cpu", **kw)
    assert type(cfg_a).__name__ == type(cfg_b).__name__
    assert dataclasses.asdict(cfg_a) == dataclasses.asdict(cfg_b)
    assert_same_checkpoint(a, b)
    if config:
        assert_same_config(src)
    return b


def hf_source(make, seed: int, tmp_path: pathlib.Path,
              ternarize=None, dtype=torch.float32) -> pathlib.Path:
    """An HF model built in code (``make``, torch seed ``seed``) with
    exact-ternary projections (``ternarize``: the functions that make them
    so; () for none), saved in ``dtype`` as ``tmp_path / "hf"`` the way
    ``_torch_archs.hf_case`` saves it for the JAX converter."""
    from test_archs_hf import _ternarize_model as ternarize_a
    from test_archs_hf2 import _ternarize_model as ternarize_b

    torch.manual_seed(seed)
    model = make().float().eval()
    for tern in (ternarize_a, ternarize_b) if ternarize is None else ternarize:
        tern(model)
    model.to(dtype).save_pretrained(str(tmp_path / "hf"),
                                    safe_serialization=True)
    return tmp_path / "hf"


def forward_case(port_out: pathlib.Path, t: int = 5, b: int = 2,
                 seed: int = 3, jax_cached: bool | None = None):
    """The port's checkpoint loaded by the port, held against the JAX
    forward of the JAX converter's checkpoint (``conv_jax`` beside it) as
    ``_torch_archs.checkpoint_case`` holds them: prefill and cached greedy
    decode, within ``_torch_archs.TOL`` of the largest logit, greedy
    tokens equal.  Returns the port's cfg."""
    import jax
    import jax.numpy as jnp
    from _torch_archs import (check_pair, jax_cache_reads_own_heads,
                              per_tensor_scales)

    from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models import transformer as tt

    cfg_j, params, _ = jax_load(port_out.parent / "conv_jax")
    params = jax.tree.map(jnp.asarray, per_tensor_scales(params))
    cfg, model, meta = load_checkpoint(port_out, device="cpu")
    assert meta["ternarized_tensors"] == 0, "conversion must be lossless"
    tt.check_supported(cfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    cached = (jax_cache_reads_own_heads(cfg_j) if jax_cached is None
              else jax_cached)
    check_pair(cfg_j, params, cfg, model, tokens, n_decode=2,
               max_len=t + 8, jax_cached=cached)
    return cfg


def ssm_forward_case(port_out: pathlib.Path, monkeypatch, t: int = 9,
                     seed: int = 3) -> None:
    """A Mamba / Mamba2 checkpoint of the port, loaded by the port, held
    against the JAX forward of the JAX converter's (``conv_jax`` beside
    it), its ternary products through the interpreted Pallas kernels:
    logits within ``_torch_recurrent.TOL`` of the largest, greedy tokens
    equal."""
    import jax.numpy as jnp
    from _torch_recurrent import both, close

    from vlut_tpu.models import ssm as js
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models import ssm as ps

    monkeypatch.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
    cfg_j, pj, _, _ = both(port_out.parent / "conv_jax")
    cfg, model, _ = load_checkpoint(port_out, device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, t))
    two = isinstance(cfg, ps.Mamba2Config)
    want, _ = (js.forward2 if two else js.forward)(
        pj, cfg_j, jnp.asarray(toks, jnp.int32))
    got, _ = (ps.forward2 if two else ps.forward)(model, cfg,
                                                  torch.from_numpy(toks))
    close(got, want, type(cfg).__name__)


FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"


class _Records:
    """(logger name past its package, message) of every warning logged
    under ``<package>.convert`` while the scope is open."""

    def __init__(self, package: str):
        import logging

        self.log = logging.getLogger(f"{package}.convert")
        self.package = package
        self.got: list[tuple[str, str]] = []
        outer = self

        class _H(logging.Handler):
            def emit(self, record):
                if record.levelno >= logging.WARNING:
                    outer.got.append((record.name[len(package):],
                                      record.getMessage()))

        self.handler = _H()

    def __enter__(self):
        self.log.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)


def to_bf16(src: pathlib.Path) -> None:
    """Rewrite every shard of ``src`` with its float tensors stored as BF16
    (each float32 value rounded to nearest even)."""
    from vlut_tpu_torch.convert.checkpoint import (safetensors_arrays,
                                                   write_safetensors)

    for f in sorted(src.glob("*.safetensors")):
        arrays = safetensors_arrays(f)
        bf16 = set()
        for name, a in arrays.items():
            if a.dtype in (np.float32, np.float16):
                arrays[name] = torch.from_numpy(a.astype(np.float32)).to(
                    torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
                bf16.add(name)
        write_safetensors(f, arrays, frozenset(bf16))


def add_tensors(src: pathlib.Path, names: list[str]) -> None:
    """Add a small float32 tensor under each of ``names`` to the first
    shard of ``src``."""
    from vlut_tpu_torch.convert.checkpoint import (safetensors_arrays,
                                                   write_safetensors)

    f = sorted(src.glob("*.safetensors"))[0]
    arrays = safetensors_arrays(f)
    for i, name in enumerate(names):
        arrays[name] = np.full((2, 3), i, np.float32)
    write_safetensors(f, arrays)


def family_case(test_fn, tmp_path, monkeypatch, nth: int = 0,
                converter: str = "convert_hf", bf16: bool = False,
                extra: list[str] = (), prepare=None
                ) -> tuple[pathlib.Path, list]:
    """A JAX family test's source (``jax_source``; tiny_real's tokenizer
    files copied beside it, ``prepare(src)`` applied where given, the
    tensors named in ``extra`` added, its floats stored as BF16 where
    ``bf16``) converted by the JAX
    ``convert_hf`` and the port's (on the CPU): equal configs, arrays,
    metadata and tokenizer files (:func:`convert_both`), and the same
    warnings, in the same order, from the same converter module.  Returns
    the port's output and its warnings."""
    import shutil

    src, kw = jax_source(test_fn, tmp_path, monkeypatch, nth, converter)
    for f in _TOKENIZER_FILES:
        if (FIXTURE / f).exists() and not (src / f).exists():
            shutil.copy(FIXTURE / f, src / f)
    if prepare is not None:
        prepare(src)
    if extra:
        add_tensors(src, list(extra))
    if bf16:
        to_bf16(src)
    with _Records("vlut_tpu") as ja, _Records("vlut_tpu_torch") as po:
        out = convert_both(src, tmp_path, config=False, **kw)
    assert ja.got == po.got, (ja.got, po.got)
    return out, po.got
