"""Shared checks of the port's recurrent families against the JAX package
(imported by ``tests/test_torch_ssm*.py``, ``test_torch_rwkv.py`` and
``tests/test_torch_hybrid*.py``).

The JAX tests of these families (``tests/test_ssm.py``,
``test_mamba2.py``, ``test_rwkv7.py``, ``test_hybrid.py``,
``test_archs_wave6.py``) build a checkpoint (an HF model made in code, or
HF-named tensors written from numpy) and convert it with the JAX
converter; :func:`loaded_by` runs such a test up to its ``nth``
``load_checkpoint`` and returns that checkpoint's directory, which both
packages then load.  Logits are held within :data:`TOL` of the largest
(the transcendentals, exp / tanh / sigmoid, round apart from XLA's by an
ulp), greedy tokens equal.
"""

from __future__ import annotations

import functools
import sys
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

TOL = 2e-2


class _Loaded(Exception):
    pass


def loaded_by(test_fn, tmp_path, monkeypatch, nth: int = 0) -> Any:
    """Run a JAX test up to its ``nth`` ``load_checkpoint`` call (from 0);
    returns the directory it was about to load."""
    import vlut_tpu.convert.checkpoint as ck

    mod = sys.modules[test_fn.__module__]
    real = ck.load_checkpoint
    seen = []

    def record(path, *a, **kw):
        seen.append(path)
        if len(seen) > nth:
            raise _Loaded
        return real(path, *a, **kw)

    owners = [ck] + ([mod] if hasattr(mod, "load_checkpoint") else [])
    for owner in owners:
        monkeypatch.setattr(owner, "load_checkpoint", record)
    try:
        test_fn(tmp_path)
    except _Loaded:
        pass
    for owner in owners:
        monkeypatch.setattr(owner, "load_checkpoint", real)
    return seen[nth]


def both(ckpt):
    """(JAX cfg, JAX params as jax arrays, port cfg, port model on the
    CPU) of one checkpoint."""
    from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint

    cfg_j, params, _ = jax_load(ckpt)
    cfg, model, _ = load_checkpoint(ckpt, device="cpu")
    assert type(cfg).__name__ == type(cfg_j).__name__
    return cfg_j, jax.tree.map(jnp.asarray, params), cfg, model


def close(got: torch.Tensor, want, what: str = "", tol: float = TOL,
          greedy: bool = True) -> float:
    """The largest difference over the largest value (at most ``tol``),
    and, with ``greedy``, equal argmaxes on the last axis."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= tol, (what, rel)
    if greedy:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                      err_msg=what)
    return rel


def mamba_cfgs(**kw):
    """A tiny Mamba config in both packages (d 64, 2 layers, state 8)."""
    import dataclasses

    from vlut_tpu.models import ssm as js
    from vlut_tpu_torch.models import ssm as ps

    fields = dict(vocab_size=96, d_model=64, n_layers=2, d_state=8,
                  d_conv=4, expand=2, max_seq_len=128) | kw
    cfg_j = js.MambaConfig(**fields)
    return cfg_j, ps.MambaConfig(**dataclasses.asdict(cfg_j))


def mamba_pair(seed: int = 0, **kw):
    """(JAX cfg, JAX params, port cfg, port model) of one tiny Mamba: the
    JAX ``init_params`` tree with the embedding scaled by 60, norms and D
    drawn from [0.5, 2) and an untied random head (``init_params`` alone
    makes a model whose greedy token repeats the last one)."""
    from vlut_tpu.models import ssm as js
    from vlut_tpu_torch.convert.from_jax import params_from_numpy

    cfg_j, cfg = mamba_cfgs(**kw)
    pj = js.init_params(cfg_j, seed=seed)
    rng = np.random.default_rng(seed + 5)
    layers = dict(pj["layers"])
    for name in ("norm", "D"):
        layers[name] = jnp.asarray(
            rng.uniform(0.5, 2.0, layers[name].shape), jnp.float32)
    pj = dict(pj, layers=layers, lm_head=jnp.asarray(
        rng.standard_normal((cfg_j.d_model, cfg_j.vocab_size)),
        jnp.float32), embed=jnp.asarray(
            np.asarray(pj["embed"], np.float32) * 60, jnp.bfloat16))
    return cfg_j, pj, cfg, params_from_numpy(jax.tree.map(np.asarray, pj),
                                             cfg)


def greedy_ref(cfg, model, prompt, n_new):
    """The port's hand-rolled greedy recurrence: an unpadded prefill from a
    zero state, then one-token steps."""
    from vlut_tpu_torch.models import ssm as ps

    state = ps.init_state(cfg, 1)
    with torch.inference_mode():
        lg, state = ps.forward(model, cfg, torch.tensor([prompt]), state,
                               logits_last_only=True)
        out = [int(lg[0, -1, :cfg.vocab_size].argmax())]
        for _ in range(n_new - 1):
            lg, state = ps.forward(model, cfg, torch.tensor([[out[-1]]]),
                                   state)
            out.append(int(lg[0, 0, :cfg.vocab_size].argmax()))
    return out


def jax_family_generate(params, cfg_j, ids: list[int], n: int) -> list[int]:
    """The JAX CLI's greedy ``generate`` loops (``vlut_tpu/cli.py``
    240-352): a hybrid recomputes the sequence per token, Mamba2 and RWKV
    carry their state."""
    from vlut_tpu.models import hybrid, rwkv, ssm

    name = type(cfg_j).__name__
    out: list[int] = []
    if name == "HybridConfig":
        for _ in range(n):
            lg = hybrid.forward(params, cfg_j,
                                jnp.asarray([ids + out], jnp.int32))
            out.append(int(jnp.argmax(lg[0, -1, :cfg_j.vocab_size])))
        return out
    if name == "Mamba2Config":
        def fwd(t, st):
            return ssm.forward2(params, cfg_j, t, st, logits_last_only=True)
        st = ssm.init_state2(cfg_j, 1)
    else:
        f = rwkv.forward6 if name == "Rwkv6Config" else rwkv.forward
        fwd = functools.partial(f, params, cfg_j)
        st = rwkv.init_state(cfg_j, 1)
    lg, st = fwd(jnp.asarray([ids], jnp.int32), st)
    for _ in range(n):
        out.append(int(jnp.argmax(lg[0, -1, :cfg_j.vocab_size])))
        lg, st = fwd(jnp.asarray([[out[-1]]], jnp.int32), st)
    return out


def family_case(test_fn, nth, tmp_path, monkeypatch, forward_j, forward_p,
                t: int = 9, seed: int = 3, zoo: str | None = None) -> tuple:
    """The checkpoint ``test_fn`` converts, loaded by both packages, and
    its logits over a (2, t) prompt held within :data:`TOL`; with ``zoo``,
    the checkpoint's layout is the recurrent zoo's entry of that name
    (``bench/recurrent_families.json``).  Returns (JAX cfg, JAX params,
    port cfg, port model)."""
    ck = loaded_by(test_fn, tmp_path, monkeypatch, nth)
    if zoo is not None:
        from vlut_tpu_torch.bench.recurrent_zoo import STRUCTURES

        assert structure(ck) == STRUCTURES[zoo], zoo
    cfg_j, pj, cfg, model = both(ck)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, t))
    want = forward_j(pj, cfg_j, jnp.asarray(toks, jnp.int32))
    got = forward_p(model, cfg, torch.from_numpy(toks))
    close(got, want, type(cfg).__name__)
    return cfg_j, pj, cfg, model


# the recurrent zoo's families (``vlut_tpu_torch/bench/recurrent_zoo.py``):
# which JAX test writes each checkpoint, and which of its loads
def _zoo_writers():
    import test_archs_wave6
    import test_hybrid
    import test_mamba2
    import test_rwkv7

    h = test_hybrid
    return {
        "mamba2": (test_mamba2.test_mamba2_parity, 0),
        "rwkv7": (test_rwkv7.test_rwkv7_forward_and_state_carry, 0),
        "arwkv7": (test_rwkv7.test_arwkv7_forward_and_state_carry, 0),
        "rwkv6": (test_rwkv7.test_rwkv6_forward_and_state_carry, 0),
        "jamba": (h.test_jamba_parity, 0),
        "falcon_h1": (h.test_falcon_h1_parity, 0),
        "falcon_h1_rmsnorm": (h.test_falcon_h1_rmsnorm_parity, 0),
        "granite_hybrid": (h.test_granite_hybrid_parity, 0),
        "lfm2": (h.test_lfm2_parity, 0),
        "qwen3next": (h.test_qwen3next_dense_parity, 0),
        "qwen3next_moe": (h.test_qwen3next_moe_parity, 0),
        "nemotron_h": (h.test_nemotron_h_mamba_twin, 2),
        "plamo2": (h.test_plamo2_transcription, 0),
        "lfm2moe": (test_archs_wave6.test_lfm2moe_parity, 0),
        "nemotron_h_moe": (test_archs_wave6.test_nemotron_h_moe_transcription,
                           0),
    }


def structure(ckpt) -> dict:
    """A converted checkpoint's family, config and tensor shapes, as
    ``recurrent_zoo.STRUCTURES`` keeps them (flat keys, list layers by
    index)."""
    import dataclasses
    import json

    from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load

    cfg, params, meta = jax_load(ckpt)
    flat = {}

    def walk(node, prefix):
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node))
        for k, v in items:
            if isinstance(v, (dict, list, tuple)):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = list(np.shape(v))
    walk(params, "")
    config = json.loads(json.dumps(dataclasses.asdict(cfg)))
    return {"family": meta["model_family"], "config": config,
            "tensors": dict(sorted(flat.items()))}
