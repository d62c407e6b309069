"""The denoise loop's commit order and draws, and the non-causal MoE
(llada_moe) against the JAX package.

Tied confidences commit the lowest positions first, as ``jax.lax.top_k``
does (a stub forward whose every row has the same top probability, its
token a function of the masked count, so the order shows in the output).
``alg="random"`` and ``temp > 0`` draw from a ``torch.Generator`` where the
JAX package draws from threefry: one seed repeats its tokens, and over
many seeds the draws follow the distribution (four standard deviations of
a binomial share).  llada_moe's bidirectional softmax MoE without renorm
(``tests/test_archs_clones2.py::test_llada_moe_equals_qwen3_moe_
bidirectional``'s checkpoint) gives the JAX logits (packed within 2e-2,
float twin with dense experts within 1e-5) and the JAX loop's tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_archs_clones2
from _torch_archs import close
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import transformer as jt
from vlut_tpu.runtime.diffusion import (DiffusionParams as JaxDP,
                                        diffusion_generate as jax_diffusion)
from vlut_tpu.train.finetune import float_twin_params as jax_twin
from vlut_tpu_torch.convert import checkpoint as pck
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.runtime.diffusion import (DiffusionParams,
                                              diffusion_generate)
from vlut_tpu_torch.train.finetune import float_twin_params

torch.set_num_threads(1)
V, MASK = 16, 15


@dataclasses.dataclass(frozen=True)
class _Cfg:
    vocab_size: int = V
    mask_token_id: int = MASK
    diffusion_shift_logits: bool = False


class _Stub:
    device = torch.device("cpu")


def _jax_stub(step: int):
    """Row i's logits: 5 at token (i + step * masked) % (V - 1), 0
    elsewhere: every row has the same top probability."""
    def fwd(params, cfg, toks, pos, cache, attn_mask=None):
        n = jnp.sum(toks[0] == MASK)
        t = toks.shape[1]
        hot = (jnp.arange(t) + step * n) % (V - 1)
        return 5.0 * jax.nn.one_hot(hot, V)[None], None
    return fwd


def _port_stub(step: int):
    def fwd(model, cfg, toks, pos, cache, attn_mask=None):
        n = int((toks[0] == MASK).sum())
        t = toks.shape[1]
        hot = (torch.arange(t) + step * n) % (V - 1)
        return 5.0 * torch.nn.functional.one_hot(hot, V).float()[None], None
    return fwd


@pytest.mark.parametrize("alg", ["low_confidence", "margin"])
def test_tied_confidences_commit_in_jax_order(alg):
    dp = dict(steps=3, alg=alg)
    want = jax_diffusion({}, _Cfg(), [1, 2], 6, JaxDP(**dp),
                         forward_fn=_jax_stub(3))
    got = diffusion_generate(_Stub(), _Cfg(), [1, 2], 6,
                             DiffusionParams(**dp), forward_fn=_port_stub(3))
    assert got == want
    # two positions a step, lowest first, while 6, 4 and 2 were masked
    assert got == [(pos + 3 * n) % (V - 1)
                   for pos, n in zip(range(2, 8), (6, 6, 4, 4, 2, 2))]


def _share(xs, p, what):
    n = len(xs)
    f = sum(xs) / n
    assert abs(f - p) <= 4 * np.sqrt(p * (1 - p) / n) + 1e-9, (what, f, p)


def test_random_order_by_distribution():
    """``alg="random"``: which of two masked positions commits first is a
    fair coin; one seed repeats."""
    firsts = []
    for seed in range(600):
        out = diffusion_generate(_Stub(), _Cfg(), [1], 2,
                                 DiffusionParams(steps=2, alg="random",
                                                 seed=seed),
                                 forward_fn=_port_stub(7))
        # committed first with 2 masked: token (pos + 14) % 15
        firsts.append(out[0] == (1 + 14) % 15)
        if seed < 3:
            assert out == diffusion_generate(
                _Stub(), _Cfg(), [1], 2,
                DiffusionParams(steps=2, alg="random", seed=seed),
                forward_fn=_port_stub(7))
    _share(firsts, 0.5, "random order")
    # the JAX loop's draw (threefry's) gives one of the same two orders
    out = jax_diffusion({}, _Cfg(), [1], 2, JaxDP(steps=2, alg="random"),
                        forward_fn=_jax_stub(7))
    assert out in ([0, 9], [8, 1])


def test_temperature_draws_by_distribution():
    """``temp > 0``: the committed token follows softmax(logits / temp)."""
    lg = torch.tensor([2.0, 1.0, 0.5] + [-30.0] * (V - 3))

    def fwd(model, cfg, toks, pos, cache, attn_mask=None):
        return lg.expand(1, toks.shape[1], V).clone(), None

    draws = [diffusion_generate(_Stub(), _Cfg(), [1], 1,
                                DiffusionParams(steps=1, temp=0.7,
                                                seed=s), forward_fn=fwd)[0]
             for s in range(1500)]
    p = torch.softmax(lg / 0.7, dim=0)
    for tok in range(3):
        _share([d == tok for d in draws], float(p[tok]), f"token {tok}")
    again = diffusion_generate(_Stub(), _Cfg(), [1], 1,
                               DiffusionParams(steps=1, temp=0.7, seed=5),
                               forward_fn=fwd)
    assert again == [draws[5]]


@pytest.fixture(scope="module")
def llada_moe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("llada_moe")
    test_archs_clones2.test_llada_moe_equals_qwen3_moe_bidirectional(tmp)
    return tmp / "out_l"


def test_llada_moe_matches_jax(llada_moe):
    cj, params, _ = jax_load(llada_moe)
    cfg, model, _ = pck.load_checkpoint(llada_moe, device="cpu")
    assert not cfg.causal_attn and not cfg.moe_norm_topk and cfg.n_experts
    params = jax.tree.map(jnp.asarray, params)
    twin_j, twin = jax_twin(params, cj), float_twin_params(model, cfg)
    assert isinstance(twin.layers[0].experts["w_gate"], tt.DenseExpertStack)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (1, 7))
    pos = np.arange(7)[None]
    for p_j, m, impl in ((params, model, "pallas_interpret"),
                         (twin_j, twin, "xla")):
        want, _ = jt.forward(p_j, cj, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(pos, jnp.int32), None, impl=impl)
        with torch.inference_mode():
            got, _ = tt.forward(m, cfg, torch.from_numpy(toks),
                                torch.from_numpy(pos), None)
        want = np.asarray(want)
        if impl == "xla":
            assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(
                want).max()
        else:
            close(got, want, "llada_moe packed")
    # the converter keeps LLaDA-MoE's mask id (156895), past this tiny
    # vocabulary: the JAX gather clamps it, the port's indexing refuses it;
    # the loop runs with the last id as the mask token
    cj = dataclasses.replace(cj, mask_token_id=cj.vocab_size - 1)
    cfg = dataclasses.replace(cfg, mask_token_id=cfg.vocab_size - 1)
    prompt = [3, 1, 4, 1, 5]
    for p_j, m in ((params, model), (twin_j, twin)):
        want = jax_diffusion(p_j, cj, prompt, 6, JaxDP(steps=3))
        assert diffusion_generate(m, cfg, prompt, 6,
                                  DiffusionParams(steps=3)) == want

