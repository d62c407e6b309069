"""The port's trainer (``vlut_tpu_torch/train/finetune.py``) against the JAX
package's ``vlut_tpu/train/finetune.py``.

The same twin goes through both: the JAX ``init_params`` of
``PRESETS["tiny"]`` / ``PRESETS["tiny_moe"]`` from a seed, twinned by the
JAX ``float_twin_params`` and carried across bit for bit, with the same
numpy-seeded tokens and mask.  Tolerances, each stated where it is used:

* the loss: within 1e-6 of JAX's, relatively (float32 twin);
* one SGD step (lr 0.1) on a float32 twin: every updated leaf within
  ``SGD_TOL`` of JAX's, QAT included (float32 sums in other orders);
* one SGD step on the bf16-embedding twin: every leaf within 1e-2 of its
  largest update (the bf16 residual stream rounds the two gradients' last
  bits apart), and the bf16 leaves (embedding, head) one bf16 step beyond
  that (optax rounds the update to bf16 before adding it, torch adds in
  float32 and rounds once);
* one AdamW step (every hyperparameter given to both: optax's default
  weight decay is 1e-4, torch's 1e-2): every element within 2 lr of JAX's
  (AdamW's first update is lr g / (|g| + eps), whose sign flips where g is
  near zero), and all but 0.1% of each leaf's elements (at least two)
  within 1e-2 lr;
* ``pack_params``: byte for byte.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_archs import check_pair, per_tensor_scales
from vlut_tpu.config import PRESETS as JP
from vlut_tpu.models.transformer import init_params as jax_init
from vlut_tpu.train import finetune as jf
from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.convert.from_jax import _convert, params_from_numpy
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.train import finetune as pf

torch.set_num_threads(1)

SGD_LR, ADAM_LR = 0.1, 1e-3
SGD_TOL = 2e-6


def _twin(name: str, f32: bool = True, seed: int = 0, **over):
    """(JAX config, JAX twin, port config, port twin tree): one twin of the
    preset (its fields ``over`` replaced), the embedding and head made
    float32 where ``f32``."""
    cj = dataclasses.replace(JP[name], **over)
    params = jax_init(cj, seed=seed)
    if f32:
        params = {**params, **{k: jnp.asarray(params[k], jnp.float32)
                               for k in ("embed", "lm_head")
                               if k in params}}
    twin_j = jf.float_twin_params(params, cj)
    tree = _convert(jax.tree.map(np.asarray, twin_j))
    return cj, twin_j, ModelConfig(**dataclasses.asdict(cj)), tree


def _batch(cfg, b: int = 2, t: int = 12, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t))
    mask = np.ones((b, t), bool)
    mask[-1, t - 4:] = False
    return toks, mask


def _pairs(a, b, key=""):
    """(path, JAX leaf as numpy, port leaf) over two trees."""
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{key}.{k}")
        return
    yield key, np.asarray(a), b


def _shapes(tree, key="") -> dict:
    """path -> shape of every leaf of a port tree."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _shapes(v, f"{key}.{k}").items()}
    return {key[1:]: tuple(tree.shape)}


def _one_step(name: str, opt: str, qat: bool, f32: bool = True):
    """One step of each trainer from the same twin: (JAX twin before, JAX
    params after, port tree after, JAX loss, port loss)."""
    cj, twin_j, cfg, tree = _twin(name, f32)
    toks, mask = _batch(cfg)
    if opt == "sgd":
        oj = optax.sgd(SGD_LR)

        def make(ps):
            return torch.optim.SGD(ps, lr=SGD_LR)
    else:
        oj = optax.adamw(ADAM_LR, b1=0.9, b2=0.999, eps=1e-8,
                         weight_decay=1e-4)

        def make(ps):
            return torch.optim.AdamW(ps, lr=ADAM_LR, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)
    step_j = jf.make_train_step(cj, oj, qat=qat)
    before = jax.tree.map(np.asarray, twin_j)
    after_j, _, loss_j = step_j(jax.tree.map(jnp.copy, twin_j),
                                oj.init(twin_j), jnp.asarray(toks, jnp.int32),
                                jnp.asarray(mask))
    params = pf.trainable(tree)
    step = pf.make_train_step(cfg, make(pf.leaves(params)), qat=qat)
    loss = step(params, torch.from_numpy(toks), torch.from_numpy(mask))
    return before, jax.tree.map(np.asarray, after_j), params, float(
        loss_j), float(loss)


def test_ste_identity_gradient():
    """The STE's forward is JAX's and its gradient the identity."""
    w0 = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    w = torch.from_numpy(w0).requires_grad_(True)
    (pf.ste_ternarize(w) * 2.0).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), 2.0 * np.ones((8, 8)))
    want = np.asarray(jf.ste_ternarize(jnp.asarray(w0)))
    np.testing.assert_allclose(pf.ste_ternarize(w).detach().numpy(), want,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["tiny", "tiny_moe"])
@pytest.mark.parametrize("qat", [False, True])
def test_loss_matches_jax(name, qat):
    cj, twin_j, cfg, tree = _twin(name)
    toks, mask = _batch(cfg)
    want = float(jf.causal_lm_loss(twin_j, cj, jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(mask), qat=qat))
    got = float(pf.causal_lm_loss(tree, cfg, torch.from_numpy(toks),
                                  torch.from_numpy(mask), qat=qat))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    # the model form takes the same path as the tree
    model = params_from_numpy(jax.tree.map(np.asarray, twin_j), cfg)
    assert float(pf.causal_lm_loss(model, cfg, torch.from_numpy(toks),
                                   torch.from_numpy(mask), qat=qat)) == got


@pytest.mark.parametrize("name", ["tiny", "tiny_moe"])
@pytest.mark.parametrize("qat", [False, True])
def test_sgd_step_matches_jax(name, qat):
    _, after_j, params, loss_j, loss = _one_step(name, "sgd", qat)
    assert abs(loss - loss_j) <= 1e-6 * abs(loss_j)
    for key, a, b in _pairs(after_j, params):
        assert b.dtype == torch.float32, key
        err = float(np.abs(b.detach().numpy() - a).max())
        assert err <= SGD_TOL, (key, err)


def _bf16_step(a: np.ndarray, w0: np.ndarray) -> np.ndarray:
    """A bf16 step at the larger of a leaf's values before and after the
    update: 2^(floor(log2 |v|) - 7)."""
    mag = np.maximum(np.abs(w0.astype(np.float32)),
                     np.abs(a.astype(np.float32)))
    return np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)


def test_sgd_step_on_bf16_leaves():
    before, after_j, params, loss_j, loss = _one_step("tiny", "sgd", False,
                                                      f32=False)
    assert abs(loss - loss_j) <= 1e-4 * abs(loss_j)
    for (key, a, b), (_, w0, _) in zip(_pairs(after_j, params),
                                       _pairs(before, params)):
        a32, w32 = a.astype(np.float32), w0.astype(np.float32)
        tol = 1e-2 * np.abs(a32 - w32).max()
        if b.dtype == torch.bfloat16:
            tol = tol + _bf16_step(a, w0)
        err = np.abs(b.detach().float().numpy() - a32)
        assert (err <= tol).all(), (key, err.max())


@pytest.mark.parametrize("name,qat", [("tiny", False), ("tiny", True),
                                      ("tiny_moe", True)])
def test_adamw_step_matches_jax(name, qat):
    _, after_j, params, loss_j, loss = _one_step(name, "adamw", qat)
    assert abs(loss - loss_j) <= 1e-6 * abs(loss_j)
    for key, a, b in _pairs(after_j, params):
        d = np.abs(b.detach().numpy() - a)
        assert d.max() <= 2 * ADAM_LR + 1e-6, (key, d.max())
        off = int((d > 1e-2 * ADAM_LR).sum())
        assert off <= max(2, 1e-3 * d.size), (key, off, d.size)


def test_trainable_leaves_are_the_float_leaves():
    """The trainer hands the optimizer exactly the twin's float leaves
    (those JAX differentiates), each gets a gradient, the router included,
    and a packed model that shares tensors with the twin is untouched."""
    cj = JP["tiny_moe"]
    cfg = ModelConfig(**dataclasses.asdict(cj))
    packed = tt.init_params(cfg, seed=1)
    keep = {k: v.clone() for k, v in packed.state_dict().items()}
    twin = pf.float_twin_params(packed, cfg)
    params = pf.trainable(twin)
    got = pf.leaves(params)
    want = jax.tree_util.tree_flatten_with_path(jf.float_twin_params(
        jax_init(cj, seed=1), cj))[0]
    shapes = {".".join(k.key for k in path): np.shape(w)
              for path, w in want}
    assert _shapes(params) == shapes
    assert len(got) == len(shapes)
    assert all(t.requires_grad and t.is_leaf for t in got)
    opt = torch.optim.SGD(got, lr=SGD_LR)
    toks, mask = _batch(cfg)
    pf.make_train_step(cfg, opt)(params, torch.from_numpy(toks),
                                 torch.from_numpy(mask))
    assert all(t.grad is not None for t in got)
    for k, v in packed.state_dict().items():
        assert not v.requires_grad, k
        assert torch.equal(v, keep[k]), k


def _boundary_master(shape, rng, scale):
    """Masters whose mean |w| is exactly ``scale``: half of them at +-0.5
    scale, half at +-1.5 scale, so w / s lands on .5 ties."""
    mag = np.where(np.arange(np.prod(shape)) % 2 == 0, 0.5, 1.5)
    rng.shuffle(mag)
    sign = rng.choice([-1.0, 1.0], size=mag.shape)
    return (sign * mag * scale).astype(np.float32).reshape(shape)


@pytest.mark.parametrize("name", ["tiny", "tiny_moe"])
def test_pack_params_bytes_equal_jax(name):
    """``pack_params`` packs the same bytes and scales as JAX's: trained
    masters, and masters with ties at +-0.5 s (half to even sends them to
    0) and at +-1.5 s (clipped), with s exact (1.0) and not (0.75 + 1e-8
    rounds to another float32 than 0.75)."""
    cj, twin_j, cfg, tree = _twin(name)
    rng = np.random.default_rng(4)
    tj = jax.tree.map(np.asarray, twin_j)
    for nm, scale in (("wq", 1.0), ("w_down", 0.75)):
        d = tj["layers"][nm]["dense"]
        d = _boundary_master(d.shape, rng, scale)
        tj["layers"][nm]["dense"] = d
        tree["layers"][nm]["dense"] = torch.from_numpy(d.copy())
    want = jf.pack_params(tj, cj)
    got = pf.pack_params(tree, cfg)
    for key, a, b in _pairs(want, got):
        assert (a.dtype, a.shape) == (b.numpy().dtype, tuple(b.shape)), key
        assert a.tobytes() == b.numpy().tobytes(), key
    trits = tt.unpack_weight("wq", tt.TernaryTensor(
        got["layers"]["wq"]["packed"][0], got["layers"]["wq"]["scale"][0],
        *(lambda s: (s.k, s.n, s.fmt, s.kb))(tt.weight_specs(cfg)["wq"])),
        cfg, tt.make_plan(cfg), host=False)
    assert (trits == 0).any() and (trits.abs() == 1).any()


def test_packed_tree_gives_jax_tokens():
    """A QAT step, then ``pack_params`` in both packages: the same bytes,
    and the port's packed model gives the JAX packed model's logits (within
    the 2e-2 of ``_torch_archs.check_pair``) and greedy tokens, prefill and
    cached decode."""
    cj, twin_j, cfg, tree = _twin("tiny")
    toks, mask = _batch(cfg)
    oj = optax.sgd(SGD_LR)
    after_j, _, _ = jf.make_train_step(cj, oj, qat=True)(
        twin_j, oj.init(twin_j), jnp.asarray(toks, jnp.int32),
        jnp.asarray(mask))
    params = pf.trainable(tree)
    pf.make_train_step(cfg, torch.optim.SGD(pf.leaves(params), lr=SGD_LR),
                       qat=True)(params, torch.from_numpy(toks),
                                 torch.from_numpy(mask))
    # pack the JAX masters in both, so the comparison is of the packers
    masters = jax.tree.map(np.asarray, after_j)
    want = jf.pack_params(masters, cj)
    got = pf.pack_params(_convert(masters), cfg)
    for key, a, b in _pairs(want, got):
        assert a.tobytes() == b.numpy().tobytes(), key
    model = tt.TransformerLM(cfg, got)
    check_pair(cj, jax.tree.map(jnp.asarray, per_tensor_scales(want)), cfg,
               model, toks[:, :7].astype(np.int32), n_decode=2, max_len=16)
    # the port's own trained masters pack into a servable model too
    mine = tt.TransformerLM(cfg, pf.pack_params(params, cfg))
    with torch.inference_mode():
        lg, _ = mine(torch.from_numpy(toks), torch.arange(12).expand(2, 12))
    assert torch.isfinite(lg).all()


def test_tuple_tree_and_sharded_step_raise():
    """A tuple-layers tree: JAX's ``pack_params`` and QAT loss raise
    AttributeError (``params["layers"].items()``); the port refuses both
    with a message, and trains such a tree without QAT.  The sharded step
    and its loss name ROADMAP item 6."""
    cj, twin_j, cfg, tree = _twin("tiny")
    tuple_j = {**twin_j, "layers": tuple(
        jax.tree.map(lambda x, i=i: x[i], twin_j["layers"])
        for i in range(cj.n_layers))}
    with pytest.raises(AttributeError):
        jf.pack_params(tuple_j, cj)
    toks, mask = _batch(cfg)
    with pytest.raises(AttributeError):
        jf.causal_lm_loss(tuple_j, cj, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(mask), qat=True)
    tuple_t = {**tree, "layers": [
        {k: ({"dense": v["dense"][i]} if isinstance(v, dict) else v[i])
         for k, v in tree["layers"].items()} for i in range(cfg.n_layers)]}
    with pytest.raises(NotImplementedError, match="tuple-layers"):
        pf.pack_params(tuple_t, cfg)
    with pytest.raises(NotImplementedError, match="tuple-layers"):
        pf.causal_lm_loss(tuple_t, cfg, torch.from_numpy(toks), qat=True)
    want = float(jf.causal_lm_loss(tuple_j, cj, jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(mask)))
    got = float(pf.causal_lm_loss(tuple_t, cfg, torch.from_numpy(toks),
                                  torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6 * abs(want)
    for fn in (pf.make_sharded_train_step, pf.sharded_ce_loss):
        with pytest.raises(NotImplementedError, match="item 6"):
            fn(cfg)


def test_loss_past_the_attention_chunk():
    """A sequence longer than ``ATTN_CHUNK`` takes the online-softmax
    attention; its backward runs (nothing autograd saves is written in
    place) and the loss is JAX's."""
    t = tt.ATTN_CHUNK + 40
    cj, twin_j, cfg, tree = _twin("tiny", max_seq_len=t)
    toks, mask = _batch(cfg, b=1, t=t)
    want = float(jf.causal_lm_loss(twin_j, cj, jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(mask)))
    params = pf.trainable(tree)
    loss = pf.causal_lm_loss(params, cfg, torch.from_numpy(toks),
                             torch.from_numpy(mask))
    loss.backward()
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    assert all(p.grad is not None for p in pf.leaves(params))
