"""The port's sharded train step (``vlut_tpu_torch/train/finetune.py``:
``dense_param_specs``, ``sharded_ce_loss``, ``make_sharded_train_step``)
against the JAX package's on the CPU.

The port runs in gloo ranks (``tests/_torch_parallel.py``: one group of
four for dp 2 x tp 2, one of two for tp 2, each rank running every case of
its group); the JAX step runs in this process on the conftest's virtual
CPU devices.  Both take the same twin (the JAX ``init_params`` of the
preset, twinned by the JAX ``float_twin_params``, embedding and head made
float32, carried across bit for bit) and the same numpy-seeded batch.
Every leaf check is one SGD step (lr 0.1): an SGD update is the gradient
times lr, so the step checks the gradient itself (AdamW's mu / sqrt(nu)
would amplify noise where a gradient is near 0).

Tolerances, as JAX's own sharded test states them: the loss within rtol
2e-4, every leaf after the step within rtol 2e-3 / atol 2e-5.  Measured
here: the loss within 3e-7 relatively, every leaf within 3.2e-7
absolutely (the norm gains, near 1.0, within one ulp) of the
single-device step of either package and of JAX's sharded step.

The JAX package's sharded gradient is dp / tp times the single-device one
(the transpose of its implicit dp broadcast sums over dp, and it divides by
tp; ROADMAP, faults of the reference): at dp 2 x tp 2 it is the
single-device gradient, at tp 2 alone half of it.  The port's is the
single-device gradient at every mesh, so at tp 2 alone it is held to JAX's
step taken at lr x tp / dp.  With a mask whose count differs between the dp
shards, JAX's step averages the shards' own masked means; the port's is the
single-device step there too, and is held to it only.  With QAT each shard
is ternarized with its own mean |w| in both packages (another fault of the
reference: the sharded QAT step is not the single-device one), so QAT is
held to JAX's sharded step only.
"""

import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from vlut_tpu.config import PRESETS as JP
from vlut_tpu.models.transformer import init_params as jax_init
from vlut_tpu.parallel.sharding import make_mesh as jax_mesh
from vlut_tpu.train import finetune as jf
from vlut_tpu_torch.bench import mesh
from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.convert.from_jax import _convert
from vlut_tpu_torch.parallel.distributed import launch
from vlut_tpu_torch.train import finetune as pf

torch.set_num_threads(1)

LR = 0.1
LOSS_RTOL, RTOL, ATOL = 2e-4, 2e-3, 2e-5
# (preset, fields replaced, dp, tp, mask the last row's tail): tiny at JAX's
# test mesh, with a full mask and with one whose count differs between the
# dp shards (22 targets in rows 0-1, 18 in rows 2-3); bitnet's sub-norm
# shards at tp 2 with a vocabulary of 300, not a multiple of 128 x tp, so
# the head has pad columns
CASES = {
    "tiny_dp2_tp2": ("tiny", {}, 2, 2, False),
    "tiny_dp2_tp2_mask": ("tiny", {}, 2, 2, True),
    "bitnet_tp2": ("tiny_bitnet", {"vocab_size": 300}, 1, 2, True),
}


@functools.cache
def _twin(name: str):
    preset, over = CASES[name][:2] if name in CASES else (name, {})
    cj = dataclasses.replace(JP[preset], **over)
    params = jax_init(cj, seed=0)
    params = {**params, **{k: jnp.asarray(params[k], jnp.float32)
                           for k in ("embed", "lm_head") if k in params}}
    twin = jax.tree.map(np.asarray, jf.float_twin_params(params, cj))
    return cj, twin, _convert(twin)


@functools.cache
def _batch(name: str):
    cj = _twin(name)[0]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cj.vocab_size, (4, 12))
    mask = np.ones((4, 12), bool)
    if CASES[name][4]:
        mask[-1, 8:] = False
    return toks, mask


def _jax_sharded(name: str, qat: bool, lr: float):
    """JAX's sharded step: (loss, the tree after it)."""
    cj, twin, _ = _twin(name)
    dp, tp = CASES[name][2:4]
    toks, mask = _batch(name)
    opt = optax.sgd(lr)
    mesh = jax_mesh(dp=dp, tp=tp)
    make, pspecs = jf.make_sharded_train_step(cj, mesh, twin, opt, qat=qat)
    sp = jax.tree.map(
        lambda x, s: jax.device_put(jnp.array(x), NamedSharding(mesh, s)),
        twin, pspecs, is_leaf=lambda x: isinstance(x, np.ndarray))
    after, _, loss = make(opt.init(sp))(sp, opt.init(sp),
                                        jnp.asarray(toks, jnp.int32),
                                        jnp.asarray(mask))
    return float(loss), jax.tree.map(np.asarray, after)


@functools.cache
def _jax_single(name: str):
    """JAX's single-device step: (loss, the tree after it)."""
    cj, twin, _ = _twin(name)
    toks, mask = _batch(name)
    opt = optax.sgd(LR)
    after, _, loss = jf.make_train_step(cj, opt)(
        jax.tree.map(jnp.asarray, twin), opt.init(twin),
        jnp.asarray(toks, jnp.int32), jnp.asarray(mask))
    return float(loss), jax.tree.map(np.asarray, after)


def _port_single(name: str):
    """The port's single-device step: (loss, the tree after it)."""
    cj, _, tree = _twin(name)
    toks, mask = _batch(name)
    params = pf.trainable(tree)
    loss = pf.make_train_step(
        ModelConfig(**dataclasses.asdict(cj)),
        torch.optim.SGD(pf.leaves(params), lr=LR))(
        params, torch.from_numpy(toks), torch.from_numpy(mask))
    return float(loss), jax.tree.map(lambda t: t.detach().numpy(), params)


CE_VOCAB = 300


@functools.cache
def _ce_inputs():
    """Logits (2, 5, 512) whose columns past 300 are pads (large, so an
    unmasked pad would win the softmax), targets, a mask."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 512)).astype(np.float32) * 3
    logits[..., CE_VOCAB:] = 50.0
    targets = rng.integers(0, CE_VOCAB, (2, 5))
    mask = rng.random((2, 5)) > 0.3
    return logits, targets, mask


# ``chip_smoke.py`` phase 30's case (``bench/mesh.py:train_rank``) at tiny
# sizes: prompts of a whole prefill bucket, as on the card
PHASE30 = dict(preset="tiny", n_layers=None, b=2, t=16, n_slots=4, ctx=64,
               prompt_len=16, new_tokens=4, device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def train(name, qat):
        cj, _, tree = _twin(name)
        dp, tp = CASES[name][2:4]
        toks, mask = _batch(name)
        return ("train_step", (dataclasses.asdict(cj), tree, dp, tp, toks,
                               mask, qat, LR))

    tied = _twin("tiny")[0]
    tied_tree = dict(_twin("tiny")[2])
    del tied_tree["lm_head"]
    groups = {
        4: [train("tiny_dp2_tp2", False), train("tiny_dp2_tp2", True),
            train("tiny_dp2_tp2_mask", False)],
        2: [train("bitnet_tp2", False), train("bitnet_tp2", True),
            ("sharded_ce", (*_ce_inputs(), CE_VOCAB)),
            ("train_refusal", (dataclasses.asdict(
                dataclasses.replace(tied, tie_embeddings=True)),
                tied_tree)),
            ("mesh_train", (PHASE30,))],
    }
    return {n: launch("_torch_parallel:run_cases", (cases,), nprocs=n,
                      timeout=300, folder=tmp_path_factory.mktemp(f"t{n}"))
            for n, cases in groups.items()}


def _port(ranks, name: str, qat: bool):
    out = {("tiny_dp2_tp2", False): ranks[4][0][0],
           ("tiny_dp2_tp2", True): ranks[4][0][1],
           ("tiny_dp2_tp2_mask", False): ranks[4][0][2],
           ("bitnet_tp2", False): ranks[2][0][0],
           ("bitnet_tp2", True): ranks[2][0][1]}[(name, qat)]
    return out["loss"], out["tree"]


def _hold(got, want, what: str):
    """Every leaf of ``got`` (the port's gathered tree) to ``want``."""
    loss_g, tree_g = got
    loss_w, tree_w = want
    assert abs(loss_g - loss_w) <= LOSS_RTOL * abs(loss_w), (what, loss_g,
                                                            loss_w)
    keys = []
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree_w)[0],
            jax.tree_util.tree_flatten_with_path(tree_g)[0]):
        key = jax.tree_util.keystr(path)
        keys.append(key)
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {key}")
    return keys


def test_dense_param_specs():
    """The port's spec tuples are JAX's PartitionSpecs, leaf for leaf, on
    the bitnet twin (sub-norms) with an untied head."""
    cj, twin, tree = _twin("bitnet_tp2")
    want = jf.dense_param_specs(cj, twin)
    got = pf.dense_param_specs(ModelConfig(**dataclasses.asdict(cj)), tree)
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, P))[0]
    for path, spec in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(spec) + (None,) * (len(node) - len(spec)) == node, path


def test_sharded_ce_loss_matches_jax(ranks):
    """The vocab-sharded loss at tp 2 with pad columns and a mask: JAX's
    ``sharded_ce_loss`` under shard_map, and the plain masked mean of the
    log-softmax over the first 300 columns; the gradient of each rank's
    block is that of the plain loss."""
    from jax import shard_map

    logits, targets, mask = _ce_inputs()
    mesh = jax_mesh(dp=1, tp=2)
    fn = shard_map(
        lambda lg, t, m: jf.sharded_ce_loss(lg, t, "tp", 256, mask=m,
                                            vocab_size=CE_VOCAB),
        mesh=mesh, in_specs=(P(None, None, "tp"), P(), P()), out_specs=P())
    want = float(fn(jnp.asarray(logits), jnp.asarray(targets),
                    jnp.asarray(mask)))
    full = torch.from_numpy(logits[..., :CE_VOCAB].copy()).requires_grad_()
    nll = -torch.gather(torch.log_softmax(full, -1), -1,
                        torch.from_numpy(targets)[..., None])[..., 0]
    w = torch.from_numpy(mask).float()
    plain = (nll * w).sum() / w.sum()
    plain.backward()
    plain = float(plain.detach())
    grad = np.concatenate([ranks[2][0][2]["grad"], ranks[2][1][2]["grad"]],
                          -1)
    for r in (ranks[2][0][2], ranks[2][1][2]):
        assert abs(r["loss"] - want) <= 1e-6 * abs(want), (r["loss"], want)
        assert abs(r["loss"] - plain) <= 1e-6 * plain
    np.testing.assert_allclose(grad[..., :CE_VOCAB], full.grad.numpy(),
                               rtol=1e-5, atol=1e-8)
    assert not grad[..., CE_VOCAB:].any()


def test_dp2_tp2_matches_jax_and_single_device(ranks):
    """At JAX's own test mesh: the port's step, JAX's sharded step and the
    single-device step (each package's) agree on the loss and every leaf:
    the embedding, the norms, the column and row shards and the head."""
    got = _port(ranks, "tiny_dp2_tp2", False)
    keys = _hold(got, _jax_sharded("tiny_dp2_tp2", False, LR), "jax dp2xtp2")
    _hold(got, _jax_single("tiny_dp2_tp2"), "jax single")
    _hold(got, _port_single("tiny_dp2_tp2"), "port single")
    for kind in ("['embed']", "['final_norm']", "['layers']['attn_norm']",
                 "['layers']['wq']['dense']", "['layers']['wo']['dense']",
                 "['layers']['w_down']['dense']", "['lm_head']"):
        assert kind in keys


def test_dp2_tp2_uneven_mask_equals_single_device(ranks):
    """At dp 2 x tp 2 with a mask whose count differs between the dp
    shards: the port's step is the single-device step of both packages
    (each shard's masked sum over the whole batch's count, the gradients
    summed over dp).  JAX's sharded step averages the shards' own masked
    means, so its loss parts from the single-device one past the loss
    tolerance (5.5e-4 relatively here; ROADMAP, faults of the
    reference)."""
    name = "tiny_dp2_tp2_mask"
    toks, mask = _batch(name)
    counts = mask[:, 1:].reshape(2, -1).sum(-1)
    assert counts[0] != counts[1], counts
    got = _port(ranks, name, False)
    _hold(got, _port_single(name), "port single")
    single = _jax_single(name)
    _hold(got, single, "jax single")
    jax_loss = _jax_sharded(name, False, LR)[0]
    assert abs(jax_loss - single[0]) > LOSS_RTOL * abs(single[0]), (
        jax_loss, single[0])


def test_tp2_sub_norms_equal_single_device(ranks):
    """bitnet at tp 2 (sub-norm shards, a padded vocabulary, a masked
    row): every leaf kind equals the single-device step of both packages,
    and JAX's sharded step taken at lr x tp / dp (its gradient is dp / tp
    of the single-device one)."""
    got = _port(ranks, "bitnet_tp2", False)
    keys = _hold(got, _port_single("bitnet_tp2"), "port single")
    _hold(got, _jax_single("bitnet_tp2"), "jax single")
    _hold(got, _jax_sharded("bitnet_tp2", False, LR * 2), "jax tp2 at 2 lr")
    assert "['layers']['attn_sub_norm']" in keys
    assert "['layers']['ffn_sub_norm']" in keys


@pytest.mark.parametrize("name", ["tiny_dp2_tp2", "bitnet_tp2"])
def test_qat_matches_jax_sharded(ranks, name):
    """QAT: each shard ternarized with its own mean |w|, as JAX's sharded
    step does; held to JAX's step (at lr x tp / dp)."""
    dp, tp = CASES[name][2:4]
    _hold(_port(ranks, name, True), _jax_sharded(name, True, LR * tp / dp),
          f"qat {name}")


def test_jax_sharded_gradient_is_dp_over_tp(ranks):
    """The reference's fault, held: JAX's sharded SGD update at tp 2 alone
    is half the single-device one (exactly the single-device one at lr x
    2), and at dp 2 x tp 2 it is the single-device one."""
    _, before, _ = _twin("bitnet_tp2")
    _, single = _jax_single("bitnet_tp2")
    _, half = _jax_sharded("bitnet_tp2", False, LR)
    d_single = single["layers"]["wq"]["dense"] - before["layers"]["wq"][
        "dense"]
    d_half = half["layers"]["wq"]["dense"] - before["layers"]["wq"]["dense"]
    ratio = float((d_half * d_single).sum() / (d_single * d_single).sum())
    assert abs(ratio - 0.5) < 1e-4, ratio


def test_tied_head(ranks):
    """A tied head at tp 2: JAX's sharded step reads the whole embed.T as
    its vocabulary shard, so it raises where vocab_size differs from
    vocab_p / tp (here 300 against 256) and only by chance gives the loss
    where they are equal; the port refuses it with a message."""
    msg = ranks[2][0][3]
    assert msg is not None and "tied head" in msg
    cj = dataclasses.replace(JP["tiny"], tie_embeddings=True,
                             vocab_size=300)
    params = jax_init(cj, seed=0)
    params = {**params, "embed": jnp.asarray(params["embed"], jnp.float32)}
    twin = jf.float_twin_params(params, cj)
    assert "lm_head" not in twin
    opt = optax.sgd(LR)
    mesh = jax_mesh(dp=1, tp=2)
    make, pspecs = jf.make_sharded_train_step(cj, mesh, twin, opt)
    toks = np.random.default_rng(0).integers(0, 300, (2, 12))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        make(opt.init(twin))(twin, opt.init(twin),
                             jnp.asarray(toks, jnp.int32),
                             jnp.ones((2, 12), bool))


def test_phase30_readings_within_limits(ranks):
    """Phase 30's checks on the CPU: the sharded step's loss, every leaf kind
    and its SGD update within ``bench/mesh.py``'s limits of the
    single-device step; the QAT steps' loss finite and falling; the trained
    tree served, graphed = eager on one device and at tp 2 within phase 29's
    limits; the slot file the ranks' heads bit for bit, its restore
    continuing as the uninterrupted run, and read back bit-equal on one
    device."""
    r0, r1 = ranks[2][0][4], ranks[2][1][4]
    assert r0["loss_rel_err"] <= mesh.TRAIN_LOSS_RTOL
    assert set(r0["leaf_errors"]) == {
        "embed", "final_norm", "attn_norm", "ffn_norm", "wq", "wk", "wv",
        "wo", "w_gate", "w_up", "w_down", "lm_head"}
    assert all(e["allclose_ratio"] <= 1
               and e["update_rel_err"] <= mesh.TRAIN_UPDATE_RTOL
               for e in r0["leaf_errors"].values())
    q = r0["qat_losses"]
    assert np.isfinite(q).all() and q[-1] < q[0] and q == r1["qat_losses"]
    assert r0["single_graphed_equals_eager"]
    serve = r0["serve"]
    for key in ("prefill_logits", "step_logits"):
        e = serve[key]
        assert e["max_abs_err"] <= mesh.PREFILL_TOL * e["max_abs_logit"]
    assert serve["step_layer_rel_err"] <= mesh.LAYER_TOL
    with np.load(io.BytesIO(r0["saved"])) as z:
        n = r0["saved_len"]
        assert len(z["tokens"]) == n
        for k in ("k", "v"):
            want = np.stack([np.concatenate(
                [r["slot_rows"][k][i][:n] for r in (r0, r1)], axis=1)
                for i in range(len(r0["slot_rows"][k]))])
            assert z[f"kv_{k}"].tobytes() == want.tobytes(), k
    assert r0["restored_cont"] == r0["cont"]
    assert r0["restored_reused"] == n
    assert r0["restored_reads_back_equal"] and r0["single_reads_back_equal"]
