"""T5 (``vlut_tpu_torch/models/t5.py``) against the JAX package's
``models/t5.py`` on the JAX tests' own checkpoints (``tests/test_t5.py``:
an HF T5 built in code, converted by the JAX converter), gated and tied or
ungated and untied: ``encode`` and ``decode_logits`` within 2e-5 of the
largest value, greedy ``generate`` and ``cli generate`` tokens equal; the
relative-position buckets equal for every distance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_t5
from _torch_recurrent import loaded_by
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import t5 as jt5
from vlut_tpu_torch.convert import checkpoint as pck
from vlut_tpu_torch.models import t5 as pt5

torch.set_num_threads(1)
TOL = 2e-5


def _t5_checkpoint(tmp_path, monkeypatch, gated, tie):
    def case(tp):
        test_t5._mk(tp, gated=gated, tie=tie)

    case.__module__ = test_t5.__name__
    return loaded_by(case, tmp_path, monkeypatch)


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(got.double().numpy() - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-6), f"{what}: {err}"


@pytest.mark.parametrize("gated,tie", [(True, True), (False, False)])
def test_t5_matches_jax(tmp_path, monkeypatch, gated, tie):
    ckpt = _t5_checkpoint(tmp_path, monkeypatch, gated, tie)
    cfg_j, params_j, _ = jax_load(ckpt)
    params_j = jax.tree.map(jnp.asarray, params_j)
    cfg, model, meta = pck.load_checkpoint(ckpt, device="cpu")
    assert meta["model_family"] == "t5" and cfg.gated == gated
    rng = np.random.default_rng(5)
    b, te, td = 2, 24, 7  # t_enc past max_exact: the log buckets
    enc = rng.integers(0, test_t5.V, (b, te))
    dec = rng.integers(0, test_t5.V, (b, td))
    mask = np.ones((b, te), np.int64)
    mask[1, 19:] = 0
    e_j = jt5.encode(params_j, cfg_j, jnp.asarray(enc, jnp.int32),
                     jnp.asarray(mask, jnp.int32))
    e_p = pt5.encode(model, cfg, torch.from_numpy(enc), torch.from_numpy(mask))
    _close(e_p, e_j, "encode")
    want = np.asarray(jt5.decode_logits(
        params_j, cfg_j, jnp.asarray(dec, jnp.int32), e_j,
        jnp.asarray(mask, jnp.int32)))
    got = pt5.decode_logits(model, cfg, torch.from_numpy(dec), e_p,
                            torch.from_numpy(mask))
    _close(got, want, "decode_logits")
    assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))
    # greedy generation from one prompt: the JAX loop's tokens
    prompt = rng.integers(2, test_t5.V, 10)
    assert (pt5.generate(model, cfg, prompt, n_new=8)
            == jt5.generate(params_j, cfg_j, prompt, n_new=8))
    # seeded sampling repeats under one seed
    a = pt5.generate(model, cfg, prompt, n_new=6, temp=0.8, seed=3)
    assert a == pt5.generate(model, cfg, prompt, n_new=6, temp=0.8, seed=3)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("n_buckets,max_dist", [(32, 128), (8, 20),
                                                (32, 64)])
def test_rel_buckets_equal_jax_at_every_distance(bidirectional, n_buckets,
                                                 max_dist):
    """A 1-ulp difference in the float32 log at a bucket edge would move a
    whole bucket: every relative distance up to max_len both ways gives the
    JAX package's bucket."""
    max_len = 512
    rel = np.arange(-max_len, max_len + 1)
    want = np.asarray(jt5._rel_bucket(jnp.asarray(rel, jnp.int32),
                                      bidirectional, n_buckets, max_dist))
    got = pt5.rel_bucket(torch.from_numpy(rel), bidirectional, n_buckets,
                         max_dist).numpy()
    assert np.array_equal(got, want)


def test_t5_cli_generate(tmp_path, monkeypatch, capsys):
    """``cli generate`` on a T5 checkpoint: the prompt's ids and eos
    through the encoder, the JAX loop's greedy tokens."""
    from tokenizers import Tokenizer as TK, models
    from tokenizers.pre_tokenizers import Split
    from transformers import PreTrainedTokenizerFast

    from vlut_tpu_torch import cli
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    ckpt = _t5_checkpoint(tmp_path, monkeypatch, True, True)
    vocab = {chr(48 + i): i for i in range(test_t5.V)}
    tk = TK(models.WordLevel(vocab, unk_token="0"))
    tk.pre_tokenizer = Split("", "isolated")
    PreTrainedTokenizerFast(tokenizer_object=tk, unk_token="0").save_pretrained(
        str(ckpt))
    cfg_j, params_j, _ = jax_load(ckpt)
    tok = Tokenizer(str(ckpt))
    ids = tok.encode("ABCDEFG", add_bos=False) + [cfg_j.eos_id]
    want = jt5.generate(jax.tree.map(jnp.asarray, params_j), cfg_j, ids,
                        n_new=6)
    cli.main(["generate", "--model", str(ckpt), "-p", "ABCDEFG", "-n", "6",
              "--temp", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == tok.decode(want)
