"""The encoder family (``vlut_tpu_torch/models/encoder.py``) against the
JAX package's ``models/encoder.py`` on the JAX tests' own checkpoints.

Each case runs a JAX encoder test (an HF model built in code, or HF-named
tensors written from numpy, converted by the JAX converter) up to its
checkpoint load, then loads that checkpoint in both packages and holds the
port's token hidden states and pooled embeddings to the JAX package's:
within 2e-5 of the largest value (float32 products summed in other orders;
exact gelu and softmax round apart by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_archs_wave5 as wave5
import test_encoder as enc_tests
import test_encoder_variants as variants
from _torch_recurrent import loaded_by
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.models import encoder as jenc
from vlut_tpu_torch.bench import encoder_zoo as ez
from vlut_tpu_torch.convert import checkpoint as pck
from vlut_tpu_torch.models import encoder as penc

torch.set_num_threads(1)
TOL = 2e-5

CASES = {
    "bert": (enc_tests.test_bert_parity, enc_tests.V, None),
    "modernbert": (enc_tests.test_modernbert_parity, enc_tests.V, None),
    "nomic-bert": (variants.test_nomic_bert_transcription, variants.V, None),
    "nomic-bert-moe": (variants.test_nomic_bert_moe_transcription,
                       variants.V, None),
    "jina-bert-v2": (variants.test_jina_bert_v2_transcription, variants.V,
                     None),
    "jina-bert-v3": (variants.test_jina_bert_v3_task_loras, variants.V,
                     "retrieval"),
    "neobert": (wave5.test_neobert_transcription, 64, None),
}


def checkpoint(name, tmp_path, monkeypatch):
    test_fn = CASES[name][0]
    return loaded_by(test_fn, tmp_path, monkeypatch)


def _inputs(vocab, b=2, t=19, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (b, t))
    mask = np.ones((b, t), np.int64)
    mask[1, t - 5:] = 0  # a ragged batch: the padding must be masked
    return toks, mask


def _close(got: torch.Tensor, want, what: str):
    want = np.asarray(want, np.float64)
    err = np.abs(got.double().numpy() - want).max()
    scale = max(np.abs(want).max(), 1e-6)
    assert err <= TOL * scale, f"{what}: {err} of {scale}"


@pytest.mark.parametrize("name", list(CASES))
def test_encoder_matches_jax(name, tmp_path, monkeypatch):
    ckpt = checkpoint(name, tmp_path, monkeypatch)
    _, vocab, task = CASES[name]
    cfg_j, params_j, _ = jax_load(ckpt)
    params_j = jax.tree.map(jnp.asarray, params_j)
    cfg, model, meta = pck.load_checkpoint(ckpt, device="cpu")
    assert meta["model_family"] == "encoder"
    assert isinstance(model, penc.EncoderLM) and cfg.arch == cfg_j.arch
    toks, mask = _inputs(vocab)
    tj, mj = jnp.asarray(toks, jnp.int32), jnp.asarray(mask, jnp.int32)
    tt, mt = torch.from_numpy(toks), torch.from_numpy(mask)
    for tk in ((None, task) if task else (None,)):
        want = jenc.forward_encoder(params_j, cfg_j, tj, mj, task=tk)
        got = penc.forward_encoder(model, cfg, tt, mt, task=tk)
        valid = mask.astype(bool)
        _close(got[torch.from_numpy(valid)], np.asarray(want)[valid],
               f"{name} hidden task={tk}")
        _close(penc.embed(model, cfg, tt, mt, task=tk),
               jenc.embed(params_j, cfg_j, tj, mj, task=tk),
               f"{name} embed task={tk}")
    if task:
        # the adapter changes the embedding
        a = penc.embed(model, cfg, tt, mt)
        b = penc.embed(model, cfg, tt, mt, task=task)
        assert not torch.equal(a, b)
        with pytest.raises(KeyError):
            penc.embed(model, cfg, tt, mt, task="no-such-task")


@pytest.mark.parametrize("name", ["bert", "nomic-bert-moe"])
def test_encoder_checkpoint_round_trip(name, tmp_path, monkeypatch):
    """A checkpoint the port writes back loads in both packages as the
    same tree (stacked bert layers stay stacked, a bert-variant's layers
    stay per layer)."""
    ckpt = checkpoint(name, tmp_path / "a", monkeypatch)
    cfg, model, _ = pck.load_checkpoint(ckpt, device="cpu")
    pck.save_checkpoint(tmp_path / "b", cfg, model.tree())
    cfg_a, pa, meta_a = jax_load(ckpt)
    cfg_b, pb, meta_b = jax_load(tmp_path / "b")
    assert cfg_a == cfg_b and meta_b["model_family"] == "encoder"
    assert meta_a["layers_tuple"] == meta_b["layers_tuple"]
    la, lb = jax.tree_util.tree_leaves(pa), jax.tree_util.tree_leaves(pb)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_encoder_init_layout():
    """The card's random encoders take a checkpoint's layout: ModernBERT's
    at a config's widths runs and pools to unit vectors."""
    cfg = penc.EncoderConfig(arch="modernbert", vocab_size=50, d_model=32,
                             n_layers=3, n_heads=4, d_ff=40, local_window=4)
    model = ez.model_on(cfg, ez.random_tree(ez.modernbert_layout(cfg), 1),
                        "cpu")
    toks = torch.randint(1, 50, (2, 9), generator=torch.Generator()
                         .manual_seed(0))
    e = penc.embed(model, cfg, toks, torch.ones_like(toks))
    assert e.shape == (2, 32)
    assert torch.allclose(e.norm(dim=-1), torch.ones(2), atol=1e-5)

