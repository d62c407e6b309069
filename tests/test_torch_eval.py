"""The port's perplexity harness, accuracy tasks and KL files against the JAX
package on the CPU (tiny presets, identical weights).

The JAX side runs with ``impl="pallas_interpret"``: its ``"xla"`` path
rounds differently from its own kernels (PERF.md §6), and the port follows
the kernels.  Tolerances, and why:

* perplexity: relative 1e-4.  The unfused tree's small-M projections
  quantize with the kernels' ``amax * (1/127)`` scale in the port and with a
  true division in the JAX ``pallas_interpret`` route, and the float32 sums
  run in another order; both move the logits by about 1e-6 of their size
  (measured 1e-5 relative on the perplexity).  Windows of 32 tokens take
  the small-M kernels of both trees; windows of 96 the tiled GEMM, compared
  on the stacked tree only (there the JAX fused tree runs its composed XLA
  route, which is not its kernel's rounding).
* logits_compare: KL mean within 5% and KL max within 25% relative (both
  are about 1e-5, the size of the int8 quantization noise itself, and the
  max is one position's), top-1 agreement within two positions of the
  window.
* the dequant forward: 2e-2 of the largest logit, as in
  ``test_torch_model.py`` (every projection rounds its output to bf16, and
  an output next to a bf16 rounding boundary may round the other way).
* task scores: 1e-5 absolute (means of log-probabilities that agree to
  5e-7); accuracies equal.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlut_tpu.config import PRESETS as JAX_PRESETS
from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.eval import perplexity as jp
from vlut_tpu.eval import tasks as jtasks
from vlut_tpu.models import transformer as jt
from vlut_tpu_torch.config import PRESETS
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.convert.from_jax import params_from_numpy
from vlut_tpu_torch.eval import perplexity as tp
from vlut_tpu_torch.eval import tasks as ttasks
from vlut_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

JAX_IMPL = "pallas_interpret"
ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_REAL = ROOT / "tests" / "fixtures" / "tiny_real"
SURVEY = ROOT / "SURVEY.md"


def _models(name, fused):
    cfg_j, cfg = JAX_PRESETS[name], PRESETS[name]
    params = jt.init_params(cfg_j, seed=0)
    if fused:
        params = jt.unstack_layers(jt.fuse_projections(params, cfg_j), cfg_j)
    return cfg_j, params, cfg, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg)


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


@pytest.mark.parametrize("name,fused,window", [
    ("tiny", False, 32), ("tiny", True, 32), ("tiny", False, 96),
    ("tiny_bitnet", False, 32), ("tiny_bitnet", True, 32),
    ("tiny_bitnet", False, 96)])
def test_perplexity_matches_jax(name, fused, window):
    cfg_j, params, cfg, model = _models(name, fused)
    toks = _tokens(cfg, 2 * window + 5)
    want = jp.perplexity(params, cfg_j, toks, window=window, impl=JAX_IMPL)
    got = tp.perplexity(model, cfg, toks, window=window)
    assert got["tokens"] == want["tokens"] == 2 * (window - 1)
    assert abs(got["ppl"] - want["ppl"]) <= 1e-4 * want["ppl"]
    assert abs(got["nll"] - want["nll"]) <= 1e-4 * abs(want["nll"])
    with pytest.raises(ValueError, match="at least"):
        tp.perplexity(model, cfg, toks[:window - 1], window=window)


@pytest.mark.parametrize("name", ["tiny", "tiny_bitnet"])
def test_logits_compare_matches_jax(name):
    cfg_j, params, cfg, model = _models(name, fused=True)
    toks, window = _tokens(cfg, 64, seed=1), 48
    want = jp.logits_compare(params, cfg_j, toks, impl_a=JAX_IMPL,
                             impl_b="dequant", window=window)
    got = tp.logits_compare(model, cfg, toks, impl_a="auto",
                            impl_b="dequant", window=window)
    assert abs(got["kl_mean"] - want["kl_mean"]) <= 0.05 * want["kl_mean"]
    assert abs(got["kl_max"] - want["kl_max"]) <= 0.25 * want["kl_max"]
    assert abs(got["top1_agreement"] - want["top1_agreement"]) <= 2 / window
    same = tp.logits_compare(model, cfg, toks, impl_a="auto", impl_b="auto",
                             window=window)
    assert same == {"kl_mean": 0.0, "kl_max": 0.0, "top1_agreement": 1.0}


@pytest.mark.parametrize("fused", [False, True], ids=["stacked", "fused"])
@pytest.mark.parametrize("name", ["tiny", "tiny_bitnet"])
def test_dequant_forward_matches_jax(name, fused):
    cfg_j, params, cfg, model = _models(name, fused)
    toks = _tokens(cfg, 2 * 40, seed=2).reshape(2, 40)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    want, _ = jt.forward(params, cfg_j, jnp.asarray(toks), jnp.asarray(pos),
                         impl="dequant")
    with torch.inference_mode():
        got, _ = tt.forward(model, cfg, torch.from_numpy(toks).long(),
                            torch.from_numpy(pos).long(), impl="dequant")
        last, _ = tt.forward(model, cfg, torch.from_numpy(toks).long(),
                             torch.from_numpy(pos).long(), impl="dequant",
                             logits_last_only=True)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()
    assert torch.equal(last, got[:, -1:])
    with pytest.raises(ValueError, match="impl"):
        tt.forward(model, cfg, torch.from_numpy(toks).long(),
                   torch.from_numpy(pos).long(), impl="xla")


class _CharTok:
    def encode(self, text, add_bos=True):
        return [min(ord(c), 255) for c in text]


def test_tasks_match_jax(tmp_path):
    cfg_j, params, cfg, model = _models("tiny", fused=True)
    tok = _CharTok()
    hs = tmp_path / "hs.jsonl"
    hs.write_text("\n".join(json.dumps(
        {"ctx": f"abc {i}", "endings": ["de", "fgh"], "label": i % 2})
        for i in range(2)))
    wg = tmp_path / "wg.jsonl"
    wg.write_text("\n".join(json.dumps(
        {"sentence": f"x _ y{i}", "option1": "a", "option2": "bq",
         "answer": 1 + i % 2}) for i in range(2)))
    mc = tmp_path / "mc.jsonl"
    mc.write_text(json.dumps(
        {"question": "q", "choices": ["x", "yy"], "answer": 1}))
    for jf, tf, path in ((jtasks.hellaswag_eval, ttasks.hellaswag_eval, hs),
                         (jtasks.winogrande_eval, ttasks.winogrande_eval, wg),
                         (jtasks.multiple_choice_eval,
                          ttasks.multiple_choice_eval, mc)):
        want = jf(params, cfg_j, tok, path, impl=JAX_IMPL)
        got = tf(model, cfg, tok, path)
        assert got == want
    assert ttasks.hellaswag_eval(model, cfg, tok, hs, limit=1)["n"] == 1
    ctx, choices = [3, 7, 11, 2], [[5, 6], [9, 4]]
    for norm in ("tokens", "none"):
        want = jtasks.score_continuations(params, cfg_j, ctx, choices,
                                          impl=JAX_IMPL, normalize=norm)
        got = ttasks.score_continuations(model, cfg, ctx, choices,
                                         normalize=norm)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_saved_logits_cross_read(tmp_path):
    """A file saved by the JAX package is read by the port and the other
    way round.  On the trained tiny_real checkpoint the two packages' logits
    agree to float rounding, so top-1 agreement is 1.0 and the KL is at the
    fp16 storage noise.  (On random weights near-ties in the fp16 base flip
    an argmax now and then.)"""
    cfg_j, params, _ = jax_load(TINY_REAL, stream=False)
    params = jax.tree.map(jnp.asarray, params)
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    ids = np.frombuffer(SURVEY.read_bytes()[:66], np.uint8).astype(np.int32)
    jax_file, port_file = tmp_path / "jax.npz", tmp_path / "port.npz"
    jtasks.save_logits(params, cfg_j, ids, jax_file, window=32,
                       impl=JAX_IMPL)
    ttasks.save_logits(model, cfg, ids, port_file, window=32)
    a, b = np.load(jax_file), np.load(port_file)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    for out in (ttasks.kl_vs_saved(model, cfg, jax_file),
                jtasks.kl_vs_saved(params, cfg_j, port_file, impl=JAX_IMPL)):
        assert out["tokens"] == 64
        assert out["top1_agreement"] == 1.0
        assert out["kl_mean"] < 1e-3
        assert abs(out["ppl"] - out["ppl_base"]) < 0.01 * out["ppl_base"]
