"""The port against the JAX package on MLA and M-RoPE models that the JAX
tests write from numpy (``tests/test_archs_clones.py``,
``test_archs_clones2.py``, ``test_archs_wave4.py``), on the CPU:

* minicpm3: deepseek V2's MLA with q-LoRA and a v head of 16, lane-padded
  into wo's rows (the test's second conversion);
* plm: MLA without q-LoRA and an ungated relu^2 MLP;
* qwen3-vl-moe's text model: interleaved M-RoPE sections (which text
  serving ropes as plain rope), per-head q/k norms and a softmax MoE.

``_torch_archs.written_by`` runs a JAX test up to its conversion;
``checkpoint_case`` holds the port's forward against the JAX forward on
both trees, prefill and greedy decode, within 2e-2 of the largest logit
with identical greedy tokens, the JAX side without a cache (see
``tests/test_torch_archs_mla.py``).
"""

import pytest

pytest.importorskip("transformers")

import test_archs_clones as clones  # noqa: E402
import test_archs_clones2 as clones2  # noqa: E402
import test_archs_wave4 as wave4  # noqa: E402
from _torch_archs import checkpoint_case, written_by  # noqa: E402

# name -> (the JAX test, which of its conversions)
WRITTEN = {"minicpm3": (clones.test_minicpm3_equals_deepseek_mla, 1),
           "plm": (clones2.test_plm_attention_equals_deepseek_mla, 0),
           "qwen3vl_moe": (wave4.test_qwen3vl_moe_text_parity, 0)}


@pytest.mark.parametrize("name", list(WRITTEN))
def test_mla_and_mrope_writers_match_jax(name, tmp_path, monkeypatch):
    test_fn, nth = WRITTEN[name]
    cfg = checkpoint_case(written_by(test_fn, tmp_path, monkeypatch,
                                     nth=nth), jax_cached=False)
    if name == "qwen3vl_moe":
        assert cfg.rope_scaling["mrope_section"] and cfg.n_experts
    else:
        assert cfg.kv_lora_rank and cfg.qk_rope_dim
    if name == "minicpm3":
        assert cfg.head_dim == 16
