"""The port against the JAX package on tiny HF MoE models: the families with a routing bias, groups or a dense lead.

Each model (a config of ``tests/test_archs_hf2.py``, ``test_archs_hf3.py``,
``test_archs_wave6.py`` or ``test_llama4.py``, built with ``transformers``
in code, its projections and experts made exactly ternary) is converted
once by the JAX converter and loaded by both packages;
``_torch_archs.hf_case`` holds the port's forward against the JAX forward
(``impl="pallas_interpret"``) on the stacked and the fused tree (one
unrolled tree for a tuple-layers checkpoint), prefill and cached greedy
decode, within 2e-2 of the largest logit with identical greedy tokens,
and both against HF's logits as a sanity check.
"""

import pytest

pytest.importorskip("transformers")

from _torch_archs import run_moe_family  # noqa: E402


@pytest.mark.parametrize("name", ['dbrx', 'ernie45_moe', 'dots1', 'glm4_moe'])
def test_moe_family_matches_jax(name, tmp_path):
    cfg = run_moe_family(name, tmp_path)
    assert cfg.n_experts
