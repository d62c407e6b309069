"""The port against the JAX package on tiny HF models of the ALiBi / NoPE families and the olmo norms.

Each model (a config of ``tests/test_archs_hf*.py`` / ``test_archs_wave4.py``
with exact-ternary projections) is converted once by the JAX converter and
loaded by both packages; ``_torch_archs.hf_case`` holds the port's forward
against the JAX forward (``impl="pallas_interpret"``) on the stacked and the
fused tree, prefill and cached greedy decode, within 2e-2 of the largest
logit with identical greedy tokens, and both against HF's logits as a
sanity check.
"""

import pytest

pytest.importorskip("transformers")

from _torch_archs import run_family  # noqa: E402


@pytest.mark.parametrize("name", ['bloom', 'mpt', 'mpt_extra_heads', 'smollm3', 'olmo', 'olmo2'])
def test_hf_family_matches_jax(name, tmp_path):
    run_family(name, tmp_path)
