"""The port's HF converter against the JAX package's on the dense HF
families (first half).

Each model is built in code with the installed ``transformers`` (the
builders of ``tests/_torch_archs.py``), its projections made exactly
ternary, and converted by both converters (the port on the CPU): the
checkpoints equal array for array, ``config_from_hf`` equal field for field
(``_torch_convert.convert_both``).  The port's checkpoint, loaded by the
port, is then held against the JAX forward of the JAX converter's
(``_torch_convert.forward_case``: prefill and cached greedy decode, within
2e-2 of the largest logit, greedy tokens equal).
"""

import pytest

pytest.importorskip("transformers")

import _torch_archs as ta  # noqa: E402
from _torch_convert import convert_both, forward_case, hf_source  # noqa: E402

NAMES = [
    "gptneox", "phi2", "starcoder2", "cohere", "stablelm", "gpt2", "opt",
    "bloom", "mpt", "mpt_extra_heads", "olmo", "olmo2", "nemotron",
    "cohere2", "smollm3",
]


@pytest.mark.parametrize("name", NAMES)
def test_hf_family_converts_like_jax(name, tmp_path):
    make, seed, t = ta.HF_FAMILIES[name]
    out = convert_both(hf_source(make, seed, tmp_path), tmp_path)
    forward_case(out, t=t)
