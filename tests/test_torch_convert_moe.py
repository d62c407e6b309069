"""The port's HF converter against the JAX package's on the MoE and MLA HF
families.

Each model is built in code with the installed ``transformers`` (the
builders of ``tests/_torch_archs.py`` and
``tests/test_torch_archs_mla.py``), its projections made exactly
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
import test_torch_archs_mla as mla  # noqa: E402
from test_archs_hf import _ternarize_model  # noqa: E402


@pytest.mark.parametrize("name", list(ta.MOE_FAMILIES))
def test_moe_family_converts_like_jax(name, tmp_path):
    make, seed, t, tern = ta.MOE_FAMILIES[name]
    out = convert_both(hf_source(make, seed, tmp_path, tern), tmp_path)
    cfg = forward_case(out, t=t)
    assert cfg.n_experts


@pytest.mark.parametrize("name", list(mla.HF_BUILT))
def test_mla_family_converts_like_jax(name, tmp_path):
    make, seed = mla.HF_BUILT[name]
    out = convert_both(hf_source(make, seed, tmp_path, (_ternarize_model,)),
                       tmp_path)
    cfg = forward_case(out, jax_cached=False)
    assert cfg.kv_lora_rank and cfg.qk_rope_dim
