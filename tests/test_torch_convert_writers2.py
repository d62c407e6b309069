"""The port's HF converter against the JAX package's on the JAX tests' own
writers (``tests/test_archs_moe_wave.py``, ``tests/test_archs_wave5.py``,
``tests/test_archs_wave6.py``, ``tests/test_diffusion.py``,
``tests/test_llama4.py``, ``tests/test_ssm.py``, ``tests/test_mamba2.py``).

Each case runs a JAX test up to its ``nth`` ``convert_hf`` call
(``_torch_convert.jax_source``) and converts the HF directory it handed
over with both converters (the port on the CPU, with the call's own
``dtype_hp``): the checkpoints equal array for array, ``config_from_hf``
equal field for field.  The cases the port's tests already hold to the JAX
forward (``tests/test_torch_moe_writers.py``'s ten, Mamba and Mamba2) are
held again, the port's checkpoint loaded by the port against the JAX
forward of the JAX converter's.  The writers' vision checkpoints and
unported families are refused (``tests/test_torch_convert.py``).
"""

import pytest

pytest.importorskip("transformers")

import test_archs_moe_wave as moe_wave  # noqa: E402
import test_archs_wave5  # noqa: E402
import test_archs_wave6  # noqa: E402
import test_diffusion  # noqa: E402
import test_llama4  # noqa: E402
import test_ssm  # noqa: E402
import test_mamba2  # noqa: E402
from _torch_convert import (  # noqa: E402
    convert_both,
    forward_case,
    jax_source,
    ssm_forward_case,
)

# id -> (the JAX test, which of its conversions, the forward check)
CASES = {
    "moe_wave.bailingmoe_equals_ernie_moe[0]": (
        moe_wave.test_bailingmoe_equals_ernie_moe, 0, "fwd"),
    "moe_wave.bailingmoe_equals_ernie_moe[1]": (
        moe_wave.test_bailingmoe_equals_ernie_moe, 1, ""),
    "moe_wave.bailingmoe_norm_head[0]": (
        moe_wave.test_bailingmoe_norm_head, 0, ""),
    "moe_wave.bailingmoe2_equals_dots1[0]": (
        moe_wave.test_bailingmoe2_equals_dots1, 0, "fwd"),
    "moe_wave.bailingmoe2_equals_dots1[1]": (
        moe_wave.test_bailingmoe2_equals_dots1, 1, ""),
    "moe_wave.phimoe_equals_mixtral_ln[0]": (
        moe_wave.test_phimoe_equals_mixtral_ln, 0, "fwd"),
    "moe_wave.phimoe_equals_mixtral_ln[1]": (
        moe_wave.test_phimoe_equals_mixtral_ln, 1, ""),
    "moe_wave.phimoe_lm_head_bias[0]": (
        moe_wave.test_phimoe_lm_head_bias, 0, ""),
    "moe_wave.phimoe_lm_head_bias[1]": (
        moe_wave.test_phimoe_lm_head_bias, 1, ""),
    "moe_wave.grok1_matches_reference_transcription[0]": (
        moe_wave.test_grok1_matches_reference_transcription,
        0, "fwd"),
    "moe_wave.arctic_matches_reference_transcription[0]": (
        moe_wave.test_arctic_matches_reference_transcription,
        0, "fwd"),
    "moe_wave.grovemoe_zero_chunk_equals_qwen3_moe[0]": (
        moe_wave.test_grovemoe_zero_chunk_equals_qwen3_moe, 0, ""),
    "moe_wave.grovemoe_zero_chunk_equals_qwen3_moe[1]": (
        moe_wave.test_grovemoe_zero_chunk_equals_qwen3_moe, 1, ""),
    "moe_wave.grovemoe_chunk_matches_reference_transcription[0]": (
        moe_wave.test_grovemoe_chunk_matches_reference_transcription,
        0, "fwd"),
    "wave5.gemma_embedding_parity[0]": (
        test_archs_wave5.test_gemma_embedding_parity, 0, ""),
    "wave5.deepseek_v1_transcription[0]": (
        test_archs_wave5.test_deepseek_v1_transcription, 0, "fwd"),
    "wave5.minimax_m2_transcription[0]": (
        test_archs_wave5.test_minimax_m2_transcription, 0, "fwd"),
    "wave5.smallthinker_transcription[0]": (
        test_archs_wave5.test_smallthinker_transcription, 0, "fwd"),
    "wave5.afmoe_transcription[0]": (
        test_archs_wave5.test_afmoe_transcription, 0, "fwd"),
    "wave5.mimo2_transcription[0]": (
        test_archs_wave5.test_mimo2_transcription, 0, ""),
    "wave5.openelm_transcription[0]": (
        test_archs_wave5.test_openelm_transcription, 0, ""),
    "wave5.deci_transcription[0]": (
        test_archs_wave5.test_deci_transcription, 0, ""),
    "wave5.plamo3_transcription[0]": (
        test_archs_wave5.test_plamo3_transcription, 0, ""),
    "wave5.cogvlm_dual_expert[1]": (
        test_archs_wave5.test_cogvlm_dual_expert, 1, ""),
    "wave5.cogvlm_dual_expert[2]": (
        test_archs_wave5.test_cogvlm_dual_expert, 2, ""),
    "wave6.exaone_equals_llama[0]": (
        test_archs_wave6.test_exaone_equals_llama, 0, ""),
    "wave6.exaone_equals_llama[1]": (
        test_archs_wave6.test_exaone_equals_llama, 1, ""),
    "wave6.minicpm_equals_prefolded_llama[0]": (
        test_archs_wave6.test_minicpm_equals_prefolded_llama, 0, ""),
    "wave6.minicpm_equals_prefolded_llama[1]": (
        test_archs_wave6.test_minicpm_equals_prefolded_llama, 1, ""),
    "wave6.granitemoe_parity[0]": (
        test_archs_wave6.test_granitemoe_parity, 0, ""),
    "wave6.granitemoe_shared_parity[0]": (
        test_archs_wave6.test_granitemoe_shared_parity, 0, ""),
    "wave6.llama_embed_bidirectional_hidden[0]": (
        test_archs_wave6.test_llama_embed_bidirectional_hidden, 0, ""),
    "wave6.llama_embed_bidirectional_hidden[1]": (
        test_archs_wave6.test_llama_embed_bidirectional_hidden, 1, ""),
    "diffusion.llada_conversion_equals_llama_body[0]": (
        test_diffusion.test_llada_conversion_equals_llama_body, 0, ""),
    "diffusion.llada_conversion_equals_llama_body[1]": (
        test_diffusion.test_llada_conversion_equals_llama_body, 1, ""),
    "diffusion.diffusion_generate_fills_all[0]": (
        test_diffusion.test_diffusion_generate_fills_all, 0, ""),
    "diffusion.diffusion_algs_and_blocks[0]": (
        test_diffusion.test_diffusion_algs_and_blocks, 0, ""),
    "diffusion.diffusion_prompt_conditioning[0]": (
        test_diffusion.test_diffusion_prompt_conditioning, 0, ""),
    "diffusion.diffusion_shift_logits[0]": (
        test_diffusion.test_diffusion_shift_logits, 0, ""),
    "llama4.llama4_moe_parity[0]": (test_llama4.test_llama4_moe_parity, 0, ""),
    "ssm.convert_mamba_roundtrip[0]": (
        test_ssm.test_convert_mamba_roundtrip, 0, "ssm"),
    "mamba2.mamba2_parity[0]": (test_mamba2.test_mamba2_parity, 0, "ssm"),
    "mamba2.mamba2_state_carry[0]": (
        test_mamba2.test_mamba2_state_carry, 0, ""),
}


@pytest.mark.parametrize("case", list(CASES))
def test_writer_converts_like_jax(case, tmp_path, monkeypatch):
    test_fn, nth, check = CASES[case]
    src, kw = jax_source(test_fn, tmp_path, monkeypatch, nth)
    ssm = test_fn.__module__ in ("test_ssm", "test_mamba2")
    out = convert_both(src, tmp_path / "c", config=not ssm, **kw)
    if check == "ssm":
        ssm_forward_case(out, monkeypatch)
    elif check:
        forward_case(out)
