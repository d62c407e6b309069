"""The port's HF converter against the JAX package's on the JAX tests' own
writers (``tests/test_archs_clones.py``, ``tests/test_archs_clones2.py``,
``tests/test_convert.py``).

Each case runs a JAX test up to its ``nth`` ``convert_hf`` call
(``_torch_convert.jax_source``) and converts the HF directory it handed
over with both converters (the port on the CPU, with the call's own
``dtype_hp``): the checkpoints equal array for array, ``config_from_hf``
equal field for field.  The cases the port's tests already hold to the JAX
forward (``tests/test_torch_archs_mla2.py``: minicpm3, plm) are held again,
the port's checkpoint loaded by the port against the JAX forward of the JAX
converter's.  The writers' vision checkpoints and unported families are
refused (``tests/test_torch_convert.py``).
"""

import pytest

pytest.importorskip("transformers")

import test_archs_clones  # noqa: E402
import test_archs_clones2  # noqa: E402
import test_convert  # noqa: E402
from _torch_convert import (  # noqa: E402
    convert_both,
    forward_case,
    jax_source,
)

# id -> (the JAX test, which of its conversions, the forward check)
CASES = {
    "clones.baichuan_equals_llama[0]": (
        test_archs_clones.test_baichuan_equals_llama, 0, ""),
    "clones.baichuan_equals_llama[1]": (
        test_archs_clones.test_baichuan_equals_llama, 1, ""),
    "clones.baichuan_13b_alibi_detect[0]": (
        test_archs_clones.test_baichuan_13b_alibi_detect, 0, ""),
    "clones.xverse_equals_llama[0]": (
        test_archs_clones.test_xverse_equals_llama, 0, ""),
    "clones.xverse_equals_llama[1]": (
        test_archs_clones.test_xverse_equals_llama, 1, ""),
    "clones.orion_equals_stablelm_full_rotary[0]": (
        test_archs_clones.test_orion_equals_stablelm_full_rotary, 0, ""),
    "clones.orion_equals_stablelm_full_rotary[1]": (
        test_archs_clones.test_orion_equals_stablelm_full_rotary, 1, ""),
    "clones.qwen_v1_equals_qwen2[0]": (
        test_archs_clones.test_qwen_v1_equals_qwen2, 0, ""),
    "clones.qwen_v1_equals_qwen2[1]": (
        test_archs_clones.test_qwen_v1_equals_qwen2, 1, ""),
    "clones.jais_conversion[0]": (
        test_archs_clones.test_jais_conversion, 0, ""),
    "clones.minicpm3_equals_deepseek_mla[0]": (
        test_archs_clones.test_minicpm3_equals_deepseek_mla, 0, ""),
    "clones.minicpm3_equals_deepseek_mla[1]": (
        test_archs_clones.test_minicpm3_equals_deepseek_mla, 1, "mla"),
    "clones.maincoder_equals_hunyuan_dense[0]": (
        test_archs_clones.test_maincoder_equals_hunyuan_dense, 0, ""),
    "clones.maincoder_equals_hunyuan_dense[1]": (
        test_archs_clones.test_maincoder_equals_hunyuan_dense, 1, ""),
    "clones.pangu_embedded_biases[0]": (
        test_archs_clones.test_pangu_embedded_biases, 0, ""),
    "clones.pangu_embedded_biases[1]": (
        test_archs_clones.test_pangu_embedded_biases, 1, ""),
    "clones2.chatglm_equals_qwen2_with_glm_rope[0]": (
        test_archs_clones2.test_chatglm_equals_qwen2_with_glm_rope, 0, ""),
    "clones2.chatglm_equals_qwen2_with_glm_rope[1]": (
        test_archs_clones2.test_chatglm_equals_qwen2_with_glm_rope, 1, ""),
    "clones2.codeshell_equals_starcoder2[0]": (
        test_archs_clones2.test_codeshell_equals_starcoder2, 0, ""),
    "clones2.codeshell_equals_starcoder2[1]": (
        test_archs_clones2.test_codeshell_equals_starcoder2, 1, ""),
    "clones2.refact_equals_llama_alibi[0]": (
        test_archs_clones2.test_refact_equals_llama_alibi, 0, ""),
    "clones2.refact_equals_llama_alibi[1]": (
        test_archs_clones2.test_refact_equals_llama_alibi, 1, ""),
    "clones2.plamo_gqa_shuffle_equals_expanded_mha[0]": (
        test_archs_clones2.test_plamo_gqa_shuffle_equals_expanded_mha, 0, ""),
    "clones2.plamo_gqa_shuffle_equals_expanded_mha[1]": (
        test_archs_clones2.test_plamo_gqa_shuffle_equals_expanded_mha, 1, ""),
    "clones2.plm_attention_equals_deepseek_mla[0]": (
        test_archs_clones2.test_plm_attention_equals_deepseek_mla, 0, "mla"),
    "clones2.plm_attention_equals_deepseek_mla[1]": (
        test_archs_clones2.test_plm_attention_equals_deepseek_mla, 1, ""),
    "clones2.plm_ffn_equals_arcee_relu2[0]": (
        test_archs_clones2.test_plm_ffn_equals_arcee_relu2, 0, ""),
    "clones2.plm_ffn_equals_arcee_relu2[1]": (
        test_archs_clones2.test_plm_ffn_equals_arcee_relu2, 1, ""),
    "clones2.llada_moe_equals_qwen3_moe_bidirectional[0]": (
        test_archs_clones2.test_llada_moe_equals_qwen3_moe_bidirectional,
        0, ""),
    "clones2.llada_moe_equals_qwen3_moe_bidirectional[1]": (
        test_archs_clones2.test_llada_moe_equals_qwen3_moe_bidirectional,
        1, ""),
    "convert.requantize_i2_i1_exact[0]": (
        test_convert.test_requantize_i2_i1_exact, 0, ""),
}


@pytest.mark.parametrize("case", list(CASES))
def test_writer_converts_like_jax(case, tmp_path, monkeypatch):
    test_fn, nth, check = CASES[case]
    src, kw = jax_source(test_fn, tmp_path, monkeypatch, nth)
    ssm = test_fn.__module__ in ("test_ssm", "test_mamba2")
    out = convert_both(src, tmp_path / "c", config=not ssm, **kw)
    if check:
        forward_case(out, jax_cached=False)
