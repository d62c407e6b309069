"""``cli describe --image`` of the port against the JAX package's
``cmd_describe`` on a tiny LLaVA checkpoint (an HF
``LlavaForConditionalGeneration`` built from a config in code, its
language projections exact ternary), and the CLIP tower + llava
projector against HF's own image features.

The JAX side runs with ``VLUT_TPU_MATMUL_IMPL=pallas_interpret`` (the
Pallas kernels the port follows); the port's ``describe`` runs the fused
tree on the CPU.  Greedy tokens must be equal.
"""

from __future__ import annotations

import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, __import__("os").path.dirname(__file__))
from _torch_convert import FIXTURE, _TOKENIZER_FILES, convert_both  # noqa

torch.set_num_threads(1)

V, D, IMG, PS = 256, 64, 16, 8


def _llava(feature_layer: int = -2, strategy: str = "default",
           act: str = "gelu"):
    import transformers

    c = transformers.LlavaConfig(
        text_config=dict(
            model_type="llama", vocab_size=V, hidden_size=D,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=96,
            max_position_embeddings=256, rms_norm_eps=1e-5,
            tie_word_embeddings=False),
        vision_config=dict(
            model_type="clip_vision_model", hidden_size=32,
            num_hidden_layers=3, num_attention_heads=4, intermediate_size=48,
            image_size=IMG, patch_size=PS, projection_dim=32,
            hidden_act="quick_gelu"),
        vision_feature_layer=feature_layer,
        vision_feature_select_strategy=strategy,
        image_token_index=V - 1, projector_hidden_act=act)
    return transformers.LlavaForConditionalGeneration(c)


def llava_source(tmp_path, seed: int = 0):
    """A tiny LLaVA HF directory (tiny_real's tokenizer beside it): the
    language projections exact ternary at 0.05 (logits far from ties), the
    embeddings and the tower random."""
    from test_archs_hf import _ternarize_model

    torch.manual_seed(seed)
    m = _llava().float().eval()
    _ternarize_model(m.model.language_model, seed=seed, scale=0.05)
    with torch.no_grad():
        m.model.language_model.embed_tokens.weight.normal_(0, 1.0)
        m.lm_head.weight.normal_(0, 0.05)
    src = tmp_path / "hf"
    m.save_pretrained(str(src), safe_serialization=True)
    for f in _TOKENIZER_FILES:
        if (FIXTURE / f).exists():
            shutil.copy(FIXTURE / f, src / f)
    return m, src


def _image(tmp_path, seed: int = 5):
    from PIL import Image

    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(arr).save(path)
    return path


def _tokens_of(main, argv, monkeypatch, tok_cls) -> list[int]:
    """The ids a CLI's ``describe`` decodes (its tokenizer's ``decode``
    recorded)."""
    seen: list[list[int]] = []
    real = tok_cls.decode

    def spy(self, ids):
        seen.append(list(ids))
        return real(self, ids)

    monkeypatch.setattr(tok_cls, "decode", spy)
    main(argv)
    monkeypatch.setattr(tok_cls, "decode", real)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("prompt", ["The <image> little", "<image>Q:",
                                    "no marker"])
def test_describe_tokens_equal_jax(prompt, tmp_path, monkeypatch, capsys):
    """``describe --image file.png --device cpu``: the JAX
    ``cmd_describe``'s greedy tokens on the converted checkpoints (equal
    arrays, vision sidecar included), with the prompt split on <image>,
    the image first, or no marker (the image after the prompt's text)."""
    from vlut_tpu import cli as jcli
    from vlut_tpu.utils.tokenizer import Tokenizer as JTok
    from vlut_tpu_torch import cli
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    _, src = llava_source(tmp_path)
    out = convert_both(src, tmp_path)
    img = str(_image(tmp_path))
    monkeypatch.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
    want = _tokens_of(jcli.main, ["describe", "--model",
                                  str(tmp_path / "conv_jax"), "--image", img,
                                  "-p", prompt, "-n", "10"], monkeypatch,
                      JTok)
    got = _tokens_of(cli.main, ["describe", "--model", str(out), "--image",
                                img, "-p", prompt, "-n", "10", "--device",
                                "cpu"], monkeypatch, Tokenizer)
    assert got == want
    assert "[vision tower: clip-llava]" in capsys.readouterr().err


def test_describe_audio_names_item_8b(tmp_path):
    """``describe --audio`` is refused, naming ROADMAP item 8b."""
    from vlut_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="item 8b"):
        cli.main(["describe", "--model", str(tmp_path), "--audio", "a.wav",
                  "--device", "cpu"])


def test_clip_tower_against_hf_llava(tmp_path):
    """The port's CLIP tower + llava projector (the JAX package's: tanh
    gelu in both) against HF ``LlavaForConditionalGeneration``'s image
    features (CLIP-L's quick_gelu, llava's exact-gelu projector).  The
    port equals the JAX tower exactly; the gap to HF is the reference's
    choice of activation, measured here and written down in ROADMAP's
    faults of the reference: with HF's activations put in its place the
    port's math equals HF's to float rounding."""
    from vlut_tpu_torch.convert.checkpoint import _load_tower, load_vision
    from vlut_tpu_torch.models import vision as pv

    m, src = llava_source(tmp_path, seed=3)
    out = convert_both(src, tmp_path)
    vcfg, _ = load_vision(out, device="cpu")
    # the sidecar's float32 weights (load_vision rounds them to bf16)
    vp32 = _load_tower(out, "vision.safetensors", "cpu")
    rng = np.random.default_rng(9)
    pix = rng.standard_normal((1, 3, IMG, IMG)).astype(np.float32)
    with torch.no_grad():
        want = m.model.get_image_features(
            torch.from_numpy(pix), vision_feature_layer=-2,
            vision_feature_select_strategy="default")
        want = torch.cat(list(want), 0) if isinstance(
            want, (list, tuple)) else want.reshape(-1, D)
        img = torch.from_numpy(pix.transpose(0, 2, 3, 1))
        got = pv.encode_image(vp32, vcfg, img)[0]
        gap = float((got - want).abs().max() / want.abs().max())
        # HF's activations in the port's tower: equal to float rounding
        real = torch.nn.functional.gelu

        def hf_acts(x, approximate="none"):
            if x.shape[-1] == vcfg.d_ff:            # CLIP's quick_gelu
                return x * torch.sigmoid(1.702 * x)
            return real(x)                          # llava's exact gelu

        torch.nn.functional.gelu = hf_acts
        try:
            exact = pv.encode_image(vp32, vcfg, img)[0]
        finally:
            torch.nn.functional.gelu = real
    assert float((exact - want).abs().max() / want.abs().max()) < 1e-5
    # tanh gelu for quick_gelu and exact gelu: the activation gap shows
    assert 1e-3 < gap < 0.5, gap


def test_describe_stops_after_end_of_sequence():
    """``describe`` cuts its greedy tokens after the first end of sequence
    among the decoded ones (the JAX loop's break), whatever the first
    token is; with none it returns ``n_predict`` tokens."""
    import types

    from vlut_tpu_torch.cli import describe
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.models import vision as pv
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    cfg, model, _ = load_checkpoint(FIXTURE, device="cpu")
    vcfg = pv.VisionConfig(image_size=16, patch_size=8, d_model=32,
                           n_layers=1, n_heads=2, d_ff=48, d_llm=cfg.d_model)
    emb = pv.encode_image(pv.init_params(vcfg, seed=1), vcfg,
                          torch.ones((1, 16, 16, 3)))[0]
    enc = Tokenizer(FIXTURE).encode
    full = describe(model, cfg, types.SimpleNamespace(encode=enc,
                                                      eos_id=None),
                    emb, "The <image> little", 9)
    assert len(full) == 9
    for at in (0, 3):
        stop = types.SimpleNamespace(encode=enc, eos_id=full[at])
        got = describe(model, cfg, stop, emb, "The <image> little", 9)
        cut = full.index(full[at], 1) + 1 if full[at] in full[1:] else 9
        assert got == full[:cut]
