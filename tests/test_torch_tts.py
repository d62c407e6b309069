"""The port's TTS pipeline (``vlut_tpu_torch/runtime/tts.py``) and WavTokenizer
vocoder (``models/vocoder.py``) against the JAX package's.

Array-equal: the text frontend, ``save_wav``'s bytes, the vocoder's
``init_params`` and the converter's files.  ``decode_codes`` within 1e-5
of the largest output, ``spectrogram_to_audio`` within 1e-4 of the largest
sample (and within the JAX test's 2e-4 of its numpy port of the
reference's O(n^2) ISTFT).  ``synthesize`` on the JAX test's setting and
on tiny_real: the sampled streams equal, every step's logits within 1e-5
of the largest on tiny_real (2e-2 on the random tiny preset, see
:data:`LOGITS_TOL`), the waveform within 1e-4.  Also the ``outetts_0_2_500m`` preset and the
tokenizer's special ids, and the card's tts tokenizer.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __import__("os").path.dirname(__file__))

import test_tts  # noqa: E402
from _torch_convert import FIXTURE  # noqa: E402
from vlut_tpu.models import vocoder as jv  # noqa: E402
from vlut_tpu.runtime import tts as jt  # noqa: E402
from vlut_tpu_torch.bench import audio_zoo as az  # noqa: E402
from vlut_tpu_torch.convert.from_jax import tower_from_numpy  # noqa: E402
from vlut_tpu_torch.models import vocoder as pv  # noqa: E402
from vlut_tpu_torch.runtime import tts as pt  # noqa: E402

torch.set_num_threads(1)


def jvcfg(cfg):
    return jv.VocoderConfig(**dataclasses.asdict(cfg))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree,
                        is_leaf=torch.is_tensor)


NUMBERS = ["0", "7", "42", "100", "1234", "3.14", "2000000", "1000000001",
           "19.05", "12.", "", "x", "999999999999"]


def test_text_frontend_equal():
    for n in NUMBERS:
        assert pt.number_to_words(n) == jt.number_to_words(n), n
    texts = ["Hello, World! I have 2 cats.", "It's 3.5 km/h -- a_b\\c",
             "  Spaces\tand\nlines 1,000 ", "", "Ünïcode & 12 dots..."]
    for text in texts:
        assert (pt.replace_numbers_with_words(text)
                == jt.replace_numbers_with_words(text))
        for version in ("0.2", "0.3"):
            assert (pt.process_text(text, version)
                    == jt.process_text(text, version))
    spk = {"words": [{"word": "hi", "duration": 0.08, "codes": [3, 7]},
                     {"word": "there", "duration": 0.2049, "codes": [1]},
                     {"word": "you", "duration": 1.0, "codes": []}]}
    for version in ("0.2", "0.3"):
        assert pt.speaker_text(spk, version) == jt.speaker_text(spk, version)
        assert pt.speaker_data(spk, version) == jt.speaker_data(spk, version)
    fake = test_tts._FakeTok()
    for text in ("ab<|text_sep|>cd", "a<|text_sep|><|text_sep|>b", "x"):
        assert (pt.prepare_guide_tokens(fake, text)
                == jt.prepare_guide_tokens(fake, text))


def test_guide_tokens_and_code_range_on_tokenizers(tmp_path):
    """``prepare_guide_tokens`` and ``detect_code_range`` through the
    port's Tokenizer (and its ``CharWordLevel``) and the JAX package's, on
    tiny_real (no ``<|0|>``: both raise) and on tiny_real's vocabulary
    with ``<|0|>`` .. ``<|9|>`` added."""
    from transformers import AutoTokenizer

    from vlut_tpu.utils.tokenizer import Tokenizer as JTok
    from vlut_tpu_torch.utils.tokenizer import CharWordLevel, Tokenizer

    hf = AutoTokenizer.from_pretrained(str(FIXTURE))
    hf.add_special_tokens({"additional_special_tokens": [
        f"<|{i}|>" for i in range(10)]})
    hf.save_pretrained(str(tmp_path / "codes"))
    processed = pt.process_text("Hello there, 2 cats")
    for path, has_codes in ((FIXTURE, False), (tmp_path / "codes", True)):
        jtok, ptok = JTok(path), Tokenizer(path)
        char = Tokenizer.__new__(Tokenizer)
        char.tk = CharWordLevel(path)
        for tok in (ptok, char):
            assert (pt.prepare_guide_tokens(tok, processed)
                    == jt.prepare_guide_tokens(jtok, processed))
            if has_codes:
                assert pt.detect_code_range(tok) == jt.detect_code_range(jtok)
            else:
                with pytest.raises(ValueError, match="code-offset"):
                    pt.detect_code_range(tok)
        if not has_codes:
            with pytest.raises(ValueError, match="code-offset"):
                jt.detect_code_range(jtok)


def test_char_tokenizer_special_ids_match_hf(tmp_path):
    """``CharWordLevel.all_special_ids`` and ``get_added_vocab`` are what
    Hugging Face's fast tokenizer reports for the same files (its order:
    bos, eos, unk, ..., then the additional special tokens)."""
    from transformers import AutoTokenizer

    from vlut_tpu_torch.utils.tokenizer import CharWordLevel

    hf = AutoTokenizer.from_pretrained(str(FIXTURE))
    hf.add_special_tokens({"pad_token": "<0x00>",
                           "additional_special_tokens": ["<|0|>", "<|1|>"]})
    hf.save_pretrained(str(tmp_path / "more"))
    for path in (FIXTURE, tmp_path / "more"):
        hf = AutoTokenizer.from_pretrained(str(path))
        ours = CharWordLevel(path)
        assert ours.all_special_ids == hf.all_special_ids
        assert ours.get_added_vocab() == hf.get_added_vocab()
        assert ours.encode("a<|1|>b") == hf.encode("a<|1|>b")


def test_outetts_tokenizer_one_token_per_code(tmp_path):
    """``audio_zoo.outetts_tokenizer`` (the card's tts cell): Hugging
    Face's fast tokenizer and ``CharWordLevel`` read its files alike; each
    ``<|N|>`` code, duration and markup is one token at its id, the codes
    at OuteTTS-0.2's range; ``prefill_rows`` counts the phase's prompt
    through it: more than 64 rows (the tiled GEMM's), and a code in the
    profile one row."""
    from transformers import AutoTokenizer

    from vlut_tpu_torch.utils.tokenizer import CharWordLevel, Tokenizer

    path = az.outetts_tokenizer(FIXTURE, tmp_path / "outetts")
    hf = Tokenizer.__new__(Tokenizer)
    hf.tk = AutoTokenizer.from_pretrained(str(path))
    char = Tokenizer.__new__(Tokenizer)
    char.tk = CharWordLevel(path)
    added = az.outetts_added_tokens()
    assert char.tk.get_added_vocab() == hf.tk.get_added_vocab()
    assert added.items() <= hf.tk.get_added_vocab().items()
    assert char.tk.all_special_ids == hf.tk.all_special_ids
    spk = az.speaker_profile(27)
    ids, processed = pt.prompt_ids(hf, az.TTS_TEXT, spk)
    assert pt.prompt_ids(char, az.TTS_TEXT, spk) == (ids, processed)
    assert (pt.prepare_guide_tokens(char, processed)
            == pt.prepare_guide_tokens(hf, processed))
    assert max(ids) < 157696  # outetts_0_2_500m's vocabulary
    for tok in (hf, char):
        assert tok.encode("<|0|><|4099|><|t_0.35|>\n", add_bos=False) == [
            151672, 155771, added["<|t_0.35|>"], 10]
        assert pt.detect_code_range(tok) == (151672, 155771)
    n_codes = sum(len(w["codes"]) for w in spk["words"])
    assert sum(151672 <= i <= 155771 for i in ids) == n_codes
    rows = az.prefill_rows(FIXTURE)["tts"]
    assert rows == len(ids) > 64


def test_save_wav_bytes_equal(tmp_path):
    rng = np.random.default_rng(0)
    audio = np.concatenate([rng.standard_normal(2400) * 0.5,
                            [1.5, -1.5, 1.0, -1.0, 0.0]]).astype(np.float32)
    pt.save_wav(str(tmp_path / "p.wav"), audio, 24000)
    jt.save_wav(str(tmp_path / "j.wav"), audio, 24000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


VOCODERS = {"tiny": az.TINY_VOCODER,
            "tiny_istft1280": dataclasses.replace(az.TINY_VOCODER, n_out=1282),
            "posnet8": dataclasses.replace(az.TINY_VOCODER, posnet_layers=8,
                                           convnext_layers=3)}


@pytest.mark.parametrize("name", list(VOCODERS))
def test_vocoder_init_params_equal(name):
    from test_torch_audio import assert_trees_equal

    cfg = VOCODERS[name]
    assert_trees_equal(pv.init_params(cfg, seed=3),
                       jv.init_params(jvcfg(cfg), seed=3))


@pytest.mark.parametrize("name", list(VOCODERS))
def test_decode_codes_and_istft_match_jax(name):
    """``decode_codes`` (weights perturbed off their 0 / 1 / 0.01 fills)
    within 1e-5, ``spectrogram_to_audio`` of its output within 1e-4."""
    cfg = VOCODERS[name]
    params = az.perturbed(pv.init_params(cfg, seed=4), 5, scale=0.02)
    codes = np.random.default_rng(6).integers(0, cfg.vocab_size, 23)
    jp = to_jax(params)
    want = jv.decode_codes(jp, jvcfg(cfg), jnp.asarray(codes, jnp.int32))
    with torch.inference_mode():
        got = pv.decode_codes(params, cfg, codes)
        wave_got = pv.spectrogram_to_audio(got, cfg)
    assert rel(got, want) <= 1e-5
    wave_want = jv.spectrogram_to_audio(want, jvcfg(cfg))
    assert rel(wave_got, wave_want) <= 1e-4


@pytest.mark.parametrize("t", [1, 5, 40])
def test_istft_matches_jax_and_the_reference_port(t):
    """The default ISTFT (n_fft 1280, hop 320) of seeded spectrograms:
    within 1e-4 of the JAX package's largest sample, and within the JAX
    test's 2e-4 of its numpy port of the reference's DFT and fold."""
    cfg = pv.VocoderConfig()
    embd = np.random.default_rng(t).standard_normal((t, cfg.n_out)).astype(
        np.float32)
    with torch.inference_mode():
        got = pv.spectrogram_to_audio(torch.from_numpy(embd), cfg).numpy()
    want = np.asarray(jv.spectrogram_to_audio(jnp.asarray(embd), jvcfg(cfg)))
    assert rel(got, want) <= 1e-4
    if t <= 5:
        ref = test_tts._ref_embd_to_audio(embd.astype(np.float64), t,
                                          cfg.n_out)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_fold_order():
    """``_fold`` adds the four chunks in the JAX order, bit for bit."""
    x = np.random.default_rng(0).standard_normal((9, 32)).astype(np.float32)
    got = pv._fold(torch.from_numpy(x), 8).numpy()
    assert np.array_equal(got, np.asarray(jv._fold(jnp.asarray(x), 8)))


def test_vocoder_directories_read_both_ways(tmp_path):
    """A directory the port writes loads in the JAX package (and the
    other way), equal arrays and the same config."""
    cfg = az.TINY_VOCODER
    params = pv.init_params(cfg, seed=1)
    pv.save_vocoder(str(tmp_path / "p"), cfg, params)
    jv.save_vocoder(str(tmp_path / "j"), jvcfg(cfg),
                    jv.init_params(jvcfg(cfg), seed=1))
    from test_torch_audio import assert_dirs_equal, assert_trees_equal

    assert_dirs_equal(tmp_path / "p", tmp_path / "j", "vocoder_config.json",
                      "vocoder.npz")
    pc, pp = pv.load_vocoder(str(tmp_path / "j"), device="cpu")
    jc, jp = jv.load_vocoder(str(tmp_path / "p"))
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert isinstance(pp["posnet"], list) and isinstance(pp["convnext"], list)
    assert_trees_equal(pp, jax.tree.map(np.asarray, jp), ordered=False)


@pytest.mark.parametrize("fmt", ["safetensors", "safetensors_file", "bin"])
def test_vocoder_conversion_equal(fmt, tmp_path):
    """A WavTokenizer layout written from seeded arrays
    (``bench/audio_zoo.py:write_wavtokenizer_source``) as a safetensors
    directory, one safetensors file or a torch ``.bin``: ``convert-vocoder``
    writes the JAX converter's files; the vocoder read back decodes within
    1e-5 of the JAX one."""
    from test_torch_audio import assert_dirs_equal

    from vlut_tpu_torch import cli

    cfg = dataclasses.replace(az.TINY_VOCODER, group_norm_groups=32)
    if fmt == "bin":
        src = az.write_wavtokenizer_source(tmp_path / "hf" / "wt.bin", cfg,
                                           seed=2, fmt="bin")
    else:
        src = az.write_wavtokenizer_source(tmp_path / "hf", cfg, seed=2)
        if fmt == "safetensors_file":
            src = src / "model.safetensors"
    jc = jv.convert_hf_vocoder(str(src), str(tmp_path / "jax"))
    cli.main(["convert-vocoder", str(src), str(tmp_path / "port"),
              "--device", "cpu"])
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax",
                      "vocoder_config.json", "vocoder.npz")
    pc, pp = pv.load_vocoder(str(tmp_path / "port"), device="cpu")
    _, jp = jv.load_vocoder(str(tmp_path / "jax"))
    codes = np.arange(0, cfg.vocab_size, 3)
    with torch.inference_mode():
        got = pv.decode_codes(pp, pc, codes)
    assert rel(got, jv.decode_codes(jp, jc, jnp.asarray(codes))) <= 1e-5


def _tiny_setting(name: str = "tiny"):
    """The JAX TTS test's setting: the tiny preset (seed 0), its char stub
    tokenizer, the tiny vocoder (seed 2); or tiny_real (its trained weights
    and tokenizer, through each package's loader) with that vocoder."""
    from vlut_tpu.config import PRESETS as JPRESETS
    from vlut_tpu.models.transformer import init_params as llm_init
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.convert.from_jax import params_from_numpy

    if name == "tiny_real":
        from vlut_tpu.convert.checkpoint import load_checkpoint as jload
        from vlut_tpu.utils.tokenizer import Tokenizer as JTok
        from vlut_tpu_torch.convert.checkpoint import load_checkpoint
        from vlut_tpu_torch.utils.tokenizer import Tokenizer

        jcfg, jparams, _ = jload(FIXTURE, stream=False)
        jparams = jax.tree.map(jnp.asarray, jparams)
        cfg, model, _ = load_checkpoint(FIXTURE, device="cpu")
        toks = JTok(FIXTURE), Tokenizer(FIXTURE)
    else:
        jcfg = JPRESETS["tiny"]
        jparams = llm_init(jcfg, seed=0)
        cfg = PRESETS["tiny"]
        model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
        toks = (test_tts._CharTok(cfg.vocab_size),) * 2
    # the JAX test's vocoder at a tenth of its rate: its 0.25 s mute then
    # leaves samples to compare (at 2400 it silences the whole waveform)
    voc = jv.VocoderConfig(
        vocab_size=cfg.vocab_size, n_embd=16, posnet_d=32, convnext_d=32,
        n_ff=48, n_out=34, group_norm_groups=4, n_fft=32, hop=8,
        sample_rate=240)
    jvp = jv.init_params(voc, seed=2)
    return (jcfg, jparams, cfg, model, toks, voc, jvp,
            pv.VocoderConfig(**dataclasses.asdict(voc)),
            tower_from_numpy(jax.tree.map(np.asarray, jvp)))


def _recording(monkeypatch, module):
    """Spy on ``module._sample_top_k``: the logits of every step."""
    seen: list[np.ndarray] = []
    real = module._sample_top_k

    def spy(logits, k, rng, temp=1.0):
        seen.append(np.array(logits))
        return real(logits, k, rng, temp)

    monkeypatch.setattr(module, "_sample_top_k", spy)
    return seen


# the logits' tolerance: tiny_real (trained weights) within 1e-5 of the
# largest at every step; the tiny preset's random weights put activations
# at int8 rounding ties, where a last-ulp difference between XLA's and
# torch's float parts flips a code and moves that step's logits by about
# 1e-2 (the repo's other tiny-preset tests hold 2e-2 for that reason)
LOGITS_TOL = {"tiny": 2e-2, "tiny_real": 1e-5}


@pytest.mark.parametrize("name,text,guide,n", [
    ("tiny", "hi there", True, 16), ("tiny", "Say 4, ok", False, 24),
    ("tiny_real", "The little model reads", True, 24),
    ("tiny_real", "2 lines", False, 16)])
def test_synthesize_matches_jax(name, text, guide, n, monkeypatch):
    """``synthesize`` (code_offset 0) on the JAX test's setting and on
    tiny_real: the token streams equal (the same numpy generator on both
    sides), each step's logits within :data:`LOGITS_TOL` of the largest,
    the waveform within 1e-4 of the largest sample and its first quarter
    second muted."""
    monkeypatch.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
    (jcfg, jparams, cfg, model, (jtok, ptok), voc, jvp, pvoc,
     pvp) = _tiny_setting(name)
    streams = {}
    real_gen = {m: m.generate_codes for m in (jt, pt)}
    for mod in (jt, pt):
        def keep(*a, _m=mod, **kw):
            out = real_gen[_m](*a, **kw)
            streams[_m] = out
            return out
        monkeypatch.setattr(mod, "generate_codes", keep)
    want_lg = _recording(monkeypatch, jt)
    want = jt.synthesize(jcfg, jparams, jtok, text, voc, jvp, n_predict=n,
                         code_offset=0, use_guide_tokens=guide, seed=3)
    got_lg = _recording(monkeypatch, pt)
    got = pt.synthesize(cfg, model, ptok, text, pvoc, pvp, n_predict=n,
                        code_offset=0, use_guide_tokens=guide, seed=3)
    assert streams[pt] == streams[jt] and len(streams[pt]) == n
    assert len(got_lg) == len(want_lg) == n
    for a, b in zip(got_lg, want_lg):
        assert rel(a, b) <= LOGITS_TOL[name]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] > pvoc.sample_rate // 4
    assert rel(got, want) <= 1e-4
    assert np.all(got[:pvoc.sample_rate // 4] == 0.0)


def test_generate_codes_stops_and_reports(monkeypatch):
    """The loop stops at the end of sequence (appended) and at the
    context's end; ``stats`` counts a sampling and a step per token and
    holds the step program."""
    (_, _, cfg, model, (_, tok), *_) = _tiny_setting()
    prompt = tok.encode("<|im_start|>\nhello", add_bos=True)
    stats: dict = {}
    full = pt.generate_codes(cfg, model, tok, prompt, n_predict=12, seed=1,
                             stats=stats)
    assert len(full) == 12 and len(stats["sample_s"]) == 12
    assert len(stats["step_s"]) == 12 and stats["prompt_tokens"] == len(prompt)
    # the step program, replayed after the loop: the last step's logits
    last = stats["run"]()
    assert last.shape == (cfg.vocab_size,) and last.dtype == torch.float32
    tok.eos_id = full[4]
    cut = pt.generate_codes(cfg, model, tok, prompt, n_predict=12, seed=1)
    assert cut == full[:full.index(full[4]) + 1]
    tok.eos_id = 1
    short = pt.generate_codes(cfg, model, tok, prompt, n_predict=12, seed=1,
                              max_ctx=len(prompt) + 3)
    assert short == full[:3]


def test_cli_tts_writes_synthesize(tmp_path, monkeypatch):
    """``cli tts --device cpu`` on tiny_real with a tiny vocoder (guide
    tokens, a speaker profile, code offset 0) writes the WAV that
    ``synthesize`` + ``save_wav`` give on the same arguments."""
    from vlut_tpu_torch import cli
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    voc = dataclasses.replace(az.TINY_VOCODER, vocab_size=256,
                              sample_rate=2400)
    vp = pv.init_params(voc, seed=5)
    pv.save_vocoder(str(tmp_path / "voc"), voc, vp)
    spk = {"words": [{"word": "the", "duration": 0.1, "codes": [5, 9]}]}
    (tmp_path / "spk.json").write_text(json.dumps(spk))
    cli.main(["tts", "--model", str(FIXTURE), "--vocoder",
              str(tmp_path / "voc"), "-p", "The model, 2.",
              "-o", str(tmp_path / "cli.wav"), "--speaker",
              str(tmp_path / "spk.json"), "--guide-tokens", "-n", "40",
              "--seed", "4", "--code-offset", "0", "--device", "cpu"])
    cfg, model, _ = load_checkpoint(FIXTURE, device="cpu")
    audio = pt.synthesize(cfg, model, Tokenizer(FIXTURE),
                          "The model, 2.", voc, vp, speaker=spk,
                          use_guide_tokens=True, n_predict=40, seed=4,
                          code_offset=0)
    assert audio.shape[0] > 0
    pt.save_wav(str(tmp_path / "api.wav"), audio, voc.sample_rate)
    assert (tmp_path / "cli.wav").read_bytes() == (
        tmp_path / "api.wav").read_bytes()
    with wave.open(str(tmp_path / "cli.wav")) as f:
        assert f.getframerate() == 2400 and f.getnframes() == audio.shape[0]


def test_outetts_preset_is_the_converters(tmp_path):
    """``outetts_0_2_500m`` equals what the port's (and the JAX package's)
    ``config_from_hf`` makes of a Qwen2 ``config.json`` with
    OuteTTS-0.2-500M's fields, written here (Qwen2.5-0.5B's architecture,
    OuteTTS-0.2's vocabulary of 157,696)."""
    import pathlib

    from vlut_tpu.convert.convert import config_from_hf as jax_config
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.convert.convert import config_from_hf

    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
        "hidden_size": 896, "intermediate_size": 4864,
        "num_hidden_layers": 24, "num_attention_heads": 14,
        "num_key_value_heads": 2, "vocab_size": 157696,
        "max_position_embeddings": 32768, "rope_theta": 1000000.0,
        "rms_norm_eps": 1e-06, "tie_word_embeddings": True,
        "sliding_window": 32768, "use_sliding_window": False,
        "max_window_layers": 24, "hidden_act": "silu",
        "bos_token_id": 151643, "eos_token_id": 151645}))
    want = config_from_hf(pathlib.Path(tmp_path))
    assert PRESETS["outetts_0_2_500m"] == want
    assert dataclasses.asdict(jax_config(tmp_path)) == dataclasses.asdict(want)
