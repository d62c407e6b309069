"""The port's audio encoders (``vlut_tpu_torch/models/audio.py``) against
the JAX package's ``vlut_tpu/models/audio.py``.

The host frontend (filterbank, log-mel, WAV reading) and ``init_params``
are array-equal; ``encode`` of every projector and lfm2-a's
``conformer_encode`` are within 1e-5 of the largest output of the JAX
function on the same inputs (the conformer also within the JAX test's
tolerance of that test's own torch twin); the converter writes the same
files from the JAX tests' voxtral source, a qwen2-audio source and an
ultravox layout written from seeded arrays.
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

from vlut_tpu.models import audio as ja  # noqa: E402
from vlut_tpu_torch.bench import audio_zoo as az  # noqa: E402
from vlut_tpu_torch.convert.from_jax import tower_from_numpy  # noqa: E402
from vlut_tpu_torch.models import audio as pa  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5


def jcfg(cfg):
    return ja.AudioConfig(**dataclasses.asdict(cfg))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def leaves(tree, prefix=""):
    """(dotted name, numpy array) of a tree of tensors or arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, (tree.numpy() if torch.is_tensor(tree)
                       else np.asarray(tree))


def assert_trees_equal(port, jax_tree, ordered: bool = True):
    """The same leaves, names (in order unless ``ordered`` is False:
    ``jax.tree.map`` sorts a dict's keys), dtypes and values."""
    a, b = dict(leaves(port)), dict(leaves(jax_tree))
    assert (list(a) == list(b)) if ordered else (sorted(a) == sorted(b))
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


CONFIGS = [az.TINY, pa.AudioConfig(),
           dataclasses.replace(az.TINY, n_mels=80, n_fft=400, hop=160,
                               sample_rate=16000)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["tiny", "whisper_v3",
                                              "whisper_80"])
def test_frontend_array_equal(cfg, tmp_path):
    """``mel_filterbank`` and ``log_mel`` (1 s of seeded noise and of a
    tone) equal the JAX package's bit for bit."""
    assert np.array_equal(pa.mel_filterbank(cfg), ja.mel_filterbank(
        jcfg(cfg)))
    rng = np.random.default_rng(3)
    n = cfg.sample_rate
    for samples in ((rng.standard_normal(n) * 0.1).astype(np.float32),
                    np.sin(np.linspace(0, 900, n)).astype(np.float32)):
        got, want = pa.log_mel(samples, cfg), ja.log_mel(samples, jcfg(cfg))
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2])
def test_load_wav_array_equal(channels, tmp_path):
    """A 16-bit WAV read at its own rate and resampled to half and double
    of it: the JAX package's arrays."""
    rng = np.random.default_rng(channels)
    pcm = rng.integers(-30000, 30000, (3201, channels)).astype("<i2")
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(1600)
        f.writeframes(pcm.tobytes())
    for rate in (1600, 800, 3200):
        cfg = dataclasses.replace(az.TINY, sample_rate=rate)
        got, want = pa.load_wav(str(path), cfg), ja.load_wav(str(path),
                                                             jcfg(cfg))
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("proj", list(az.PROJECTORS))
def test_init_params_array_equal(proj):
    cfg = az.tiny_config(proj)
    assert_trees_equal(pa.init_params(cfg, seed=11),
                       ja.init_params(jcfg(cfg), seed=11))


@pytest.mark.parametrize("seconds", [1.0, 0.83])
@pytest.mark.parametrize("proj", list(az.PROJECTORS))
def test_encode_matches_jax(proj, seconds):
    """``encode`` of each projector within 1e-5 of the largest output, on
    weights whose biases and norms are perturbed away from 0 / 1, and at
    0.83 s a frame count whose stride-2 positions do not fill the stack
    (ultravox and glma pad, voxtral truncates)."""
    cfg = az.tiny_config(proj)
    params = az.perturbed(pa.init_params(cfg, seed=5), 6)
    mel = az.seeded_mel(cfg, seconds, 7)
    t2 = -(-mel.shape[0] // 2)
    if seconds != 1.0:
        assert t2 % cfg.stack_factor != 0
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params,
                      is_leaf=torch.is_tensor)
    want = np.asarray(ja.encode(jp, jcfg(cfg), jnp.asarray(mel)))
    with torch.inference_mode():
        got = pa.encode(params, cfg, torch.from_numpy(mel))
    assert got.dtype == torch.float32
    assert rel(got, want) <= TOL
    if proj == "glma":  # the BOI / EOI rows verbatim
        assert torch.equal(got[0], params["proj"]["boi"])
        assert torch.equal(got[-1], params["proj"]["eoi"])


def test_whole_chunk_overflows_the_positions():
    """A fault of the reference, left as it is: a WAV of exactly
    ``chunk_len_s`` seconds gives one log-mel frame more than whisper's
    (the reflect padding), so ``n_ctx + 1`` positions meet ``n_ctx``
    learned ones and both packages raise; one hop less fits."""
    cfg = dataclasses.replace(az.TINY, n_ctx=750)   # 30 s at 1600 / 32 / 2
    params = pa.init_params(cfg, seed=1)
    jp = ja.init_params(jcfg(cfg), seed=1)
    n = cfg.chunk_len_s * cfg.sample_rate
    for samples, fits in ((np.zeros(n, np.float32), False),
                          (np.zeros(n - cfg.hop, np.float32), True)):
        mel = pa.log_mel(samples, cfg)
        assert mel.shape[0] == n // cfg.hop + (0 if fits else 1)
        if fits:
            assert pa.encode(params, cfg, torch.from_numpy(mel)).shape[0] == (
                -(-750 // cfg.stack_factor))
            continue
        with pytest.raises(RuntimeError):
            pa.encode(params, cfg, torch.from_numpy(mel))
        with pytest.raises((TypeError, ValueError)):
            ja.encode(jp, jcfg(cfg), jnp.asarray(mel))


def test_rel_shift_and_table_equal():
    rng = np.random.default_rng(2)
    bd = rng.standard_normal((3, 7, 13)).astype(np.float32)
    got = pa._rel_shift(torch.from_numpy(bd)).numpy()
    assert np.array_equal(got, np.asarray(ja._rel_shift(jnp.asarray(bd))))
    for t, d in ((1, 4), (9, 32), (40, 512)):
        assert np.array_equal(pa.rel_pos_emb(t, d), ja.rel_pos_emb(t, d))


def test_conformer_matches_jax_and_its_torch_twin(monkeypatch):
    """The JAX conformer test run to its end with ``conformer_encode`` and
    its closing comparison recorded: the port on the test's own params and
    mel within 1e-5 of the JAX result, and within the test's rtol 2e-4 /
    atol 2e-5 of its torch transcription of the reference graph."""
    import test_audio

    calls, compared = [], []
    real_enc, real_close = ja.conformer_encode, np.testing.assert_allclose

    def spy(params, cfg, mel):
        out = real_enc(params, cfg, mel)
        calls.append((params, cfg, mel, out))
        return out

    def close(got, want, *a, **kw):
        compared.append(want)
        return real_close(got, want, *a, **kw)

    monkeypatch.setattr(ja, "conformer_encode", spy)
    monkeypatch.setattr(np.testing, "assert_allclose", close)
    test_audio.test_lfm2a_conformer_twin()
    monkeypatch.setattr(np.testing, "assert_allclose", real_close)
    (params, cfg, mel, out), = calls
    pcfg = pa.ConformerConfig(**dataclasses.asdict(cfg))
    tree = tower_from_numpy(jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        got = pa.conformer_encode(tree, pcfg, torch.from_numpy(
            np.array(mel))).numpy()
    assert rel(got, out) <= TOL
    np.testing.assert_allclose(got, compared[-1], rtol=2e-4, atol=2e-5)


def test_conformer_matches_jax_at_other_widths():
    """``conformer_encode`` on ``bench/audio_zoo.py``'s tree at a frame
    count and mel width that leave the stride-2 stages ragged."""
    cfg = dataclasses.replace(az.TINY_CONFORMER, n_mels=20, n_heads=2,
                              conv_kernel=9, n_layers=3)
    params = az.conformer_params(cfg, 4)
    mel = np.random.default_rng(5).standard_normal((45, 20)).astype(
        np.float32)
    want = np.asarray(ja.conformer_encode(
        jax.tree.map(jnp.asarray, params),
        ja.ConformerConfig(**dataclasses.asdict(cfg)), jnp.asarray(mel)))
    with torch.inference_mode():
        got = pa.conformer_encode(tower_from_numpy(params), cfg,
                                  torch.from_numpy(mel)).numpy()
    assert rel(got, want) <= TOL


def assert_dirs_equal(a, b, config: str, arrays: str):
    """Two encoder / vocoder directories: the same config text and the
    same arrays (names in order, dtypes, shapes, values)."""
    assert (a / config).read_text() == (b / config).read_text()
    da, db = np.load(a / arrays), np.load(b / arrays)
    assert da.files == db.files
    for k in da.files:
        x, y = da[k], db[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


def _voxtral_source(tmp_path):
    """The JAX voxtral test run to its end (its source written under
    ``tmp_path / "hf"``, the JAX conversion under ``"out"``)."""
    import test_audio

    test_audio.test_voxtral_parity(tmp_path)
    return tmp_path / "hf"


def test_voxtral_conversion_and_hf_parity(tmp_path):
    """The JAX voxtral test's HF source: ``convert-audio`` writes the JAX
    converter's files (its post-LayerNorm found through the first-match
    ``pick`` in the file's data order), and the port's ``encode`` equals
    HF's ``get_audio_features`` at the JAX test's rtol 2e-4 / atol 2e-5,
    and the JAX ``encode`` within 1e-5."""
    import transformers

    from vlut_tpu_torch import cli

    src = _voxtral_source(tmp_path)
    cli.main(["convert-audio", str(src), str(tmp_path / "port"), "--d-llm",
              "48", "--device", "cpu"])
    assert_dirs_equal(tmp_path / "port", tmp_path / "out",
                      "audio_config.json", "audio.npz")
    cfg, params = pa.load_audio_encoder(tmp_path / "port", device="cpu")
    assert cfg.projector == "voxtral" and cfg.stack_factor == 2
    m = transformers.VoxtralForConditionalGeneration.from_pretrained(
        str(src)).float().eval()
    mel = np.random.default_rng(7).standard_normal((16, 128)).astype(
        np.float32)
    with torch.no_grad():
        want = m.get_audio_features(torch.tensor(mel)[None]).numpy()
        got = pa.encode(params, cfg, torch.from_numpy(mel.T)).numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=2e-4,
                               atol=2e-5)
    jc, jp = ja.load_audio_encoder(str(tmp_path / "out"))
    assert rel(got, ja.encode(jp, jc, jnp.asarray(mel.T))) <= TOL


def test_pick_order_is_the_data_order(tmp_path):
    """The converter reads a safetensors file in the order of its data, as
    ``safetensors.numpy.load_file`` yields it, not by name."""
    from safetensors.numpy import load_file

    from vlut_tpu_torch.convert.checkpoint import write_safetensors

    rng = np.random.default_rng(0)
    arrays = {n: rng.standard_normal(s).astype(dt) for n, s, dt in (
        ("b.layer_norm.weight", (3,), np.float32),
        ("a.layers.0.layer_norm.weight", (3,), np.float64),
        ("c", (2, 2), np.float16))}
    write_safetensors(tmp_path / "x.safetensors", arrays)
    # the port's writer lays tensors out by name; safetensors by dtype size
    from safetensors.numpy import save_file
    save_file(arrays, str(tmp_path / "y.safetensors"))
    for f in ("x", "y"):
        got = pa.hf_file_tensors(tmp_path / f"{f}.safetensors")
        want = load_file(str(tmp_path / f"{f}.safetensors"))
        assert list(got) == list(want)
        assert all(np.array_equal(got[k], want[k].astype(got[k].dtype))
                   for k in got)
    assert list(pa.hf_file_tensors(tmp_path / "y.safetensors"))[0] == (
        "a.layers.0.layer_norm.weight")
    assert pa.picker(pa.hf_file_tensors(tmp_path / "y.safetensors"))(
        "layer_norm.weight").shape == (3,)


def _qwen2_audio_source(tmp_path):
    import transformers

    c = transformers.Qwen2AudioConfig(
        audio_config=dict(num_mel_bins=16, encoder_layers=2,
                          encoder_attention_heads=4, d_model=32,
                          encoder_ffn_dim=64, max_source_positions=64),
        text_config=dict(vocab_size=96, hidden_size=48, num_hidden_layers=1,
                         num_attention_heads=4, num_key_value_heads=2,
                         intermediate_size=64, max_position_embeddings=64))
    torch.manual_seed(91)
    m = transformers.Qwen2AudioForConditionalGeneration(c).float().eval()
    with torch.no_grad():
        for _, p in m.named_parameters():
            p.copy_(0.05 * torch.randn_like(p))
    m.save_pretrained(str(tmp_path / "hf"), safe_serialization=True)
    return m, tmp_path / "hf"


def test_qwen2_audio_conversion_and_encode(tmp_path):
    """A qwen2-audio source built from a config in code: both converters
    write the same files (``qwen2a``, heads from ``audio_config``), the
    port's ``encode`` is within 1e-5 of the JAX one.  Against HF: a fault
    of the reference, left as it is: the JAX encoder omits qwen2-audio's
    stride-2 average pool before the post-LayerNorm, so it returns twice
    HF's rows."""
    from vlut_tpu_torch import cli

    m, src = _qwen2_audio_source(tmp_path)
    jc = ja.convert_hf_audio(str(src), str(tmp_path / "jax"), d_llm=48)
    cli.main(["convert-audio", str(src), str(tmp_path / "port"), "--d-llm",
              "48", "--device", "cpu"])
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax",
                      "audio_config.json", "audio.npz")
    assert jc.projector == "qwen2a" and jc.n_heads == 4
    cfg, params = pa.load_audio_encoder(tmp_path / "port", device="cpu")
    mel = np.random.default_rng(8).standard_normal((128, 16)).astype(
        np.float32)
    with torch.inference_mode():
        got = pa.encode(params, cfg, torch.from_numpy(mel)).numpy()
    _, jp = ja.load_audio_encoder(str(tmp_path / "jax"))
    assert rel(got, ja.encode(jp, jc, jnp.asarray(mel))) <= TOL
    with torch.no_grad():
        feats = m.audio_tower(torch.from_numpy(mel.T)[None]).last_hidden_state
        want = m.multi_modal_projector(feats)[0].numpy()
    assert got.shape == (64, 48) and want.shape == (32, 48)


@pytest.mark.parametrize("d_llm", [48, 64])
def test_ultravox_conversion_equal(tmp_path, d_llm):
    """An ultravox layout written from seeded arrays
    (``bench/audio_zoo.py:write_ultravox_source``): both converters write
    the same files, and the encoder read back by each package encodes
    within 1e-5."""
    from vlut_tpu_torch import cli

    cfg = dataclasses.replace(az.TINY, d_llm=d_llm)
    src = az.write_ultravox_source(tmp_path / "hf", cfg, seed=d_llm,
                                   proj_hidden=24)
    jc = ja.convert_hf_audio(str(src), str(tmp_path / "jax"), d_llm=d_llm)
    cli.main(["convert-audio", str(src), str(tmp_path / "port"), "--d-llm",
              str(d_llm), "--device", "cpu"])
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax",
                      "audio_config.json", "audio.npz")
    assert jc.projector == "ultravox" and jc.stack_factor == 8
    pc, pp = pa.load_audio_encoder(tmp_path / "port", device="cpu")
    assert json.loads((tmp_path / "port" / "audio_config.json").read_text()
                      ) == dataclasses.asdict(pc)
    mel = az.seeded_mel(pc, 1.0, 9)
    _, jp = ja.load_audio_encoder(str(tmp_path / "jax"))
    with torch.inference_mode():
        got = pa.encode(pp, pc, torch.from_numpy(mel))
    assert rel(got, ja.encode(jp, jc, jnp.asarray(mel))) <= TOL


def test_audio_entries_hold_tf32_off(monkeypatch):
    """Every product and convolution of ``encode`` (each projector),
    ``conformer_encode`` and the vocoder's ``decode_codes`` runs with TF32
    off for matmuls and cuDNN convolutions, whatever the caller allows,
    and the caller's settings come back after."""
    import torch.nn.functional as F

    from vlut_tpu_torch.device import tf32
    from vlut_tpu_torch.models import vocoder as pv

    mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    seen = []

    def spy(fn):
        def call(*a, **kw):
            seen.append((mm.fp32_precision, conv.fp32_precision))
            return fn(*a, **kw)
        return call

    for name in ("conv1d", "conv2d", "linear"):
        monkeypatch.setattr(F, name, spy(getattr(F, name)))
    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        spy(torch.Tensor.__matmul__))
    with tf32(matmul=True, conv=True), torch.inference_mode():
        for proj in az.PROJECTORS:
            cfg = az.tiny_config(proj)
            params = tower_from_numpy(pa.init_params(cfg, seed=1), "cpu")
            pa.encode(params, cfg, torch.from_numpy(az.seeded_mel(cfg, 0.5,
                                                                  1)))
        cp = tower_from_numpy(az.conformer_params(az.TINY_CONFORMER, 1),
                              "cpu")
        pa.conformer_encode(cp, az.TINY_CONFORMER,
                            torch.zeros((32, az.TINY_CONFORMER.n_mels)))
        vp = pv.init_params(az.TINY_VOCODER, seed=1)
        pv.decode_codes(vp, az.TINY_VOCODER, np.arange(12))
        assert (mm.fp32_precision, conv.fp32_precision) == ("tf32", "tf32")
    assert len(seen) > 100 and set(seen) == {("ieee", "ieee")}
