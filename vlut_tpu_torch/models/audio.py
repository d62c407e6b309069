"""Audio encoders and their projectors (port of ``vlut_tpu/models/audio.py``).

A whisper-style encoder feeds audio embeddings into the decoder as tokens:
the log-mel frontend (host numpy, a copy of the JAX package's: the same
float64 Hann window, slaney filterbank and whisper normalisation, so its
output is array-equal), a two-convolution erf-GELU stem with a stride-2
downsampling, a pre-LN encoder (LayerNorm with bias; q/v biases, no k
bias) and a projector into the decoder's embedding space:

- ``ultravox``: frames zero-padded to a multiple of the stack and stacked,
  RMS norm, a SwiGLU whose *second* half goes through silu, RMS norm,
  linear;
- ``voxtral``: frames truncated to a multiple of the stack and stacked,
  a no-bias erf-GELU MLP;
- ``music_flamingo``: a biased erf-GELU MLP on the frames;
- ``glma``: a biased LayerNorm, stacking, a biased *tanh*-GELU MLP, the
  learned BOI / EOI rows around the result;
- ``qwen2a``: one biased linear.

lfm2-a's conformer (:func:`conformer_encode`) is ported beside it.  The
towers, projectors and conformer are float32 throughout, as the JAX
package keeps them; no Pallas kernel stands behind any of them, so they
are plain PyTorch products and convolutions on the tensors' device, each
entry run with TF32 off (``device.full_float32``), whatever the caller's
setting.  Embeddings splice
into the decoder through ``forward``'s ``token_embeds``
(``models/vision.py:build_multimodal_embeds``).

:func:`convert_hf_audio` writes the JAX package's encoder directory
(``audio_config.json`` + ``audio.npz``) from an HF ultravox, qwen2-audio
or voxtral checkpoint, reading safetensors through the port's own reader
in the order ``safetensors.numpy.load_file`` yields (data offset order):
its ``pick`` takes the first name holding every substring, so the order
decides which tensor a loose substring finds.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from vlut_tpu_torch.device import full_float32


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    n_mels: int = 128
    n_fft: int = 400
    hop: int = 160
    sample_rate: int = 16000
    chunk_len_s: int = 30          # whisper fixed 30 s chunks
    d_model: int = 1280            # whisper-large-v3 encoder width
    n_layers: int = 32
    n_heads: int = 20
    d_ff: int = 5120
    n_ctx: int = 1500              # post-stride-2 positions (30 s)
    layer_norm_eps: float = 1e-5
    d_llm: int = 4096              # decoder embedding width
    projector: str = "ultravox"    # ultravox|voxtral|music_flamingo|glma|qwen2a
    stack_factor: int = 8          # ultravox StackAudioFrames
    proj_hidden: int = 4096        # ultravox swiglu hidden width


# --- the host frontend (numpy, copied from the JAX package) -------------------

def mel_filterbank(cfg: AudioConfig) -> np.ndarray:
    """(n_mels, n_fft//2+1) slaney-scale triangular filters with area
    normalization (librosa's defaults)."""
    fmin, fmax = 0.0, 0.5 * cfg.sample_rate
    min_log_hz = 1000.0
    lin_slope = 3.0 / 200.0
    min_log_mel = min_log_hz * lin_slope
    log_step = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(
            f < min_log_hz, f * lin_slope,
            min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
            / log_step,
        )

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(
            m < min_log_mel, m / lin_slope,
            min_log_hz * np.exp((m - min_log_mel) * log_step),
        )

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), cfg.n_mels + 2)
    hz = mel_to_hz(mel_pts)
    n_bins = cfg.n_fft // 2 + 1
    f = np.arange(n_bins) * (cfg.sample_rate / cfg.n_fft)
    left, center, right = hz[:-2, None], hz[1:-1, None], hz[2:, None]
    up = (f[None] - left) / np.maximum(center - left, 1e-30)
    down = (right - f[None]) / np.maximum(right - center, 1e-30)
    w = np.maximum(0.0, np.minimum(up, down))
    enorm = 2.0 / np.maximum(right[:, 0] - left[:, 0], 1e-30)
    return (w * enorm[:, None]).astype(np.float32)


def log_mel(samples: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """(n_samples,) mono float -> (n_frames, n_mels) normalized log-mel.

    Periodic Hann window (float64), power spectrum, slaney mel, log10
    floored at 1e-10, clamp to the global max - 8, (x + 4) / 4.  The
    signal is reflect-padded by n_fft // 2 on both sides, so n samples give
    1 + n // hop frames: a whole 30 s chunk gives 3001, one more than
    whisper's 3000 (trim the samples to whisper's frames first).
    """
    n_fft, hop = cfg.n_fft, cfg.hop
    pad = n_fft // 2
    x = np.pad(samples.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * (
        0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    )
    power = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = power @ mel_filterbank(cfg).T                # (T, n_mels)
    logm = np.log10(np.maximum(mel, 1e-10))
    logm = np.maximum(logm, logm.max() - 8.0)
    return (((logm + 4.0) / 4.0)).astype(np.float32)


def load_wav(path: str, cfg: AudioConfig) -> np.ndarray:
    """16-bit PCM WAV -> mono float32 at cfg.sample_rate (nearest-sample
    resample)."""
    import wave

    with wave.open(str(path)) as f:
        sr = f.getframerate()
        n = f.getnframes()
        raw = np.frombuffer(f.readframes(n), dtype="<i2").astype(np.float32)
        raw = raw.reshape(-1, f.getnchannels()).mean(-1) / 32768.0
    if sr != cfg.sample_rate:
        idx = np.clip(
            (np.arange(int(len(raw) * cfg.sample_rate / sr))
             * (sr / cfg.sample_rate)).astype(np.int64),
            0, len(raw) - 1,
        )
        raw = raw[idx]
    return raw


# --- the whisper encoder ------------------------------------------------------

def _ln(x, w, b, eps):
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * w + b


def _rms(x, w, eps=1e-6):
    xf = x.to(torch.float32)
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * w


def _conv1d(x, w, b, stride=1):
    """x: (C_in, T); w: (C_out, C_in, K); padding K//2 on both sides, so a
    stride of 2 gives ceil(T / 2) positions."""
    k = w.shape[-1]
    y = F.conv1d(x[None], w, stride=stride, padding=k // 2)[0]
    return y + b[:, None]


def _layout(cfg: AudioConfig, rand, zeros, ones) -> dict[str, Any]:
    """The encoder + projector tree: ``rand(*shape)`` for the weights in
    the JAX package's draw order, ``zeros`` / ``ones`` for the biases and
    norms (all float32)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    layers = {
        "ln1_w": ones(L, d), "ln1_b": zeros(L, d),
        "ln2_w": ones(L, d), "ln2_b": zeros(L, d),
        # whisper attention: q and v carry biases, k does not
        "wq": rand(L, d, d), "bq": zeros(L, d),
        "wk": rand(L, d, d),
        "wv": rand(L, d, d), "bv": zeros(L, d),
        "wo": rand(L, d, d), "bo": zeros(L, d),
        "w1": rand(L, d, f), "b1": zeros(L, f),
        "w2": rand(L, f, d), "b2": zeros(L, d),
    }
    params: dict[str, Any] = {
        "conv1_w": rand(d, cfg.n_mels, 3), "conv1_b": zeros(d),
        "conv2_w": rand(d, d, 3), "conv2_b": zeros(d),
        "pos": rand(cfg.n_ctx, d),
        "layers": layers,
        "post_ln_w": ones(d), "post_ln_b": zeros(d),
    }
    ds = d * cfg.stack_factor
    if cfg.projector == "ultravox":
        params["proj"] = {
            "norm_pre": ones(ds), "w1": rand(ds, 2 * cfg.proj_hidden),
            "norm_mid": ones(cfg.proj_hidden),
            "w2": rand(cfg.proj_hidden, cfg.d_llm),
        }
    elif cfg.projector == "voxtral":
        params["proj"] = {"w1": rand(ds, cfg.d_llm),
                          "w2": rand(cfg.d_llm, cfg.d_llm)}
    elif cfg.projector == "music_flamingo":
        params["proj"] = {
            "w1": rand(d, cfg.d_llm), "b1": zeros(cfg.d_llm),
            "w2": rand(cfg.d_llm, cfg.d_llm), "b2": zeros(cfg.d_llm),
        }
    elif cfg.projector == "glma":
        params["proj"] = {
            "norm_pre_w": ones(d), "norm_pre_b": zeros(d),
            "w1": rand(ds, cfg.d_llm), "b1": zeros(cfg.d_llm),
            "w2": rand(cfg.d_llm, cfg.d_llm), "b2": zeros(cfg.d_llm),
            "boi": rand(cfg.d_llm), "eoi": rand(cfg.d_llm),
        }
    else:  # qwen2a
        params["proj"] = {"fc_w": rand(d, cfg.d_llm),
                          "fc_b": zeros(cfg.d_llm)}
    return params


def init_params(cfg: AudioConfig, seed: int = 0,
                device="cpu") -> dict[str, Any]:
    """Random encoder + projector weights from a numpy generator, the JAX
    package's draws (weights N(0, 0.02) rounded once to float32, biases 0,
    norms 1 / 0): equal to its ``init_params(cfg, seed)`` bit for bit."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        a = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        return torch.from_numpy(a).to(device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return _layout(cfg, rand, zeros, ones)


def init_params_fast(cfg: AudioConfig, seed: int = 0,
                     device="cpu") -> dict[str, Any]:
    """:func:`init_params`' layout drawn on ``device`` by a seeded
    ``torch.Generator`` (not the JAX package's draws): whisper-large-v3's
    tower in a fraction of a second."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    return _layout(cfg, rand, zeros, ones)


@full_float32()
def encode_tower(params, cfg: AudioConfig, mel: torch.Tensor) -> torch.Tensor:
    """(T_frames, n_mels) log-mel -> (ceil(T_frames / 2), d_model) encoder
    frames after the post-LayerNorm: conv1d + erf gelu, stride-2 conv1d +
    erf gelu, + learned positions, the pre-LN encoder."""
    eps = cfg.layer_norm_eps
    x = _conv1d(mel.T.to(torch.float32), params["conv1_w"], params["conv1_b"])
    x = F.gelu(x)
    x = _conv1d(x, params["conv2_w"], params["conv2_b"], stride=2)
    x = F.gelu(x).T                                   # (T/2, d)
    t = x.shape[0]
    x = x + params["pos"][:t]
    lp = params["layers"]
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    for il in range(cfg.n_layers):
        res = x
        y = _ln(x, lp["ln1_w"][il], lp["ln1_b"][il], eps)
        q = y @ lp["wq"][il] + lp["bq"][il]
        k = y @ lp["wk"][il]
        v = y @ lp["wv"][il] + lp["bv"][il]
        q = q.reshape(t, h, hd).transpose(0, 1)
        k = k.reshape(t, h, hd).transpose(0, 1)
        v = v.reshape(t, h, hd).transpose(0, 1)
        att = torch.softmax((q @ k.transpose(1, 2)) / float(np.sqrt(hd)),
                            dim=-1)
        y = (att @ v).transpose(0, 1).reshape(t, cfg.d_model)
        y = y @ lp["wo"][il] + lp["bo"][il]
        x = res + y
        res = x
        y = _ln(x, lp["ln2_w"][il], lp["ln2_b"][il], eps)
        y = F.gelu(y @ lp["w1"][il] + lp["b1"][il])
        y = y @ lp["w2"][il] + lp["b2"][il]
        x = res + y
    return _ln(x, params["post_ln_w"], params["post_ln_b"], eps)


def _stack_frames(x: torch.Tensor, s: int, pad: bool) -> torch.Tensor:
    """(T, d) -> (T' , s * d) rows of s consecutive frames: zero-padded to
    a multiple of s, or truncated to one."""
    t, d = x.shape
    if pad:
        x = F.pad(x, (0, 0, 0, (-t) % s))
    else:
        x = x[: t - t % s]
    return x.reshape(x.shape[0] // s, s * d)


@full_float32()
def project(params, cfg: AudioConfig, x: torch.Tensor) -> torch.Tensor:
    """Encoder frames (T, d_model) -> decoder embeddings (T', d_llm) by the
    config's projector."""
    pr = params["proj"]
    s = cfg.stack_factor
    if cfg.projector == "ultravox":
        x = _rms(_stack_frames(x, s, pad=True), pr["norm_pre"])
        g = x @ pr["w1"]
        half = g.shape[-1] // 2
        # swapped swiglu: the SECOND half goes through silu
        g = F.silu(g[:, half:]) * g[:, :half]
        return _rms(g, pr["norm_mid"]) @ pr["w2"]
    if cfg.projector == "voxtral":
        g = F.gelu(_stack_frames(x, s, pad=False) @ pr["w1"])
        return g @ pr["w2"]
    if cfg.projector == "music_flamingo":
        g = F.gelu(x @ pr["w1"] + pr["b1"])
        return g @ pr["w2"] + pr["b2"]
    if cfg.projector == "glma":
        x = _ln(x, pr["norm_pre_w"], pr["norm_pre_b"], cfg.layer_norm_eps)
        x = _stack_frames(x, s, pad=True)
        g = F.gelu(x @ pr["w1"] + pr["b1"], approximate="tanh")
        x = g @ pr["w2"] + pr["b2"]
        return torch.cat([pr["boi"][None], x, pr["eoi"][None]], dim=0)
    return x @ pr["fc_w"] + pr["fc_b"]


def encode(params, cfg: AudioConfig, mel: torch.Tensor) -> torch.Tensor:
    """(T_frames, n_mels) log-mel -> (T_out, d_llm) decoder embeddings,
    float32 on the parameters' device (:func:`encode_tower` then
    :func:`project`)."""
    return project(params, cfg, encode_tower(params, cfg, mel))


# --- the converter and the encoder directory ----------------------------------

def hf_file_tensors(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    """name -> float array of one safetensors file, in the order of the
    entries' data (the order ``safetensors.numpy.load_file`` yields, which
    the JAX converters read), BF16 upcast exactly."""
    from vlut_tpu_torch.convert.checkpoint import (safetensors_open,
                                                   safetensors_tensor)
    from vlut_tpu_torch.convert.convert import _float_of

    mm, header, base = safetensors_open(path)
    order = sorted(header, key=lambda n: header[n]["data_offsets"])
    return {name: _float_of(safetensors_tensor(mm, base, name, header[name]),
                            header[name]["dtype"]) for name in order}


def hf_tensors(src: str | pathlib.Path) -> dict[str, np.ndarray]:
    """Every ``*.safetensors`` of ``src`` by sorted file name, through
    :func:`hf_file_tensors`."""
    tensors: dict[str, np.ndarray] = {}
    for fp in sorted(pathlib.Path(src).glob("*.safetensors")):
        tensors.update(hf_file_tensors(fp))
    return tensors


def picker(tensors: dict[str, np.ndarray], what: str = ""):
    """``pick(*subs)``: the first tensor (in ``tensors``' order) whose name
    holds every substring, as float32."""
    def pick(*subs):
        for name, v in tensors.items():
            if all(s in name for s in subs):
                return np.asarray(v, np.float32)
        raise KeyError(f"no tensor matching {subs}{what}")
    return pick


def convert_hf_audio(src: str, dst: str, d_llm: int = 4096,
                     device: str | torch.device | None = None) -> AudioConfig:
    """HF ultravox / qwen2-audio / voxtral checkpoint -> the audio-encoder
    directory the JAX package's converter writes (the same config and the
    same arrays under the same names).  Every operation is host numpy, as
    the family converters' are; ``device`` keeps the port's rule (the GPU
    unless the CPU is asked for)."""
    from vlut_tpu_torch.device import resolve_device

    resolve_device(device)
    src_p = pathlib.Path(src)
    tensors = hf_tensors(src_p)
    pick = picker(tensors)

    conv1 = pick("conv1.weight")
    n_layers = 1 + max(
        int(n.split("layers.")[1].split(".")[0])
        for n in tensors
        # ultravox/qwen2a nest ...encoder.layers.N; voxtral's tower is
        # flat audio_tower.layers.N
        if "encoder.layers." in n or "audio_tower.layers." in n
    )
    fc1 = pick("layers.0.fc1.weight")
    has_12 = any("linear_1" in n for n in tensors)
    # ultravox's projector carries ln_pre/ln_mid norms; voxtral's is the
    # bare no-bias linear_1/linear_2 GELU MLP over intermediate-width
    # stacked frames
    is_ultravox = has_12 and any("ln_mid" in n for n in tensors)
    is_voxtral = has_12 and not is_ultravox
    proj = ("ultravox" if is_ultravox
            else "voxtral" if is_voxtral else "qwen2a")
    heads = conv1.shape[0] // 64  # whisper convention fallback
    cfg_json = src_p / "config.json"
    if cfg_json.exists():
        ac = json.loads(cfg_json.read_text()).get("audio_config", {})
        heads = ac.get("num_attention_heads",
                       ac.get("encoder_attention_heads", heads)) or heads
    cfg = AudioConfig(
        n_mels=conv1.shape[1], d_model=conv1.shape[0],
        n_layers=n_layers, d_ff=fc1.shape[0],
        n_heads=heads,
        projector=proj, d_llm=d_llm,
        stack_factor=(fc1.shape[0] // conv1.shape[0]
                      if is_voxtral else 8),
    )

    def stack(sub, transpose=True):
        out = []
        for i in range(cfg.n_layers):
            w = pick(f"layers.{i}.{sub}")
            out.append(w.T if transpose and w.ndim == 2 else w)
        return np.stack(out)

    # voxtral's post-LayerNorm is audio_tower.layer_norm.*: a loose
    # "layer_norm.weight" finds it first because the file lays it out
    # before audio_tower.layers.* (see hf_tensors)
    flat_post = any("audio_tower.layer_norm." in n for n in tensors)
    params = {
        "conv1_w": conv1, "conv1_b": pick("conv1.bias"),
        "conv2_w": pick("conv2.weight"), "conv2_b": pick("conv2.bias"),
        "pos": pick("embed_positions.weight"),
        "layers": {
            "ln1_w": stack("self_attn_layer_norm.weight", False),
            "ln1_b": stack("self_attn_layer_norm.bias", False),
            "ln2_w": stack("final_layer_norm.weight", False),
            "ln2_b": stack("final_layer_norm.bias", False),
            "wq": stack("self_attn.q_proj.weight"),
            "bq": stack("self_attn.q_proj.bias", False),
            "wk": stack("self_attn.k_proj.weight"),
            "wv": stack("self_attn.v_proj.weight"),
            "bv": stack("self_attn.v_proj.bias", False),
            "wo": stack("self_attn.out_proj.weight"),
            "bo": stack("self_attn.out_proj.bias", False),
            "w1": stack("fc1.weight"), "b1": stack("fc1.bias", False),
            "w2": stack("fc2.weight"), "b2": stack("fc2.bias", False),
        },
        "post_ln_w": pick("layer_norm.weight") if flat_post
        else pick("encoder.layer_norm.weight"),
        "post_ln_b": pick("layer_norm.bias") if flat_post
        else pick("encoder.layer_norm.bias"),
    }
    if is_ultravox:
        params["proj"] = {
            "norm_pre": pick("projector", "ln_pre.weight"),
            "w1": pick("projector", "linear_1.weight").T,
            "norm_mid": pick("projector", "ln_mid.weight"),
            "w2": pick("projector", "linear_2.weight").T,
        }
    elif is_voxtral:
        params["proj"] = {
            "w1": pick("projector", "linear_1.weight").T,
            "w2": pick("projector", "linear_2.weight").T,
        }
    else:
        params["proj"] = {
            "fc_w": pick("projector", "linear.weight").T,
            "fc_b": pick("projector", "linear.bias"),
        }
    out_p = pathlib.Path(dst)
    out_p.mkdir(parents=True, exist_ok=True)
    (out_p / "audio_config.json").write_text(
        json.dumps(dataclasses.asdict(cfg), indent=1))
    np.savez(out_p / "audio.npz", **flatten(params))
    return cfg


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A tree of dicts (and lists, keyed by index) -> ``a.b.0.c`` names, in
    the tree's order."""
    flat: dict[str, np.ndarray] = {}
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {prefix: np.asarray(tree)}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return flat


def unflatten(data) -> dict[str, Any]:
    """``np.load``'s npz -> the tree of numpy arrays (dotted names)."""
    tree: dict[str, Any] = {}
    for key in data.files:
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[key]
    return tree


def load_audio_encoder(path: str, device=None
                       ) -> tuple[AudioConfig, dict[str, Any]]:
    """An encoder directory -> (config, tree of float32 tensors on
    ``device``: the GPU unless the CPU is asked for)."""
    from vlut_tpu_torch.convert.from_jax import tower_from_numpy
    from vlut_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    p = pathlib.Path(path)
    cfg = AudioConfig(**json.loads((p / "audio_config.json").read_text()))
    return cfg, tower_from_numpy(unflatten(np.load(p / "audio.npz")), dev)


# --- lfm2-a's conformer encoder -----------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    n_mels: int = 128
    d_sub: int = 32        # subsampling conv channels
    d_model: int = 512
    n_layers: int = 16
    n_heads: int = 8
    d_ff: int = 2048
    conv_kernel: int = 9
    d_llm: int = 2048

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rel_shift(bd: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift as a gather: bd (H, Q, P=2Q-1) with
    relative positions ordered +max..-max -> bd'[h, i, j] = bd[h, i, j +
    (Q - 1) - i], (H, Q, Q)."""
    h, q, _ = bd.shape
    ar = torch.arange(q, device=bd.device)
    idx = ar[None, :] - ar[:, None] + (q - 1)
    return torch.gather(bd, 2, idx[None].expand(h, q, q))


def rel_pos_emb(t: int, d: int) -> np.ndarray:
    """Sinusoidal relative position table (2T-1, d), positions T-1 ..
    -(T-1) (NeMo's RelPositionalEncoding order)."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d))
    ang = pos[:, None] * inv[None]
    out = np.zeros((2 * t - 1, d), np.float64)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out.astype(np.float32)


def _conv2d_hwio(x, w, b, stride, groups=1):
    """NCHW x by an HWIO weight (the JAX package's layout); (1, 1) padding
    for the 3 x 3 stages only."""
    pad = 1 if w.shape[0] == 3 else 0
    y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad,
                 groups=groups)
    return y + b[None, :, None, None]


@full_float32()
def conformer_encode(params, cfg: ConformerConfig,
                     mel: torch.Tensor) -> torch.Tensor:
    """(T, n_mels) -> (T/8, d_llm) decoder embeddings: three stride-2
    subsampling stages over (time, frequency), macaron conformer blocks
    with Transformer-XL relative-position attention, a LayerNorm + erf-GELU
    adapter."""
    x = mel.to(torch.float32)[None, None]              # (1, 1, T, F)
    x = torch.relu(_conv2d_hwio(x, params["sub0_w"], params["sub0_b"], 2))
    x = _conv2d_hwio(x, params["sub2_w"], params["sub2_b"], 2,
                     groups=cfg.d_sub)
    x = torch.relu(_conv2d_hwio(x, params["sub3_w"], params["sub3_b"], 1))
    x = _conv2d_hwio(x, params["sub5_w"], params["sub5_b"], 2,
                     groups=cfg.d_sub)
    x = torch.relu(_conv2d_hwio(x, params["sub6_w"], params["sub6_b"], 1))
    t_out, f_out = x.shape[2], x.shape[3]
    # the NHWC flatten: frequency major, channel minor
    x = x[0].permute(1, 2, 0).reshape(t_out, f_out * cfg.d_sub)
    x = x @ params["sub_out_w"] + params["sub_out_b"]   # (T', D)

    pos = torch.from_numpy(rel_pos_emb(t_out, cfg.d_model)).to(x.device)
    hh, hd = cfg.n_heads, cfg.head_dim

    def ln(v, w, b):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + 1e-5) * w + b

    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        res = x
        # macaron FFN 1 (silu, half residual)
        h = ln(x, lp["ff1_ln_w"], lp["ff1_ln_b"])
        h = F.silu(h @ lp["ff1_up_w"] + lp["ff1_up_b"])
        h = h @ lp["ff1_down_w"] + lp["ff1_down_b"]
        res = res + 0.5 * h
        # relative-position self-attention
        h = ln(res, lp["attn_ln_w"], lp["attn_ln_b"])
        q = (h @ lp["wq"] + lp["bq"]).reshape(t_out, hh, hd)
        k = (h @ lp["wk"] + lp["bk"]).reshape(t_out, hh, hd)
        v = (h @ lp["wv"] + lp["bv"]).reshape(t_out, hh, hd)
        p = (pos @ lp["pos_w"]).reshape(-1, hh, hd)    # (2T'-1, H, hd)
        ac = torch.einsum("qhd,khd->hqk", q + lp["pos_bias_u"], k)
        bd = torch.einsum("qhd,phd->hqp", q + lp["pos_bias_v"], p)
        scores = (ac + _rel_shift(bd)) / float(np.sqrt(hd))
        att = torch.softmax(scores, dim=-1)
        o = torch.einsum("hqk,khd->qhd", att, v).reshape(t_out, -1)
        res = res + (o @ lp["wo"] + lp["bo"])
        # conv module: sigmoid GLU, depthwise SAME conv over time
        h = ln(res, lp["conv_ln_w"], lp["conv_ln_b"])
        h = h @ lp["pw1_w"] + lp["pw1_b"]              # (T', 2D)
        half = h.shape[-1] // 2
        h = h[:, :half] * torch.sigmoid(h[:, half:])
        kw = lp["dw_w"]                                # (K, D)
        h = F.conv1d(h.T[None], kw.T[:, None, :], padding=cfg.conv_kernel // 2,
                     groups=h.shape[-1])[0].T + lp["dw_b"]
        h = h * lp["conv_norm_w"] + lp["conv_norm_b"]
        h = F.silu(h)
        res = res + (h @ lp["pw2_w"] + lp["pw2_b"])
        # macaron FFN 2 (half residual)
        h = ln(res, lp["ff2_ln_w"], lp["ff2_ln_b"])
        h = F.silu(h @ lp["ff2_up_w"] + lp["ff2_up_b"])
        h = h @ lp["ff2_down_w"] + lp["ff2_down_b"]
        res = res + 0.5 * h
        x = ln(res, lp["out_ln_w"], lp["out_ln_b"])

    # audio adapter: LN -> erf-GELU MLP
    x = ln(x, params["ada_ln_w"], params["ada_ln_b"])
    h = F.gelu(x @ params["ada_w1"] + params["ada_b1"])
    return h @ params["ada_w2"] + params["ada_b2"]
