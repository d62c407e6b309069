"""WavTokenizer decoder (codes -> audio) for the TTS pipeline (port of
``vlut_tpu/models/vocoder.py``).

Code embeddings go through a conv1d stem, a 6-block "posnet" (ResNet
blocks of GroupNorm + SiLU at 0/1/3/4, one single-head self-attention
block at 2, a closing GroupNorm at 5), a token LayerNorm, a ConvNeXt stack
(depthwise conv7 + LayerNorm + erf-GELU MLP + learned gamma, residual) and
a linear head emitting an interleaved log-magnitude / phase spectrogram.
:func:`spectrogram_to_audio` turns it into a waveform as the reference's
``embd_to_audio`` does: mag = min(exp(m), 100), S = mag e^{i phi}, the
reference's irfft (which does not double the interior bins) per frame, a
periodic Hann window, overlap-add by four shifted adds (n_fft = 4 hop), and
a division by the window-envelope fold.

Everything is float32 on the parameters' device: plain PyTorch
convolutions and products (TF32 off inside :func:`decode_codes`,
``device.full_float32``), the batched irfft through ``torch.fft.irfft``
(no Pallas kernel stands behind any of it in the JAX package either).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from vlut_tpu_torch.device import full_float32


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """WavTokenizer-small decoder hparams."""

    vocab_size: int = 4096
    n_embd: int = 512          # code-embedding width (n_embd_features)
    posnet_d: int = 768        # posnet channel width
    posnet_layers: int = 6
    convnext_d: int = 768
    convnext_layers: int = 12
    n_ff: int = 2304
    n_out: int = 1282          # head width = 2 * (n_fft // 2 + 1)
    group_norm_groups: int = 32
    group_norm_eps: float = 1e-6
    layer_norm_eps: float = 1e-6
    n_fft: int = 1280
    hop: int = 320
    sample_rate: int = 24000


def _conv1d(x, w, b, groups: int = 1):
    """x: (C_in, T); w: (C_out, C_in/groups, K); SAME padding K//2."""
    k = w.shape[-1]
    return F.conv1d(x[None], w, padding=k // 2, groups=groups)[0] + b[:, None]


def _group_norm(x, w, b, groups: int, eps: float):
    """x: (C, T); each channel group normalized over (C/g, T)."""
    c, t = x.shape
    xg = x.reshape(groups, c // groups, t)
    mu = xg.mean((1, 2), keepdim=True)
    var = xg.var((1, 2), unbiased=False, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(c, t) * w[:, None] + b[:, None]


def _layer_norm(x, w, b, eps: float):
    """x: (T, C); per-token layernorm."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _layout(cfg: VocoderConfig, rand, full) -> dict[str, Any]:
    """The decoder tree: ``rand(*shape)`` for the weights in the JAX
    package's draw order (posnet, ConvNeXt, embeddings, stem, head),
    ``full(shape, value)`` for the biases, norms and gammas."""
    d, p, cn, f = cfg.n_embd, cfg.posnet_d, cfg.convnext_d, cfg.n_ff
    assert p % cfg.group_norm_groups == 0

    def ones(n):
        return full((n,), 1.0)

    def zeros(n):
        return full((n,), 0.0)

    posnet: list[dict[str, Any]] = []
    for il in range(cfg.posnet_layers):
        if il == 2:
            posnet.append({
                "attn_norm_w": ones(p), "attn_norm_b": zeros(p),
                "attn_q_w": rand(p, p, 1), "attn_q_b": zeros(p),
                "attn_k_w": rand(p, p, 1), "attn_k_b": zeros(p),
                "attn_v_w": rand(p, p, 1), "attn_v_b": zeros(p),
                "attn_o_w": rand(p, p, 1), "attn_o_b": zeros(p),
            })
        elif il == cfg.posnet_layers - 1:
            posnet.append({"norm_w": ones(p), "norm_b": zeros(p)})
        else:
            posnet.append({
                "norm1_w": ones(p), "norm1_b": zeros(p),
                "conv1_w": rand(p, p, 3), "conv1_b": zeros(p),
                "norm2_w": ones(p), "norm2_b": zeros(p),
                "conv2_w": rand(p, p, 3), "conv2_b": zeros(p),
            })
    convnext = [
        {
            "dw_w": rand(cn, 1, 7), "dw_b": zeros(cn),
            "norm_w": ones(cn), "norm_b": zeros(cn),
            "pw1_w": rand(cn, f), "pw1_b": zeros(f),
            "pw2_w": rand(f, cn), "pw2_b": zeros(cn),
            "gamma": full((cn,), 1e-2),
        }
        for _ in range(cfg.convnext_layers)
    ]
    return {
        "embd": rand(cfg.vocab_size, d),
        "conv1d_w": rand(p, d, 7), "conv1d_b": zeros(p),
        "posnet": posnet,
        "tok_norm_w": ones(p), "tok_norm_b": zeros(p),
        "convnext": convnext,
        "out_norm_w": ones(cn), "out_norm_b": zeros(cn),
        "head_w": rand(cn, cfg.n_out), "head_b": zeros(cfg.n_out),
    }


def init_params(cfg: VocoderConfig, seed: int = 0,
                device="cpu") -> dict[str, Any]:
    """Random decoder weights from a numpy generator, the JAX package's
    draws: equal to its ``init_params(cfg, seed)`` bit for bit."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        a = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        return torch.from_numpy(a).to(device)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return _layout(cfg, rand, full)


def init_params_fast(cfg: VocoderConfig, seed: int = 0,
                     device="cpu") -> dict[str, Any]:
    """:func:`init_params`' layout drawn on ``device`` by a seeded
    ``torch.Generator`` (not the JAX package's draws)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return _layout(cfg, rand, full)


@full_float32()
def decode_codes(params, cfg: VocoderConfig, codes) -> torch.Tensor:
    """codes: (T,) audio-code ids -> (T, n_out) spectrogram embeddings,
    float32 on the parameters' device."""
    g, eps = cfg.group_norm_groups, cfg.group_norm_eps
    embd = params["embd"]
    codes = torch.as_tensor(codes, device=embd.device).long()
    x = embd[codes]                                  # (T, d)
    cur = _conv1d(x.T, params["conv1d_w"], params["conv1d_b"])  # (p, T)

    for layer in params["posnet"]:
        inp = cur
        if "attn_q_w" in layer:                      # block 2: self-attention
            cur = _group_norm(cur, layer["attn_norm_w"], layer["attn_norm_b"],
                              g, eps)
            q = _conv1d(cur, layer["attn_q_w"], layer["attn_q_b"])
            k = _conv1d(cur, layer["attn_k_w"], layer["attn_k_b"])
            v = _conv1d(cur, layer["attn_v_w"], layer["attn_v_b"])
            # single head over time, scale 1/sqrt(posnet_d), non-causal
            scale = float(np.sqrt(np.float32(cfg.posnet_d)))
            att = torch.softmax((q.T @ k) / scale, dim=-1)
            cur = _conv1d((att @ v.T).T, layer["attn_o_w"], layer["attn_o_b"])
            cur = cur + inp
        elif "conv1_w" in layer:                     # resnet blocks 0,1,3,4
            cur = _group_norm(cur, layer["norm1_w"], layer["norm1_b"], g, eps)
            cur = cur * torch.sigmoid(cur)           # swish
            cur = _conv1d(cur, layer["conv1_w"], layer["conv1_b"])
            cur = _group_norm(cur, layer["norm2_w"], layer["norm2_b"], g, eps)
            cur = cur * torch.sigmoid(cur)
            cur = _conv1d(cur, layer["conv2_w"], layer["conv2_b"])
            cur = cur + inp
        else:                                        # final groupnorm block
            cur = _group_norm(cur, layer["norm_w"], layer["norm_b"], g, eps)

    xt = _layer_norm(cur.T, params["tok_norm_w"], params["tok_norm_b"],
                     cfg.layer_norm_eps)             # (T, p)
    for layer in params["convnext"]:
        h = _conv1d(xt.T, layer["dw_w"], layer["dw_b"],
                    groups=cfg.convnext_d).T         # depthwise conv7
        h = _layer_norm(h, layer["norm_w"], layer["norm_b"],
                        cfg.layer_norm_eps)
        h = F.gelu(h @ layer["pw1_w"] + layer["pw1_b"])
        h = h @ layer["pw2_w"] + layer["pw2_b"]
        xt = xt + h * layer["gamma"]
    xt = _layer_norm(xt, params["out_norm_w"], params["out_norm_b"],
                     cfg.layer_norm_eps)
    return xt @ params["head_w"] + params["head_b"]  # (T, n_out)


def hann_window(n: int, device="cpu") -> torch.Tensor:
    """Periodic Hann, float32 (the ISTFT's; log-mel's is float64 on the
    host)."""
    return 0.5 * (1.0 - torch.cos(
        2.0 * math.pi * torch.arange(n, dtype=torch.float32, device=device)
        / n))


def _fold(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (T, n_fft) windows at stride ``hop`` ->
    ((T-1)*hop+n_fft,): frame t's chunk j (of n_fft//hop) lands at output
    block t+j, added in the order j = 0, 1, ... (the JAX package's four
    shifted adds)."""
    t, n_fft = frames.shape
    assert n_fft % hop == 0
    r = n_fft // hop
    chunks = frames.reshape(t, r, hop)
    out = torch.zeros((t + r - 1, hop), dtype=frames.dtype,
                      device=frames.device)
    for j in range(r):
        out[j:j + t] += chunks[:, j, :]
    return out.reshape(-1)


def spectrogram_to_audio(embd: torch.Tensor,
                         cfg: VocoderConfig) -> torch.Tensor:
    """(T, n_out) interleaved log-mag/phase -> mono float32 waveform of
    (T-1)*hop + n_fft - 2*pad samples, pad = (n_fft - hop) / 2, on
    ``embd``'s device.

    The reference's irfft computes (1/N) Re(sum_{m<N} X_m e^{2 pi i k m /
    n}) with N = n/2 + 1 and does not double the interior bins as a true
    inverse does: the standard irfft of the spectrum with its interior bins
    halved, times n/N, gives it in one batched call."""
    n_fft, hop = cfg.n_fft, cfg.hop
    n_bins = cfg.n_out // 2
    embd = embd.to(torch.float32)
    mag = torch.clamp(torch.exp(embd[:, :n_bins]), max=1e2)
    phi = embd[:, n_bins:]
    spec = mag * torch.exp(1j * phi.to(torch.complex64))
    bin_scale = torch.full((n_bins,), 0.5, device=embd.device)
    bin_scale[0] = bin_scale[-1] = 1.0
    frames = torch.fft.irfft(spec * bin_scale, n=n_fft, dim=-1) * (
        n_fft / n_bins)
    w = hann_window(n_fft, embd.device)
    audio = _fold(frames * w, hop)
    env = _fold((w * w).expand(frames.shape), hop)
    audio = audio / env
    pad = (n_fft - hop) // 2
    return audio[pad:-pad]


# --- the converter and the vocoder directory ----------------------------------

def save_vocoder(path: str, cfg: VocoderConfig, params) -> None:
    """``vocoder_config.json`` + ``vocoder.npz`` (the JAX package's
    directory; lists keyed by index)."""
    from vlut_tpu_torch.models.audio import flatten

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        if isinstance(node, list):
            return [host(v) for v in node]
        return node.detach().cpu().numpy() if torch.is_tensor(node) else node

    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    (p / "vocoder_config.json").write_text(
        json.dumps(dataclasses.asdict(cfg), indent=1))
    np.savez(p / "vocoder.npz", **flatten(host(params)))


def hf_vocoder_tensors(src: str | pathlib.Path) -> dict[str, np.ndarray]:
    """The source's tensors in the JAX converter's order: every
    ``*.safetensors`` of a directory (or the one file), each in the order
    of its data, or a torch ``.bin`` / ``.pt`` state dict (its
    ``state_dict`` entry where it has one) read by ``torch.load``, as
    float32."""
    from vlut_tpu_torch.models.audio import hf_file_tensors

    src_p = pathlib.Path(src)
    tensors: dict[str, np.ndarray] = {}
    files = sorted(src_p.glob("*.safetensors")) if src_p.is_dir() \
        else [src_p]
    for f in files:
        if f.suffix == ".safetensors":
            tensors.update(hf_file_tensors(f))
        else:  # torch .bin / .pt
            sd = torch.load(str(f), map_location="cpu", weights_only=True)
            sd = sd.get("state_dict", sd)
            tensors.update({k: v.float().numpy() for k, v in sd.items()})
    return tensors


def convert_hf_vocoder(src: str, dst: str,
                       device: str | torch.device | None = None
                       ) -> VocoderConfig:
    """HF WavTokenizer decoder checkpoint (a directory of safetensors, or
    one ``.safetensors`` / ``.bin`` / ``.pt`` file) -> the vocoder
    directory the JAX package's converter writes (the same config and
    arrays): ``*codebook.embed`` -> code embeddings; ``backbone.embed`` ->
    conv stem; ``backbone.posnet.N.{norm1,conv1,norm2,conv2 |
    norm,q,k,v,proj_out}``; ``backbone.norm``; ``backbone.convnext.N.
    {dwconv,norm,pwconv1,pwconv2,gamma}``; ``backbone.final_layer_norm``;
    ``head.out``.  Torch Linear weights (out, in) are transposed to (in,
    out); conv weights keep (out, in, k).  Host numpy, as the family
    converters; ``device`` keeps the port's rule."""
    from vlut_tpu_torch.device import resolve_device
    from vlut_tpu_torch.models.audio import picker

    resolve_device(device)
    tensors = hf_vocoder_tensors(src)
    pick = picker(tensors, f" in {src}")

    embd = pick("codebook.embed")
    stem_w = pick("backbone.embed", "weight")
    head_w = pick("head.out", "weight")
    n_posnet = 1 + max(
        int(m.group(1)) for name in tensors
        if (m := re.match(r".*backbone\.posnet\.(\d+)\.", name))
    )
    n_convnext = 1 + max(
        int(m.group(1)) for name in tensors
        if (m := re.match(r".*backbone\.convnext\.(\d+)\.", name))
    )
    pw1 = pick("convnext.0.pwconv1", "weight")
    cfg = VocoderConfig(
        vocab_size=embd.shape[0], n_embd=embd.shape[1],
        posnet_d=stem_w.shape[0], posnet_layers=n_posnet,
        convnext_d=pw1.shape[1], convnext_layers=n_convnext,
        n_ff=pw1.shape[0], n_out=head_w.shape[0],
    )

    posnet: list[dict[str, Any]] = []
    for i in range(n_posnet):
        pre = f"backbone.posnet.{i}."
        names = {n for n in tensors if pre in n}
        if any(".q." in n or n.endswith(".q.weight") for n in names):
            posnet.append({
                "attn_norm_w": pick(pre + "norm.weight"),
                "attn_norm_b": pick(pre + "norm.bias"),
                "attn_q_w": pick(pre + "q.weight"),
                "attn_q_b": pick(pre + "q.bias"),
                "attn_k_w": pick(pre + "k.weight"),
                "attn_k_b": pick(pre + "k.bias"),
                "attn_v_w": pick(pre + "v.weight"),
                "attn_v_b": pick(pre + "v.bias"),
                "attn_o_w": pick(pre + "proj_out.weight"),
                "attn_o_b": pick(pre + "proj_out.bias"),
            })
        elif any("conv1" in n for n in names):
            posnet.append({
                "norm1_w": pick(pre + "norm1.weight"),
                "norm1_b": pick(pre + "norm1.bias"),
                "conv1_w": pick(pre + "conv1.weight"),
                "conv1_b": pick(pre + "conv1.bias"),
                "norm2_w": pick(pre + "norm2.weight"),
                "norm2_b": pick(pre + "norm2.bias"),
                "conv2_w": pick(pre + "conv2.weight"),
                "conv2_b": pick(pre + "conv2.bias"),
            })
        else:
            posnet.append({
                "norm_w": pick(pre + "norm.weight"),
                "norm_b": pick(pre + "norm.bias"),
            })

    convnext = []
    for i in range(n_convnext):
        pre = f"backbone.convnext.{i}."
        convnext.append({
            "dw_w": pick(pre + "dwconv.weight"),
            "dw_b": pick(pre + "dwconv.bias"),
            "norm_w": pick(pre + "norm.weight"),
            "norm_b": pick(pre + "norm.bias"),
            "pw1_w": pick(pre + "pwconv1.weight").T,
            "pw1_b": pick(pre + "pwconv1.bias"),
            "pw2_w": pick(pre + "pwconv2.weight").T,
            "pw2_b": pick(pre + "pwconv2.bias"),
            "gamma": pick(pre + "gamma").reshape(-1),
        })

    params = {
        "embd": embd,
        "conv1d_w": stem_w, "conv1d_b": pick("backbone.embed", "bias"),
        "posnet": posnet,
        "tok_norm_w": pick("backbone.norm.weight"),
        "tok_norm_b": pick("backbone.norm.bias"),
        "convnext": convnext,
        "out_norm_w": pick("backbone.final_layer_norm.weight"),
        "out_norm_b": pick("backbone.final_layer_norm.bias"),
        "head_w": head_w.T, "head_b": pick("head.out", "bias"),
    }
    save_vocoder(dst, cfg, params)
    return cfg


def load_vocoder(path: str, device=None
                 ) -> tuple[VocoderConfig, dict[str, Any]]:
    """A vocoder directory -> (config, tree of float32 tensors on
    ``device``: the GPU unless the CPU is asked for), ``posnet`` and
    ``convnext`` as lists."""
    from vlut_tpu_torch.convert.from_jax import tower_from_numpy
    from vlut_tpu_torch.device import resolve_device
    from vlut_tpu_torch.models.audio import unflatten

    dev = resolve_device(device)
    p = pathlib.Path(path)
    cfg = VocoderConfig(**json.loads((p / "vocoder_config.json").read_text()))

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return cfg, tower_from_numpy(listify(unflatten(np.load(
        p / "vocoder.npz"))), dev)
