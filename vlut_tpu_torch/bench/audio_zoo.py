"""The audio families at tiny widths: HF-layout sources written from seeded
arrays, and each family on the card against the CPU.

:func:`write_ultravox_source` writes an ultravox checkpoint (a whisper
encoder under ``audio_tower.*`` and ultravox's projector under
``multi_modal_projector.*``, the names the converter reads) and
:func:`write_wavtokenizer_source` a WavTokenizer decoder (safetensors or a
torch ``.bin``), so ``convert-audio`` and ``convert-vocoder`` have a source
where ``transformers`` is not installed (the card's machine).
:func:`card_vs_cpu` runs each audio encoder projector, lfm2-a's conformer
and the vocoder + ISTFT on the card and on the CPU from the same seeded
weights and inputs.

    python -m vlut_tpu_torch.bench.audio_zoo     # one JSON line per family
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from typing import Any

import numpy as np
import torch

from vlut_tpu_torch.bench.vision_zoo import rel_err
from vlut_tpu_torch.models import audio, vocoder

# the JAX audio tests' tiny encoder, one config per projector (stack 2 for
# voxtral and glma, as the JAX tests give them)
TINY = audio.AudioConfig(
    n_mels=16, n_fft=64, hop=32, sample_rate=1600, d_model=32,
    n_layers=2, n_heads=4, d_ff=64, n_ctx=128, d_llm=48,
    projector="ultravox", stack_factor=4, proj_hidden=40,
)
PROJECTORS = {"ultravox": 4, "voxtral": 2, "music_flamingo": 4, "glma": 2,
              "qwen2a": 4}
TINY_CONFORMER = audio.ConformerConfig(
    n_mels=16, d_sub=8, d_model=32, n_layers=2, n_heads=4, d_ff=48,
    conv_kernel=5, d_llm=40,
)
# card against CPU: each family within this share of its largest output
TOL = 1e-4
# the JAX TTS tests' tiny vocoder
TINY_VOCODER = vocoder.VocoderConfig(
    vocab_size=64, n_embd=16, posnet_d=32, convnext_d=32, n_ff=48,
    n_out=34, group_norm_groups=4, n_fft=32, hop=8,
)


# the card's full-width describe --audio (chip_smoke.py phase 27): whisper's
# 3000 frames -> 1500 positions -> 188 ultravox rows, spliced into this
# prompt (tiny_real's tokenizer)
AUDIO_PROMPT = "USER: <audio>\nTranscribe the audio. ASSISTANT:"
AUDIO_ROWS = 188
# the card's full-width tts: this text after a seeded speaker profile
TTS_TEXT = "The little model reads 2 lines of its own repo aloud."


def speaker_profile(seed: int, n_words: int = 20) -> dict[str, Any]:
    """An OuteTTS speaker profile from ``seed``: ``n_words`` words of 3-8
    letters, each with a duration and 8-12 codes of the 4,100."""
    rng = np.random.default_rng(seed)
    words = []
    for _ in range(n_words):
        n = int(rng.integers(3, 9))
        words.append({
            "word": "".join(chr(97 + int(c)) for c in rng.integers(0, 26, n)),
            "duration": float(rng.uniform(0.1, 0.6)),
            "codes": [int(c) for c in rng.integers(0, 4100,
                                                   int(rng.integers(8, 13)))],
        })
    return {"version": "0.2", "words": words}


# OuteTTS-0.2's added tokens, as the card's tts cell tokenizes them:
# Qwen2.5's three control tokens, the 4,100 <|N|> codes from the
# reference's first code id (tts.cpp's range), then the prompt's markup and
# its <|t_D.DD|> durations
OUTETTS_CONTROL = {"<|endoftext|>": 151643, "<|im_start|>": 151644,
                   "<|im_end|>": 151645}
OUTETTS_CODE_BASE = 151672
OUTETTS_MARKUP = ("<|text_start|>", "<|text_end|>", "<|audio_start|>",
                  "<|audio_end|>", "<|code_start|>", "<|code_end|>",
                  "<|text_sep|>")


def outetts_added_tokens() -> dict[str, int]:
    """Token text -> id of :data:`OUTETTS_CONTROL`, the codes, the markup
    and the durations 0.00-10.00 s (the markup's and durations' ids follow
    the codes: OuteTTS-0.2's own are not in the repository)."""
    out = dict(OUTETTS_CONTROL)
    out.update({f"<|{i}|>": OUTETTS_CODE_BASE + i for i in range(4100)})
    nxt = OUTETTS_CODE_BASE + 4100
    for t in OUTETTS_MARKUP + tuple(f"<|t_{i / 100:.2f}|>"
                                    for i in range(1001)):
        out[t] = nxt
        nxt += 1
    return out


def outetts_tokenizer(fixture, dst) -> pathlib.Path:
    """Write into ``dst`` the tokenizer of the card's tts cell: ``fixture``'s
    character-level vocabulary for text, and each of OuteTTS-0.2's added
    tokens (:func:`outetts_added_tokens`) one token, as OuteTTS-0.2's own
    vocabulary makes each code, duration and markup token, and the newline
    its own token (the byte slot ``<0x0A>`` renamed; ``fixture`` reads it
    as unknown).  Words stay spelled by character (OuteTTS's BPE takes
    about two to three tokens for one of the profile's random words)."""
    fixture, dst = pathlib.Path(fixture), pathlib.Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    spec = json.loads((fixture / "tokenizer.json").read_text())
    vocab = spec["model"]["vocab"]
    vocab["\n"] = vocab.pop("<0x0A>")
    added = outetts_added_tokens()
    vocab.update(added)
    spec["added_tokens"] += [
        {"id": i, "content": t, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": t in OUTETTS_CONTROL}
        for t, i in added.items()]
    (dst / "tokenizer.json").write_text(json.dumps(spec))
    cfg = json.loads((fixture / "tokenizer_config.json").read_text())
    cfg.pop("added_tokens_decoder", None)
    (dst / "tokenizer_config.json").write_text(json.dumps(cfg))
    (dst / "special_tokens_map.json").write_bytes(
        (fixture / "special_tokens_map.json").read_bytes())
    return dst


def prefill_rows(fixture) -> dict[str, int]:
    """The rows of the card's two prefills: the describe prompt around
    :data:`AUDIO_ROWS` audio rows by ``fixture``'s tokenizer, and the tts
    prompt of :data:`TTS_TEXT` after the seed-27 speaker by
    :func:`outetts_tokenizer`'s."""
    import tempfile

    from vlut_tpu_torch.runtime.tts import prompt_ids
    from vlut_tpu_torch.utils.tokenizer import Tokenizer

    tok = Tokenizer(fixture)
    pre, _, post = AUDIO_PROMPT.partition("<audio>")
    with tempfile.TemporaryDirectory() as d:
        tts_tok = Tokenizer(outetts_tokenizer(fixture, d))
        tts_rows = len(prompt_ids(tts_tok, TTS_TEXT, speaker_profile(27))[0])
    return {"describe": len(tok.encode(pre)) + AUDIO_ROWS
            + len(tok.encode(post, add_bos=False)), "tts": tts_rows}


def outetts_projections() -> list:
    """(label, K, N, mode, sub_norm, residual?, fused?) of
    ``outetts_0_2_500m``'s layer as the gates run it: its q/k/v biases keep
    the tree unfused (no wqkv, no w_gate|up), so wq, wk, wv, w_gate, w_up
    and w_down run #4 at a decode step and wo alone fuses with its
    residual (#1, plain); all seven run #3 past 64 rows.  Heads of 64 are
    padded to 128 lanes (wq 1792 wide, wo 1792 deep)."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.dims import make_plan

    c = PRESETS["outetts_0_2_500m"]
    p = make_plan(c)
    return [
        ("outetts_wq", c.d_model, p.q_dim_p, "plain", False, False, False),
        ("outetts_wk", c.d_model, p.kv_dim_p, "plain", False, False, False),
        ("outetts_wv", c.d_model, p.kv_dim_p, "plain", False, False, False),
        ("outetts_wo", p.wo_in_p, c.d_model, "plain", False, True, True),
        ("outetts_w_gate", c.d_model, p.ff_p, "plain", False, False, False),
        ("outetts_w_up", c.d_model, p.ff_p, "plain", False, False, False),
        ("outetts_w_down", p.ff_p, c.d_model, "plain", False, False, False),
    ]


def tiny_config(projector: str, **kw) -> audio.AudioConfig:
    return dataclasses.replace(TINY, projector=projector,
                               stack_factor=PROJECTORS[projector], **kw)


def perturbed(tree, seed: int, scale: float = 0.1):
    """``tree`` (tensors) with seeded normal noise added to every leaf, so
    the biases and norms that ``init_params`` leaves at 0 and 1 count."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        noise = rng.standard_normal(tuple(node.shape)) * scale
        return node + torch.from_numpy(noise.astype(np.float32)).to(
            node.device)

    return walk(tree)


def conformer_params(cfg: audio.ConformerConfig, seed: int
                     ) -> dict[str, Any]:
    """A random conformer tree (numpy float32, the JAX package's layouts:
    HWIO subsampling convolutions, (L, ...) layer stacks), drawn as the JAX
    conformer test draws its own."""
    rng = np.random.default_rng(seed)

    def t(*s, scale=0.1):
        return rng.standard_normal(s).astype(np.float32) * scale

    L, d, C, h = cfg.n_layers, cfg.d_model, cfg.d_sub, cfg.n_heads
    f_sub = cfg.n_mels
    for _ in range(3):  # the three stride-2 stages over frequency
        f_sub = -(-f_sub // 2)
    params = {
        "sub0_w": t(3, 3, 1, C), "sub0_b": t(C),
        "sub2_w": t(3, 3, 1, C), "sub2_b": t(C),
        "sub3_w": t(1, 1, C, C), "sub3_b": t(C),
        "sub5_w": t(3, 3, 1, C), "sub5_b": t(C),
        "sub6_w": t(1, 1, C, C), "sub6_b": t(C),
        "sub_out_w": t(f_sub * C, d), "sub_out_b": t(d),
        "ada_ln_w": 1.0 + t(d), "ada_ln_b": t(d),
        "ada_w1": t(d, 64), "ada_b1": t(64),
        "ada_w2": t(64, cfg.d_llm), "ada_b2": t(cfg.d_llm),
    }
    hd = d // h
    params["layers"] = {
        "ff1_ln_w": 1.0 + t(L, d), "ff1_ln_b": t(L, d),
        "ff1_up_w": t(L, d, cfg.d_ff), "ff1_up_b": t(L, cfg.d_ff),
        "ff1_down_w": t(L, cfg.d_ff, d), "ff1_down_b": t(L, d),
        "attn_ln_w": 1.0 + t(L, d), "attn_ln_b": t(L, d),
        "wq": t(L, d, d), "bq": t(L, d),
        "wk": t(L, d, d), "bk": t(L, d),
        "wv": t(L, d, d), "bv": t(L, d),
        "wo": t(L, d, d), "bo": t(L, d),
        "pos_w": t(L, d, d),
        "pos_bias_u": t(L, h, hd), "pos_bias_v": t(L, h, hd),
        "conv_ln_w": 1.0 + t(L, d), "conv_ln_b": t(L, d),
        "pw1_w": t(L, d, 2 * d), "pw1_b": t(L, 2 * d),
        "dw_w": t(L, cfg.conv_kernel, d), "dw_b": t(L, d),
        "conv_norm_w": 1.0 + t(L, d), "conv_norm_b": t(L, d),
        "pw2_w": t(L, d, d), "pw2_b": t(L, d),
        "ff2_ln_w": 1.0 + t(L, d), "ff2_ln_b": t(L, d),
        "ff2_up_w": t(L, d, cfg.d_ff), "ff2_up_b": t(L, cfg.d_ff),
        "ff2_down_w": t(L, cfg.d_ff, d), "ff2_down_b": t(L, d),
        "out_ln_w": 1.0 + t(L, d), "out_ln_b": t(L, d),
    }
    return params


def write_ultravox_source(dst, cfg: audio.AudioConfig, seed: int,
                          proj_hidden: int | None = None) -> pathlib.Path:
    """An ultravox HF directory (``config.json`` with the encoder's heads,
    ``model.safetensors``) of ``cfg``'s widths (stack 8, as the converter
    reads it), every tensor N(0, 0.05) from ``seed`` (norm gains about
    1)."""
    from vlut_tpu_torch.convert.checkpoint import write_safetensors

    rng = np.random.default_rng(seed)
    d, f, ph = cfg.d_model, cfg.d_ff, proj_hidden or cfg.proj_hidden

    def w(*shape, gain=False):
        a = rng.standard_normal(shape) * 0.05
        return (a + 1.0 if gain else a).astype(np.float32)

    t = {"audio_tower.conv1.weight": w(d, cfg.n_mels, 3),
         "audio_tower.conv1.bias": w(d),
         "audio_tower.conv2.weight": w(d, d, 3),
         "audio_tower.conv2.bias": w(d),
         "audio_tower.embed_positions.weight": w(cfg.n_ctx, d),
         "audio_tower.layer_norm.weight": w(d, gain=True),
         "audio_tower.layer_norm.bias": w(d)}
    for i in range(cfg.n_layers):
        p = f"audio_tower.layers.{i}."
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            t[p + ln + ".weight"] = w(d, gain=True)
            t[p + ln + ".bias"] = w(d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[p + f"self_attn.{proj}.weight"] = w(d, d)
            if proj != "k_proj":
                t[p + f"self_attn.{proj}.bias"] = w(d)
        t[p + "fc1.weight"], t[p + "fc1.bias"] = w(f, d), w(f)
        t[p + "fc2.weight"], t[p + "fc2.bias"] = w(d, f), w(d)
    ds = 8 * d
    t.update({
        "multi_modal_projector.ln_pre.weight": w(ds, gain=True),
        "multi_modal_projector.linear_1.weight": w(2 * ph, ds),
        "multi_modal_projector.ln_mid.weight": w(ph, gain=True),
        "multi_modal_projector.linear_2.weight": w(cfg.d_llm, ph),
    })
    out = pathlib.Path(dst)
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps({
        "model_type": "ultravox",
        "audio_config": {"num_attention_heads": cfg.n_heads,
                         "num_mel_bins": cfg.n_mels, "d_model": d}}))
    write_safetensors(out / "model.safetensors", t)
    return out


def write_wavtokenizer_source(dst, cfg: vocoder.VocoderConfig, seed: int,
                              fmt: str = "safetensors") -> pathlib.Path:
    """A WavTokenizer decoder checkpoint of ``cfg``'s widths under the
    names the converter reads: ``dst/model.safetensors`` (``fmt``
    "safetensors": ``dst`` is the directory) or the torch state dict
    ``dst`` itself (``fmt`` "bin"), every tensor N(0, 0.05) from ``seed``
    (norm gains about 1, gammas about 0.01)."""
    from vlut_tpu_torch.convert.checkpoint import write_safetensors

    rng = np.random.default_rng(seed)
    p, cn, f, d = cfg.posnet_d, cfg.convnext_d, cfg.n_ff, cfg.n_embd

    def w(*shape, gain=False):
        a = rng.standard_normal(shape) * 0.05
        return (a + 1.0 if gain else a).astype(np.float32)

    t = {"feature_extractor.encodec.quantizer.vq.layers.0._codebook.embed":
         w(cfg.vocab_size, d),
         "backbone.embed.weight": w(p, d, 7), "backbone.embed.bias": w(p)}
    for i in range(cfg.posnet_layers):
        pre = f"backbone.posnet.{i}."
        if i == 2:
            names = {"norm": None, "q": 1, "k": 1, "v": 1, "proj_out": 1}
        elif i == cfg.posnet_layers - 1:
            names = {"norm": None}
        else:
            names = {"norm1": None, "conv1": 3, "norm2": None, "conv2": 3}
        for n, k in names.items():
            t[pre + n + ".weight"] = (w(p, gain=True) if k is None
                                      else w(p, p, k))
            t[pre + n + ".bias"] = w(p)
    t["backbone.norm.weight"], t["backbone.norm.bias"] = w(p, gain=True), w(p)
    for i in range(cfg.convnext_layers):
        pre = f"backbone.convnext.{i}."
        t.update({pre + "dwconv.weight": w(cn, 1, 7), pre + "dwconv.bias": w(cn),
                  pre + "norm.weight": w(cn, gain=True),
                  pre + "norm.bias": w(cn),
                  pre + "pwconv1.weight": w(f, cn), pre + "pwconv1.bias": w(f),
                  pre + "pwconv2.weight": w(cn, f), pre + "pwconv2.bias": w(cn),
                  pre + "gamma": (w(cn) * 0.2).astype(np.float32)})
    t["backbone.final_layer_norm.weight"] = w(cn, gain=True)
    t["backbone.final_layer_norm.bias"] = w(cn)
    t["head.out.weight"], t["head.out.bias"] = w(cfg.n_out, cn), w(cfg.n_out)
    out = pathlib.Path(dst)
    if fmt == "bin":
        out.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: torch.from_numpy(v) for k, v in t.items()}, out)
        return out
    out.mkdir(parents=True, exist_ok=True)
    write_safetensors(out / "model.safetensors", t)
    return out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def n_params(tree) -> int:
    """The elements of every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_params(v) for v in tree)
    return tree.numel()


def seeded_mel(cfg: audio.AudioConfig, seconds: float, seed: int
               ) -> np.ndarray:
    """The host log-mel of ``seconds`` of seeded noise at the config's
    rate."""
    rng = np.random.default_rng(seed)
    n = int(seconds * cfg.sample_rate)
    return audio.log_mel((rng.standard_normal(n) * 0.1).astype(np.float32),
                         cfg)


def card_vs_cpu(dev, seed: int = 27) -> dict[str, dict]:
    """Each audio family on ``dev`` against the CPU on the same weights and
    inputs (float32; the functions turn TF32 off): every projector's
    ``encode``, lfm2-a's ``conformer_encode`` and the vocoder's
    ``decode_codes`` + ``spectrogram_to_audio`` (at the tiny widths and at
    the default n_fft 1280 / hop 320 ISTFT), each within :data:`TOL` of
    the largest output."""
    from vlut_tpu_torch.convert.from_jax import tower_from_numpy

    out: dict[str, dict] = {}
    cpu = torch.device("cpu")
    with torch.inference_mode():
        for i, proj in enumerate(PROJECTORS):
            cfg = tiny_config(proj)
            params = perturbed(audio.init_params(cfg, seed=seed + i),
                               seed + 100 + i)
            mel = torch.from_numpy(seeded_mel(cfg, 1.0, seed + i))
            want = audio.encode(params, cfg, mel)
            got = audio.encode(_to(params, dev), cfg, mel.to(dev))
            out[f"encode_{proj}"] = {"rel_err": rel_err(got, want),
                                     "shape": list(got.shape)}
        cp = tower_from_numpy(conformer_params(TINY_CONFORMER, seed), cpu)
        mel = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (32, TINY_CONFORMER.n_mels)).astype(np.float32))
        want = audio.conformer_encode(cp, TINY_CONFORMER, mel)
        got = audio.conformer_encode(_to(cp, dev), TINY_CONFORMER, mel.to(dev))
        out["conformer"] = {"rel_err": rel_err(got, want),
                            "shape": list(got.shape)}
        for name, vcfg in (("vocoder_tiny", TINY_VOCODER),
                           ("vocoder_tiny_istft1280", dataclasses.replace(
                               TINY_VOCODER, n_out=1282))):
            vp = perturbed(vocoder.init_params(vcfg, seed=seed), seed + 7,
                           scale=0.02)
            codes = np.random.default_rng(seed).integers(
                0, vcfg.vocab_size, 40)
            embd_c = vocoder.decode_codes(vp, vcfg, codes)
            embd_g = vocoder.decode_codes(_to(vp, dev), vcfg, codes)
            wave_c = vocoder.spectrogram_to_audio(embd_c, vcfg)
            wave_g = vocoder.spectrogram_to_audio(embd_g, vcfg)
            out[name] = {"embd_rel_err": rel_err(embd_g, embd_c),
                         "rel_err": rel_err(wave_g, wave_c),
                         "samples": int(wave_g.shape[0])}
    for r in out.values():
        r["ok"] = r["rel_err"] <= TOL and r.get("embd_rel_err", 0.0) <= TOL
    return out


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m vlut_tpu_torch.bench.audio_zoo")
    ap.add_argument("--seed", type=int, default=27)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device: each family runs on the card "
                 "against the CPU")
    res = card_vs_cpu(torch.device("cuda"), seed=args.seed)
    for name, r in res.items():
        print(json.dumps({"family": name, **r}), flush=True)
    if not all(r["ok"] for r in res.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
