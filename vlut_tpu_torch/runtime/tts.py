"""OuteTTS-style text-to-speech pipeline (port of
``vlut_tpu/runtime/tts.py``; the reference is tools/tts/tts.cpp).

Two models: a text-to-codes LM (an ordinary decoder checkpoint served by
``models/transformer.py``: OuteTTS is a Qwen2-architecture model whose
vocabulary appends some 4,100 ``<|N|>`` audio-code tokens) and a
codes-to-speech WavTokenizer decoder (``models/vocoder.py``).  The
pipeline:

1. text normalization (:func:`process_text`): numbers to words,
   lowercase, punctuation stripped, words joined by the version's
   separator token;
2. the prompt: ``<|im_start|>\\n`` + the speaker's transcript + the
   normalized text + ``<|text_end|>\\n`` + the speaker's code history;
3. a sampled decode (top-k 4) with optional **guide tokens**: after each
   newline token the next sampled non-control token is replaced by the
   first token of the next input word;
4. only the audio-code tokens kept, less the code range's base, through
   the vocoder and the ISTFT, the first 0.25 s muted, written as 16-bit
   mono WAV.

The text frontend, :func:`_sample_top_k` and :func:`save_wav` are copies
of the JAX package's host code.  :func:`generate_codes` decodes one token
per step through the fused tree: the step is one CUDA graph on the card
(``runtime/step_graph.py:step_runner``; eager on the CPU) writing the
logits into a static tensor; after each step the host copies the
``vocab_size`` float32 logits and samples with numpy's ``default_rng(seed)``
exactly as the JAX package does, so the token stream is the JAX one
wherever the logits are (guide-token forcing depends on the data, which
keeps the sampling on the host).
"""

from __future__ import annotations

import re
import time
import wave
from typing import Any

import numpy as np
import torch

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = {2: "twenty", 3: "thirty", 4: "forty", 5: "fifty", 6: "sixty",
         7: "seventy", 8: "eighty", 9: "ninety"}


def _under_1000(num: int) -> str:
    out = ""
    if num >= 100:
        out += _ONES[num // 100] + " hundred "
        num %= 100
    if num >= 20:
        out += _TENS[num // 10]
        if num % 10:
            out += "-" + _ONES[num % 10]
    elif num > 0:
        out += _ONES[num]
    return out


def number_to_words(number_str: str) -> str:
    """Billions / millions / thousands, then ' point' and the decimals digit
    by digit; an unparsable string gives a single space."""
    try:
        dot = number_str.find(".")
        n = int(number_str[:dot] if dot >= 0 else number_str)
        out = ""
        if n == 0:
            out = "zero"
        else:
            for scale, name in ((10**9, "billion"), (10**6, "million"),
                                (10**3, "thousand")):
                if n >= scale:
                    out += _under_1000(n // scale) + f" {name} "
                    n %= scale
            if n > 0:
                out += _under_1000(n)
        if dot >= 0:
            out += " point"
            for digit in number_str[dot + 1:]:
                out += " " + _ONES[int(digit)]
        return out
    except (ValueError, IndexError):
        return " "


def replace_numbers_with_words(text: str) -> str:
    return re.sub(r"\d+(\.\d+)?", lambda m: number_to_words(m.group()), text)


def separator(version: str) -> str:
    return "<|space|>" if version == "0.3" else "<|text_sep|>"


def process_text(text: str, version: str = "0.2") -> str:
    """OuteTTS prompt normalization."""
    t = replace_numbers_with_words(text).lower()
    t = re.sub(r"[-_/,\.\\]", " ", t)
    t = re.sub(r"[^a-z\s]", "", t)
    t = re.sub(r"\s+", " ", t).strip()
    return re.sub(r"\s", separator(version), t)


def speaker_text(speaker: dict[str, Any], version: str = "0.2") -> str:
    """The speaker's transcript section."""
    sep = separator(version)
    out = "<|text_start|>"
    for word in speaker["words"]:
        out += word["word"] + sep
    return out


def speaker_data(speaker: dict[str, Any], version: str = "0.2") -> str:
    """The speaker's code-history section."""
    start = "" if version == "0.3" else "<|code_start|>"
    end = "<|space|>" if version == "0.3" else "<|code_end|>"
    out = "<|audio_start|>\n"
    for word in speaker["words"]:
        entry = f"{word['word']}<|t_{word['duration']:.2f}|>{start}"
        for code in word["codes"]:
            entry += f"<|{code}|>"
        out += entry + end + "\n"
    return out


def prepare_guide_tokens(tok, processed: str, version: str = "0.2"
                         ) -> list[int]:
    """First token of each normalized word, led by the newline token."""
    nl = tok.encode("\n", add_bos=False)
    result = [nl[0]]
    for word in processed.split(separator(version)):
        ids = tok.encode(word, add_bos=False)
        if ids:
            result.append(ids[0])
    return result


def detect_code_range(tok) -> tuple[int, int]:
    """The ``<|N|>`` audio-code token range of the vocabulary, from the
    tokenizer's ``<|0|>`` (the reference hardcodes OuteTTS-0.2's [151672,
    155772])."""
    added = tok.tk.get_added_vocab() if hasattr(tok.tk, "get_added_vocab") \
        else {}
    lo = added.get("<|0|>")
    if lo is None:
        ids = tok.encode("<|0|>", add_bos=False)
        if len(ids) != 1:
            raise ValueError(
                "cannot locate audio-code tokens (<|0|>) in the vocab; "
                "pass --code-offset"
            )
        lo = ids[0]
    hi = lo
    pat = re.compile(r"^<\|(\d+)\|>$")
    for tok_str, tid in added.items():
        m = pat.match(tok_str)
        if m and tid - int(m.group(1)) == lo:
            hi = max(hi, tid)
    return lo, hi if hi > lo else lo + 4100


def _sample_top_k(logits: np.ndarray, k: int, rng: np.random.Generator,
                  temp: float = 1.0) -> int:
    idx = np.argpartition(logits, -k)[-k:]
    z = logits[idx].astype(np.float64) / max(temp, 1e-6)
    z -= z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(idx, p=p))


def generate_codes(
    cfg, model, tok, prompt_ids: list[int],
    guide_tokens: list[int] | None = None,
    n_predict: int = 4096, top_k: int = 4, seed: int = 0,
    max_ctx: int = 8192, cuda_graph: bool = True,
    stats: dict | None = None,
) -> list[int]:
    """The text-to-codes decode loop with guide-token forcing: the raw
    generated token stream (codes and markup; the caller keeps the code
    range).

    One prefill of the prompt into a one-slot cache of ``min(max_ctx,
    cfg.max_seq_len)`` rows, then one single-token step per token over the
    fused tree, its logits written into a static tensor: a CUDA graph
    replayed on the card (``cuda_graph=False``: eager), eager on the CPU
    (``forward``'s gate sends a head shape the fused attention does not
    take through the composed one).  ``stats``,
    when given, receives the prefill's seconds, each step's seconds (the
    step and the copy of its logits to the host), each host sampling's
    seconds, the step program's stats and the program itself (``run``:
    one call replays the last step, for a caller that times or profiles
    it after the loop)."""
    from vlut_tpu_torch.models.transformer import (forward,
                                                   fuse_projections,
                                                   init_kv_cache,
                                                   unstack_layers)
    from vlut_tpu_torch.runtime.step_graph import step_runner

    m2 = unstack_layers(fuse_projections(model, cfg), cfg)
    dev = m2.device
    ctx = min(max_ctx, cfg.max_seq_len)
    cache = init_kv_cache(cfg, 1, max_len=ctx, device=dev)
    t = len(prompt_ids)
    assert t < ctx, (t, ctx)
    v = cfg.vocab_size
    st = {"token": torch.zeros((1, 1), dtype=torch.long, device=dev),
          "pos": torch.zeros((1, 1), dtype=torch.long, device=dev)}
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = forward(
            m2, cfg, torch.tensor([prompt_ids], dtype=torch.long, device=dev),
            torch.arange(t, device=dev)[None], cache,
            logits_at=torch.tensor([t - 1], device=dev))
        lg = logits[0, 0, :v].to(torch.float32).cpu().numpy()
    if stats is not None:
        stats.update(prefill_s=time.perf_counter() - t0, step_s=[],
                     sample_s=[], prompt_tokens=t)

    def step():
        out, _ = forward(m2, cfg, st["token"], st["pos"], cache)
        return out[0, 0, :v].to(torch.float32)

    run = step_runner(step, dev, cuda_graph)
    rng = np.random.default_rng(seed)
    eos = tok.eos_id
    newline = tok.encode("\n", add_bos=False)[0]
    control = set(tok.tk.all_special_ids) | set(
        (tok.tk.get_added_vocab() or {}).values()
        if hasattr(tok.tk, "get_added_vocab") else ()
    )
    guide = list(guide_tokens or [])
    uses_guide = True
    out: list[int] = []
    with torch.inference_mode():
        for _ in range(n_predict):
            t1 = time.perf_counter()
            nxt = _sample_top_k(lg, top_k, rng)
            if guide and uses_guide and nxt not in control and nxt != eos:
                nxt = guide.pop(0)
            uses_guide = nxt == newline
            out.append(nxt)
            t2 = time.perf_counter()
            if stats is not None:
                stats["sample_s"].append(t2 - t1)
            if nxt == eos or t + 1 >= ctx:
                break
            st["token"].fill_(nxt)
            st["pos"].fill_(t)
            lg = run().cpu().numpy()
            if stats is not None:
                stats["step_s"].append(time.perf_counter() - t2)
            t += 1
    if stats is not None:
        stats.update(graph=run.stats(), run=run)
    return out


def codes_to_audio(codes: list[int], voc_cfg, voc_params) -> np.ndarray:
    """Vocoder + ISTFT on the vocoder's device, then the first
    ``sample_rate // 4`` samples muted on the host: float32 audio."""
    from vlut_tpu_torch.models.vocoder import (decode_codes,
                                               spectrogram_to_audio)

    with torch.inference_mode():
        embd = decode_codes(voc_params, voc_cfg, codes)
        audio = spectrogram_to_audio(embd, voc_cfg).cpu().numpy()
    audio = np.array(audio, np.float32)
    mute = min(voc_cfg.sample_rate // 4, audio.shape[0])
    audio[:mute] = 0.0
    return audio


def save_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """16-bit mono PCM."""
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def prompt_ids(tok, text: str, speaker: dict[str, Any] | None = None,
               version: str = "0.2") -> tuple[list[int], str]:
    """(the prompt's ids, the normalized text) of :func:`synthesize`."""
    processed = process_text(text, version)
    ids = tok.encode("<|im_start|>\n", add_bos=True)
    if speaker:
        ids += tok.encode(speaker_text(speaker, version), add_bos=False)
    else:
        ids += tok.encode("<|text_start|>", add_bos=False)
    ids += tok.encode(processed, add_bos=False)
    ids += tok.encode("<|text_end|>\n", add_bos=False)
    if speaker:
        ids += tok.encode(speaker_data(speaker, version), add_bos=False)
    else:
        ids += tok.encode("<|audio_start|>\n", add_bos=False)
    return ids, processed


def synthesize(
    cfg, model, tok, text: str,
    voc_cfg, voc_params,
    speaker: dict[str, Any] | None = None,
    version: str | None = None,
    use_guide_tokens: bool = False,
    n_predict: int = 4096, top_k: int = 4, seed: int = 0,
    code_offset: int | None = None,
) -> np.ndarray:
    """Text -> float32 waveform in [-1, 1] (empty when no sampled token
    lands in the code range)."""
    if version is None:
        version = str(speaker.get("version", "0.2")) if speaker else "0.2"
    ids, processed = prompt_ids(tok, text, speaker, version)
    guide = (prepare_guide_tokens(tok, processed, version)
             if use_guide_tokens else None)
    toks = generate_codes(cfg, model, tok, ids, guide_tokens=guide,
                          n_predict=n_predict, top_k=top_k, seed=seed)
    if code_offset is None:
        lo, hi = detect_code_range(tok)
    else:
        lo, hi = code_offset, code_offset + 4100
    codes = [t - lo for t in toks if lo <= t <= hi]
    if not codes:
        return np.zeros((0,), np.float32)
    return codes_to_audio(codes, voc_cfg, voc_params)
