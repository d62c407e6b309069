"""Accuracy tasks: HellaSwag, Winogrande, multiple choice, and KL against
saved logits (port of vlut_tpu/eval/tasks.py; the reference's
``llama-perplexity`` task and ``--kl-divergence`` modes).

Tasks come from local JSON-lines files: {"ctx": str, "endings": [str...],
"label": int} (HellaSwag style), {"sentence": str, "option1": str,
"option2": str, "answer": 1|2} (Winogrande style) or {"question": str,
"choices": [str...], "answer": int}.  The ``.npz`` of :func:`save_logits`
has the JAX package's keys and fp16 logits, so a file saved by either
package is read by the other.
"""

from __future__ import annotations

import json
import pathlib
from typing import Sequence

import numpy as np
import torch

from vlut_tpu_torch.config import ModelConfig
from vlut_tpu_torch.eval.perplexity import (
    kl_top1,
    sequence_logits,
    window_logprobs,
)
from vlut_tpu_torch.models.transformer import TransformerLM


def score_continuations(
    model: TransformerLM,
    cfg: ModelConfig,
    context_ids: Sequence[int],
    choices_ids: Sequence[Sequence[int]],
    impl: str = "auto",
    normalize: str = "tokens",  # "none" | "tokens" (length-normalized)
) -> list[float]:
    """Log-likelihood of each choice continuation given the context."""
    scores = []
    nctx = len(context_ids)
    for ch in choices_ids:
        ids = np.asarray(list(context_ids) + list(ch), np.int32)
        tail = window_logprobs(model, cfg, ids, impl=impl)[nctx - 1:]
        s = float(tail.sum())
        if normalize == "tokens" and len(tail):
            s /= len(tail)
        scores.append(s)
    return scores


def _load_jsonl(path: str | pathlib.Path) -> list[dict]:
    return [json.loads(line) for line in
            pathlib.Path(path).read_text().splitlines() if line.strip()]


def _accuracy(task: str, items: list[dict], pick, answer) -> dict:
    correct = sum(int(pick(it) == answer(it)) for it in items)
    return {"task": task, "acc": correct / max(len(items), 1),
            "n": len(items)}


def hellaswag_eval(model, cfg, tokenizer, path, limit: int | None = None,
                   impl: str = "auto") -> dict[str, float]:
    """Pick the ending with the best length-normalized log-likelihood."""
    def pick(it):
        endings = [tokenizer.encode(" " + e, add_bos=False)
                   for e in it["endings"]]
        return int(np.argmax(score_continuations(
            model, cfg, tokenizer.encode(it["ctx"]), endings, impl=impl)))

    return _accuracy("hellaswag", _load_jsonl(path)[:limit], pick,
                     lambda it: int(it["label"]))


def winogrande_eval(model, cfg, tokenizer, path, limit: int | None = None,
                    impl: str = "auto") -> dict[str, float]:
    """Fill ``_`` with each option and score the whole sentence (mean log
    probability; the same argmax as scoring the post-blank part)."""
    def pick(it):
        scores = []
        for o in (it["option1"], it["option2"]):
            ids = tokenizer.encode(it["sentence"].replace("_", o))
            scores.append(float(window_logprobs(
                model, cfg, np.asarray(ids, np.int32), impl=impl).mean()))
        return int(np.argmax(scores)) + 1

    return _accuracy("winogrande", _load_jsonl(path)[:limit], pick,
                     lambda it: int(it["answer"]))


def multiple_choice_eval(model, cfg, tokenizer, path,
                         limit: int | None = None,
                         impl: str = "auto") -> dict[str, float]:
    """Generic multiple choice: the best length-normalized choice."""
    def pick(it):
        choices = [tokenizer.encode(" " + c, add_bos=False)
                   for c in it["choices"]]
        return int(np.argmax(score_continuations(
            model, cfg, tokenizer.encode(it["question"]), choices,
            impl=impl)))

    return _accuracy("multiple_choice", _load_jsonl(path)[:limit], pick,
                     lambda it: int(it["answer"]))


# --- KL divergence against saved logits ------------------------------------------

def save_logits(model, cfg, tokens: np.ndarray, path: str | pathlib.Path,
                window: int = 512, impl: str = "auto") -> None:
    """Run the model over the token stream in windows and save fp16 logits,
    the base file for later KL comparisons (``--kl-divergence-base``)."""
    tokens = np.asarray(tokens, np.int32)
    n = (len(tokens) // window) * window
    outs = [sequence_logits(model, cfg, tokens[i: i + window], impl)
            .cpu().numpy().astype(np.float16) for i in range(0, n, window)]
    np.savez_compressed(path, tokens=tokens[:n], logits=np.concatenate(outs, 0),
                        window=window)


def kl_vs_saved(model, cfg, path: str | pathlib.Path,
                impl: str = "auto") -> dict[str, float]:
    """KL(current || saved), top-1 agreement and both perplexities over the
    saved token stream."""
    data = np.load(path)
    tokens, base, window = data["tokens"], data["logits"], int(data["window"])
    kls, agree, nlls_a, nlls_b = [], [], [], []
    for i in range(0, len(tokens), window):
        chunk = tokens[i: i + window]
        la = sequence_logits(model, cfg, chunk, impl).cpu()
        lb = torch.from_numpy(base[i: i + window].astype(np.float32))
        kl, same, pa, pb = kl_top1(la, lb)
        kls.append(kl.numpy())
        agree.append(same.numpy())
        tgt = torch.from_numpy(chunk[1:].astype(np.int64))
        rows = torch.arange(len(tgt))
        nlls_a.append(-pa[rows, tgt].numpy())
        nlls_b.append(-pb[rows, tgt].numpy())
    kl = np.concatenate(kls)
    return {
        "kl_mean": float(kl.mean()),
        "kl_max": float(kl.max()),
        "kl_p99": float(np.percentile(kl, 99)),
        "top1_agreement": float(np.concatenate(agree).mean()),
        "ppl": float(np.exp(np.concatenate(nlls_a).mean())),
        "ppl_base": float(np.exp(np.concatenate(nlls_b).mean())),
        "tokens": int(kl.size),
    }
