"""Tokenizer host layer (port of vlut_tpu/utils/tokenizer.py: encode,
decode, the chat template and the grammar engine's view of the
vocabulary).

``transformers`` is imported when a Tokenizer is made, so the rest of the
port never needs it.  Where it is not installed, a checkpoint whose
``tokenizer.json`` is a character-level WordLevel vocabulary (the
``tests/fixtures/tiny_real`` kind) is read by :class:`CharWordLevel`, which
encodes and decodes as the Hugging Face tokenizer does for such a file and
renders the ChatML fallback template without jinja.
"""

from __future__ import annotations

import json
import pathlib
import re
from collections.abc import Mapping
from typing import Any


_SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token",
                  "pad_token", "cls_token", "mask_token",
                  "additional_special_tokens")


def special_id_of(vocab: Mapping[str, int], tok) -> int | None:
    """The id of a tokenizer config's special token (a string, or a dict
    with its ``content``), None when absent."""
    if tok is None:
        return None
    return vocab.get(tok["content"] if isinstance(tok, dict) else tok)


class CharWordLevel:
    """A WordLevel vocabulary behind a ``Split("", "isolated")``
    pre-tokenizer: one token per character, special tokens matched whole,
    no post-processor; decode joins the tokens with spaces."""

    def __init__(self, path: str | pathlib.Path):
        path = pathlib.Path(path)
        spec = json.loads((path / "tokenizer.json").read_text())
        pre = spec.get("pre_tokenizer") or {}
        cfg_file = path / "tokenizer_config.json"
        cfg = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
        if (spec["model"]["type"] != "WordLevel" or pre.get("type") != "Split"
                or pre.get("pattern") != {"String": ""}
                or spec.get("post_processor") or spec.get("decoder")
                or spec.get("normalizer")
                or cfg.get("clean_up_tokenization_spaces", True)):
            raise RuntimeError(
                f"{path}: only character-level WordLevel tokenizers are read "
                "without transformers")
        added = sorted(spec.get("added_tokens", ()), key=lambda t: t["id"])
        # the added tokens (ids past the WordLevel vocabulary too), each
        # matched whole, the longest first
        self.added = {t["content"]: t["id"] for t in added}
        self.vocab: dict[str, int] = {**spec["model"]["vocab"], **self.added}
        self.unk = self.vocab[spec["model"]["unk_token"]]
        self.inv = {i: s for s, i in self.vocab.items()}
        self.special = {t["content"]: t["id"] for t in added
                        if t.get("special")}
        self._split = (re.compile("(" + "|".join(map(re.escape, sorted(
            self.added, key=len, reverse=True))) + ")")
            if self.added else None)
        def special_id(name):
            return special_id_of(self.vocab, cfg.get(name))

        self.eos_token_id = special_id("eos_token")
        self.bos_token_id = special_id("bos_token")
        # Hugging Face's order: the special-token attributes as the
        # tokenizer config and special_tokens_map.json name them, then the
        # additional ones, each once
        smap_file = path / "special_tokens_map.json"
        smap = {**cfg, **(json.loads(smap_file.read_text())
                          if smap_file.exists() else {})}
        ids: list[int] = []
        for name in _SPECIAL_ATTRS:
            toks = smap.get(name)
            for t in (toks if isinstance(toks, list) else [toks]):
                i = special_id_of(self.vocab, t)
                if i is not None and i not in ids:
                    ids.append(i)
        self.all_special_ids = ids
        self.chat_template = cfg.get("chat_template")

    def get_added_vocab(self) -> dict[str, int]:
        """The added tokens' text -> id, by id (Hugging Face's
        ``get_added_vocab``)."""
        return dict(self.added)

    def __len__(self) -> int:
        return len(self.vocab)

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        parts = self._split.split(text) if self._split else [text]
        ids: list[int] = []
        for part in parts:
            if part in self.added:
                ids.append(self.added[part])
            else:
                ids.extend(self.vocab.get(c, self.unk) for c in part)
        return ids

    def decode(self, ids: list[int], skip_special_tokens: bool = False) -> str:
        """Ids outside the vocabulary are skipped, as the Hugging Face
        tokenizer skips them."""
        pieces = (self.inv.get(int(i)) for i in ids)
        return " ".join(p for p in pieces if p is not None and not (
            skip_special_tokens and p in self.special))


def render_chatml(messages: list[dict[str, Any]],
                  add_generation_prompt: bool = True) -> str:
    """ChatML, the reference server's default template for a checkpoint
    that carries none (common/chat.cpp's chatml fallback, which the JAX
    package renders through jinja), by string assembly: that template has
    no whitespace control, so jinja gives this text."""
    text = "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
                   for m in messages)
    return text + ("<|im_start|>assistant\n" if add_generation_prompt else "")


class Tokenizer:
    def __init__(self, path: str | pathlib.Path):
        try:
            from transformers import AutoTokenizer
        except ImportError:
            self.tk = CharWordLevel(path)
        else:
            self.tk = AutoTokenizer.from_pretrained(str(path))

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return list(self.tk.encode(text, add_special_tokens=add_bos))

    def decode(self, ids: list[int]) -> str:
        return self.tk.decode(ids, skip_special_tokens=False)

    def apply_chat_template(self, messages: list[dict[str, Any]],
                            add_generation_prompt: bool = True,
                            tools: list[dict[str, Any]] | None = None,
                            ) -> list[int]:
        """Token ids of ``messages`` under the checkpoint's chat template
        (Hugging Face's jinja), or ChatML (:func:`render_chatml`) where it
        has none; ``tools`` reach a template that reads them (ChatML does
        not).  The text is encoded without special tokens, as Hugging
        Face's ``apply_chat_template`` does."""
        if getattr(self.tk, "chat_template", None) is None:
            return list(self.tk.encode(
                render_chatml(messages, add_generation_prompt),
                add_special_tokens=False))
        if isinstance(self.tk, CharWordLevel):
            raise RuntimeError("rendering a checkpoint's own chat template "
                               "needs transformers (jinja)")
        ids = self.tk.apply_chat_template(
            messages, add_generation_prompt=add_generation_prompt,
            tokenize=True, return_dict=False,
            **({"tools": tools} if tools else {}))
        # some transformers releases answer a BatchEncoding all the same
        return list(ids["input_ids"] if isinstance(ids, Mapping) else ids)

    @property
    def fim_prefix_token_id(self) -> int | None:
        return getattr(self.tk, "fim_prefix_token_id", None)

    @property
    def fim_suffix_token_id(self) -> int | None:
        return getattr(self.tk, "fim_suffix_token_id", None)

    @property
    def fim_middle_token_id(self) -> int | None:
        return getattr(self.tk, "fim_middle_token_id", None)

    @property
    def eos_id(self) -> int | None:
        return self.tk.eos_token_id

    @property
    def bos_id(self) -> int | None:
        return self.tk.bos_token_id

    def pieces(self) -> list[str]:
        """Decoded text of every vocab id, the grammar engine's view of the
        vocabulary; special tokens decode to "" so grammars never emit
        them.  Cached."""
        if getattr(self, "_pieces", None) is None:
            special = set(self.tk.all_special_ids)
            self._pieces = [
                "" if i in special
                else self.tk.decode([i], skip_special_tokens=False)
                for i in range(len(self.tk))]
        return self._pieces

    def make_grammar(self, gbnf: str):
        """A GrammarSampler bound to this vocabulary (EOS allowed at the
        grammar's accept states); the vocab trie is built once and shared
        by every grammar."""
        from vlut_tpu_torch.runtime.grammar import GrammarSampler, VocabTrie

        if getattr(self, "_trie", None) is None:
            self._trie = VocabTrie(self.pieces())
        eos = (self.eos_id,) if self.eos_id is not None else ()
        return GrammarSampler(gbnf, self.pieces(), eos_ids=eos,
                              trie=self._trie)
