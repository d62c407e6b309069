"""Tokenizer host layer (port of vlut_tpu/utils/tokenizer.py, encode and
decode only).

``transformers`` is imported when a Tokenizer is made, so the rest of the
port never needs it.  Where it is not installed, a checkpoint whose
``tokenizer.json`` is a character-level WordLevel vocabulary (the
``tests/fixtures/tiny_real`` kind) is read by :class:`CharWordLevel`, which
encodes and decodes as the Hugging Face tokenizer does for such a file.
"""

from __future__ import annotations

import json
import pathlib
import re


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
        self.vocab: dict[str, int] = spec["model"]["vocab"]
        self.unk = self.vocab[spec["model"]["unk_token"]]
        self.inv = {i: s for s, i in self.vocab.items()}
        special = [t["content"] for t in spec.get("added_tokens", ())
                   if t.get("special")]
        self.special = {s: self.vocab[s] for s in special}
        self._split = (re.compile("(" + "|".join(map(re.escape, special)) + ")")
                       if special else None)
        def special_id(name):
            tok = cfg.get(name)
            return self.vocab.get(tok["content"] if isinstance(tok, dict)
                                  else tok)

        self.eos_token_id = special_id("eos_token")
        self.bos_token_id = special_id("bos_token")

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        parts = self._split.split(text) if self._split else [text]
        ids: list[int] = []
        for part in parts:
            if part in self.special:
                ids.append(self.special[part])
            else:
                ids.extend(self.vocab.get(c, self.unk) for c in part)
        return ids

    def decode(self, ids: list[int], skip_special_tokens: bool = False) -> str:
        """Ids outside the vocabulary are skipped, as the Hugging Face
        tokenizer skips them."""
        pieces = (self.inv.get(int(i)) for i in ids)
        return " ".join(p for p in pieces if p is not None and not (
            skip_special_tokens and p in self.special))


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

    @property
    def eos_id(self) -> int | None:
        return self.tk.eos_token_id

    @property
    def bos_id(self) -> int | None:
        return self.tk.bos_token_id
