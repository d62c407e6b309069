"""GBNF constrained decoding (own copy of vlut_tpu/runtime/grammar.py, which
is numpy only; the port imports nothing of the JAX package).

The grammar state lives on the host, and its only device-visible product is
a per-step boolean vocab mask fed to the sampler chain as ``allowed_mask``
(vlut_tpu_torch/runtime/sampling.py); the engine's grammar step copies it
into a static tensor before each replay.  Original notes:

Representation follows the reference: a grammar is rules -> alternates ->
element sequences, with repetition operators desugared into fresh rules
(llama-grammar.cpp parse_sequence).  Matching uses sets of pushdown stacks
advanced one Unicode code point at a time; a token is admissible iff every
code point of its text can be consumed with at least one surviving stack.
Vocab filtering walks a code-point trie of the vocabulary so shared prefixes
are checked once (the reference iterates candidates; the trie is the
host rewrite for full-vocab masks).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

# --- grammar element model ---------------------------------------------------
# item := ("char", ((lo, hi), ...), negated: bool) | ("ref", rule_id: int)
# rule := list of alternates; alternate := tuple of items

CharItem = tuple[str, tuple[tuple[int, int], ...], bool]
RefItem = tuple[str, int]


class GrammarError(ValueError):
    pass


@dataclasses.dataclass
class Grammar:
    rules: list[list[tuple]]  # rule_id -> alternates -> item tuple
    names: dict[str, int]
    root: int

    @classmethod
    def from_gbnf(cls, text: str, root: str = "root") -> "Grammar":
        return _GBNFParser(text).parse(root)


def _char_matches(item: CharItem, cp: int) -> bool:
    _, ranges, neg = item
    hit = any(lo <= cp <= hi for lo, hi in ranges)
    return hit != neg


# --- GBNF parser -------------------------------------------------------------


class _GBNFParser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.names: dict[str, int] = {}
        self.rules: dict[int, list[tuple]] = {}
        self._gen = 0

    # lexing helpers
    def _ws(self, newlines: bool = True):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":  # comment to end of line
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name_id(self, name: str) -> int:
        if name not in self.names:
            self.names[name] = len(self.names)
        return self.names[name]

    def _fresh(self, base: str) -> int:
        self._gen += 1
        return self._name_id(f"{base}_{self._gen}")

    def parse(self, root: str) -> Grammar:
        self._ws()
        while self.pos < len(self.text):
            self._parse_rule()
            self._ws()
        if root not in self.names:
            raise GrammarError(f"undefined root rule {root!r}")
        n = len(self.names)
        rules = [self.rules.get(i) for i in range(n)]
        for name, i in self.names.items():
            if rules[i] is None:
                raise GrammarError(f"undefined rule reference {name!r}")
        return Grammar(rules=rules, names=dict(self.names),
                       root=self.names[root])

    def _parse_rule(self):
        name = self._parse_name()
        self._ws()
        if self.text[self.pos : self.pos + 3] != "::=":
            raise GrammarError(f"expected '::=' after rule {name!r}")
        self.pos += 3
        rid = self._name_id(name)
        alts = self._parse_alternates(name)
        self.rules[rid] = alts

    def _parse_name(self) -> str:
        start = self.pos
        while self._peek() and (self._peek().isalnum() or self._peek() in "-_"):
            self.pos += 1
        if start == self.pos:
            raise GrammarError(
                f"expected rule name at offset {self.pos}: "
                f"{self.text[self.pos:self.pos+20]!r}"
            )
        return self.text[start : self.pos]

    def _parse_alternates(self, base: str, stop: str = "") -> list[tuple]:
        alts = [self._parse_sequence(base, stop)]
        self._ws(newlines=False)
        while self._peek() == "|":
            self.pos += 1
            alts.append(self._parse_sequence(base, stop))
            self._ws(newlines=False)
        return alts

    def _parse_sequence(self, base: str, stop: str) -> tuple:
        items: list[tuple] = []
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c == "" or c in "|)" or c in "\r\n":
                # a newline ends the rule unless continued by | on next line
                if c in "\r\n":
                    save = self.pos
                    self._ws()
                    if self._peek() == "|":
                        continue
                    self.pos = save
                break
            if c == '"':
                items.extend(self._parse_literal())
            elif c == "[":
                items.append(self._parse_char_class())
            elif c == "(":
                self.pos += 1
                rid = self._fresh(base)
                self.rules[rid] = self._parse_alternates(base, stop=")")
                if self._peek() != ")":
                    raise GrammarError("expected ')'")
                self.pos += 1
                items.append(("ref", rid))
            elif c.isalnum() or c in "-_":
                items.append(("ref", self._name_id(self._parse_name())))
            elif c == ".":
                self.pos += 1
                items.append(("char", ((0, 0x10FFFF),), False))
            else:
                raise GrammarError(
                    f"unexpected char {c!r} at offset {self.pos}"
                )
            # repetition operators bind to the last item
            items = self._maybe_repeat(items, base)
        return tuple(items)

    def _maybe_repeat(self, items: list[tuple], base: str) -> list[tuple]:
        self._ws(newlines=False)
        c = self._peek()
        if not c or c not in "*+?{" or not items:
            return items
        last = items.pop()
        if c == "*":
            self.pos += 1
            rid = self._fresh(base)
            self.rules[rid] = [(last, ("ref", rid)), ()]
            items.append(("ref", rid))
        elif c == "+":
            self.pos += 1
            rid = self._fresh(base)
            self.rules[rid] = [(last, ("ref", rid)), (last,)]
            items.append(("ref", rid))
        elif c == "?":
            self.pos += 1
            rid = self._fresh(base)
            self.rules[rid] = [(last,), ()]
            items.append(("ref", rid))
        elif c == "{":
            self.pos += 1
            start = self.pos
            while self._peek() and self._peek() != "}":
                self.pos += 1
            if not self._peek():
                raise GrammarError("unterminated {m,n} repetition")
            spec = self.text[start : self.pos]
            self.pos += 1
            if "," in spec:
                lo_s, hi_s = spec.split(",", 1)
                lo = int(lo_s) if lo_s.strip() else 0
                hi = int(hi_s) if hi_s.strip() else None
            else:
                lo = hi = int(spec)
            seq: list[tuple] = [last] * lo
            if hi is None:  # {m,} == m copies then *
                rid = self._fresh(base)
                self.rules[rid] = [(last, ("ref", rid)), ()]
                seq.append(("ref", rid))
            else:
                for _ in range(hi - lo):
                    rid = self._fresh(base)
                    self.rules[rid] = [(last,), ()]
                    seq.append(("ref", rid))
            items.extend(seq)
        return items

    def _parse_escaped_char(self) -> int:
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self.text[self.pos]
        self.pos += 1
        simple = {"n": 10, "t": 9, "r": 13, '"': 34, "\\": 92, "[": 91,
                  "]": 93, "^": 94, "-": 45, "/": 47}
        if e in simple:
            return simple[e]
        if e == "x":
            v = int(self.text[self.pos : self.pos + 2], 16)
            self.pos += 2
            return v
        if e == "u":
            v = int(self.text[self.pos : self.pos + 4], 16)
            self.pos += 4
            return v
        if e == "U":
            v = int(self.text[self.pos : self.pos + 8], 16)
            self.pos += 8
            return v
        raise GrammarError(f"bad escape \\{e}")

    def _parse_literal(self) -> list[tuple]:
        assert self._peek() == '"'
        self.pos += 1
        out = []
        while self._peek() != '"':
            if self.pos >= len(self.text):
                raise GrammarError("unterminated string literal")
            cp = self._parse_escaped_char()
            out.append(("char", ((cp, cp),), False))
        self.pos += 1
        return out

    def _parse_char_class(self) -> tuple:
        assert self._peek() == "["
        self.pos += 1
        neg = False
        if self._peek() == "^":
            neg = True
            self.pos += 1
        ranges: list[tuple[int, int]] = []
        while self._peek() != "]":
            if self.pos >= len(self.text):
                raise GrammarError("unterminated char class")
            lo = self._parse_escaped_char()
            hi = lo
            if self._peek() == "-" and self.text[self.pos + 1] != "]":
                self.pos += 1
                hi = self._parse_escaped_char()
            ranges.append((lo, hi))
        self.pos += 1
        return ("char", tuple(ranges), neg)


# --- pushdown matcher --------------------------------------------------------


def _expand(grammar: Grammar, stack: tuple) -> frozenset:
    """Expand rule refs at the top of the stack until each resulting stack is
    empty or has a char matcher on top.  Returns a set of stacks."""
    out = set()
    work = [stack]
    seen = set()
    while work:
        st = work.pop()
        if st in seen:
            continue
        seen.add(st)
        if not st or st[0][0] == "char":
            out.add(st)
            continue
        _, rid = st[0]
        rest = st[1:]
        for alt in grammar.rules[rid]:
            work.append(tuple(alt) + rest)
    return frozenset(out)


class GrammarState:
    """Set-of-stacks matcher state (llama_grammar stacks analog)."""

    def __init__(self, grammar: Grammar, stacks: frozenset | None = None):
        self.g = grammar
        if stacks is None:
            stacks = _expand(grammar, (("ref", grammar.root),))
        self.stacks = stacks

    def clone(self) -> "GrammarState":
        return GrammarState(self.g, self.stacks)

    @property
    def can_end(self) -> bool:
        return () in self.stacks

    @property
    def dead(self) -> bool:
        return not self.stacks

    def advance_char(self, cp: int) -> "GrammarState":
        nxt = set()
        for st in self.stacks:
            if st and st[0][0] == "char" and _char_matches(st[0], cp):
                nxt |= _expand(self.g, st[1:])
        return GrammarState(self.g, frozenset(nxt))

    def advance_text(self, text: str) -> "GrammarState":
        s = self
        for ch in text:
            s = s.advance_char(ord(ch))
            if s.dead:
                break
        return s

    def accepts_text_prefix(self, text: str) -> bool:
        """True if every char of text can be consumed (state need not end)."""
        return not self.advance_text(text).dead


# --- vocab trie + mask producer ---------------------------------------------


class _TrieNode:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.token_ids: list[int] = []


class VocabTrie:
    """Code-point trie over detokenized piece strings; built once per vocab."""

    def __init__(self, pieces: list[str]):
        self.root = _TrieNode()
        self.n = len(pieces)
        self.empty_ids: list[int] = []
        for tid, text in enumerate(pieces):
            if text is None:
                continue
            if text == "":
                self.empty_ids.append(tid)
                continue
            node = self.root
            for ch in text:
                cp = ord(ch)
                nxt = node.children.get(cp)
                if nxt is None:
                    nxt = node.children[cp] = _TrieNode()
                node = nxt
            node.token_ids.append(tid)


class GrammarSampler:
    """Per-sequence grammar constraint: produces vocab masks, accepts tokens.

    ``pieces`` must be the decoded text of each vocab id (same detokenizer
    the engine uses).  ``eos_ids`` are allowed exactly when the grammar can
    terminate (reference: grammar sampler forces EOG when no candidate is
    viable / allows EOG only at accept states).
    """

    def __init__(
        self,
        grammar: Grammar | str,
        pieces: list[str],
        eos_ids: Iterable[int] = (),
        trie: VocabTrie | None = None,
    ):
        if isinstance(grammar, str):
            grammar = Grammar.from_gbnf(grammar)
        self.grammar = grammar
        self.pieces = pieces
        self.eos_ids = tuple(eos_ids)
        self.trie = trie or VocabTrie(pieces)
        self.state = GrammarState(grammar)
        # see mask(): exact memoization of masks / char advances
        self._mask_cache: dict = {}
        self._advance_cache: dict = {}

    def reset(self):
        self.state = GrammarState(self.grammar)

    def accept(self, token_id: int):
        if token_id in self.eos_ids:
            return
        text = self.pieces[token_id]
        if text:
            self.state = self.state.advance_text(text)
        if self.state.dead:
            raise GrammarError(
                f"token {token_id} ({text!r}) not admissible under grammar"
            )

    def mask(self) -> np.ndarray:
        """(V,) bool: tokens whose full text is consumable from the current
        state; EOS ids allowed iff the grammar can end here.

        Memoized two ways (measured on a synthetic 128k-piece BPE vocab,
        scripts/exp_grammar_cost.py: the raw DFS costs ~1.1 s/token under
        a JSON-schema grammar — 300x a 3.4 ms decode step — because a
        permissive string-body state reaches nearly every trie node):
        * whole masks keyed by the state's stack set — the string-body
          state RECURS every token, so steady-state decode is a dict hit;
        * (stacks, char) -> stacks advances shared across the walk and
          across calls, collapsing repeated subtree transitions.
        The reference pays the same walk in C++ per token
        (src/llama-grammar.cpp llama_grammar_apply_impl); memoization is
        the Python-host answer, and is exact (states are value-keyed)."""
        key = self.state.stacks
        hit = self._mask_cache.get(key)
        if hit is not None:
            return hit
        g = self.grammar
        adv = self._advance_cache
        allowed = np.zeros((self.trie.n,), bool)
        # DFS over (trie node, stack set); prune dead branches once
        stack = [(self.trie.root, key)]
        while stack:
            node, stacks = stack.pop()
            for tid in node.token_ids:
                allowed[tid] = True
            for cp, child in node.children.items():
                akey = (stacks, cp)
                ns = adv.get(akey)
                if ns is None:
                    nxt = set()
                    for st in stacks:
                        if st and st[0][0] == "char" and _char_matches(
                            st[0], cp
                        ):
                            nxt |= _expand(g, st[1:])
                    ns = adv[akey] = frozenset(nxt)
                if ns:
                    stack.append((child, ns))
        if self.state.can_end:
            for e in self.eos_ids:
                allowed[e] = True
        allowed.setflags(write=False)  # cached array is shared
        self._mask_cache[key] = allowed
        return allowed


class LazyGrammarSampler:
    """Trigger-activated grammar constraint (tool_choice="auto").

    Reference: common/chat.cpp builds tool grammars with ``grammar_lazy``
    plus ``grammar_triggers`` (token ids / words / patterns), and the
    sampler applies the grammar only once a trigger fires
    (tools/server/server-context.cpp wiring; llama-sampling's lazy grammar
    sampler).  Here: generation is unconstrained free-form text until one
    of the trigger strings appears in the decoded output; from the
    trigger's FIRST character on, the wrapped :class:`GrammarSampler`
    constrains decoding, so auto-mode output is either prose or a
    schema-valid tool call — never a malformed call.

    A trigger may arrive split across tokens, or embedded mid-token with
    prose before it; the rolling text buffer handles both, and the grammar
    is fed the activating text starting at the trigger match.
    """

    def __init__(self, inner: GrammarSampler, triggers: Iterable[str]):
        self.inner = inner
        self.triggers = [t for t in triggers if t]
        if not self.triggers:
            raise GrammarError("lazy grammar needs at least one trigger")
        self.active = False
        self._buf = ""
        # keep enough tail to catch a trigger split across token pieces
        self._keep = max(len(t) for t in self.triggers) - 1

    @property
    def inactive(self) -> bool:
        """True while unconstrained (engine skips mask application)."""
        return not self.active

    @property
    def eos_ids(self):
        return self.inner.eos_ids

    def reset(self):
        self.inner.reset()
        self.active = False
        self._buf = ""

    def accept(self, token_id: int):
        if self.active:
            self.inner.accept(token_id)
            return
        if token_id in self.inner.eos_ids:
            return
        text = self.inner.pieces[token_id] or ""
        self._buf += text
        hit = min(
            (i for i in (self._buf.find(t) for t in self.triggers)
             if i >= 0),
            default=-1,
        )
        if hit < 0:
            if self._keep:
                self._buf = self._buf[-self._keep:]
            else:
                self._buf = ""
            return
        # activate: grammar input starts at the trigger's first char
        self.active = True
        tail = self._buf
        self._buf = ""
        self.inner.state = self.inner.state.advance_text(tail[hit:])
        if self.inner.state.dead:
            raise GrammarError(
                f"trigger text {tail[hit:]!r} not admissible under grammar"
            )

    def mask(self) -> np.ndarray:
        if self.active:
            return self.inner.mask()
        return np.ones((self.inner.trie.n,), bool)


# --- JSON schema -> GBNF -----------------------------------------------------

_SPACE = 'ws ::= [ \\t\\n]{0,4}\n'
_PRIMITIVES = r"""
value ::= object | array | string | number | boolean | null
object ::= "{" ws ( member ( "," ws member )* )? ws "}"
member ::= string ws ":" ws value
array ::= "[" ws ( value ( "," ws value )* )? ws "]"
string ::= "\"" char* "\""
char ::= [^"\\\x00-\x1f] | "\\" (["\\bfnrt/] | "u" [0-9a-fA-F]{4})
number ::= "-"? ("0" | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)?
integer ::= "-"? ("0" | [1-9] [0-9]*)
boolean ::= "true" | "false"
null ::= "null"
"""


def _lit(s: str) -> str:
    out = s.replace("\\", "\\\\").replace('"', '\\"')
    out = out.replace("\n", "\\n").replace("\t", "\\t").replace("\r", "\\r")
    return f'"{out}"'


def json_schema_to_gbnf(schema: dict) -> str:
    """JSON schema -> GBNF (common/json-schema-to-grammar.cpp analog).

    Supported subset: type (object/array/string/number/integer/boolean/null),
    properties + required + additionalProperties:false default, enum, const,
    items / prefixItems, minItems/maxItems, anyOf/oneOf, internal $ref,
    bare {} -> any value.
    """
    defs: dict[str, str] = {}
    counter = [0]
    root_schema = schema

    def resolve_ref(ref: str) -> dict:
        node = root_schema
        assert ref.startswith("#/"), f"only internal $refs supported: {ref}"
        for part in ref[2:].split("/"):
            node = node[part]
        return node

    def gen(s: dict, name: str) -> str:
        """Returns a GBNF expression (inline) for schema s; may add defs."""
        if not isinstance(s, dict) or s == {}:
            return "value"
        if "$ref" in s:
            return gen(resolve_ref(s["$ref"]), name)
        if "const" in s:
            import json as _json

            return _lit(_json.dumps(s["const"]))
        if "enum" in s:
            import json as _json

            return "( " + " | ".join(_lit(_json.dumps(v)) for v in s["enum"]) + " )"
        if "anyOf" in s or "oneOf" in s:
            subs = s.get("anyOf") or s.get("oneOf")
            return (
                "( "
                + " | ".join(gen(x, f"{name}-alt{i}") for i, x in enumerate(subs))
                + " )"
            )
        t = s.get("type")
        if isinstance(t, list):
            return "( " + " | ".join(
                gen({**s, "type": x}, f"{name}-{x}") for x in t
            ) + " )"
        if t == "object" and "properties" in s:
            import json as _json

            props = s["properties"]
            required = set(s.get("required", props.keys()))
            kvs = []
            for k, sub in props.items():
                sub_expr = gen(sub, f"{name}-{k}")
                kvs.append(
                    (k in required, f'{_lit(_json.dumps(k))} ws ":" ws {sub_expr}')
                )
            req = [kv for is_r, kv in kvs if is_r]
            # property order is preserved; optionals may appear anywhere in
            # the original order, but we emit requireds first then optionals
            # (matches the reference converter's canonicalized ordering)
            opt = [kv for is_r, kv in kvs if not is_r]
            rule = '"{" ws '
            if req:
                rule += f"{req[0]} ws "
                for kv in req[1:]:
                    rule += f'"," ws {kv} ws '
                for kv in opt:
                    rule += f'( "," ws {kv} ws )? '
            elif opt:
                # no required props: first-present alternates so separators
                # stay correct for any present/absent combination
                alts = []
                for i, kv in enumerate(opt):
                    alt = f"{kv} ws "
                    for kv2 in opt[i + 1 :]:
                        alt += f'( "," ws {kv2} ws )? '
                    alts.append(alt.strip())
                rule += "( " + " | ".join(alts) + " )? "
            rule += '"}"'
            counter[0] += 1
            rname = f"{name}" if name else f"obj{counter[0]}"
            defs[rname] = rule
            return rname
        if t == "object":
            return "object"
        if t == "array":
            items = s.get("items", {})
            if isinstance(s.get("prefixItems"), list):
                seq = ' "," ws '.join(
                    gen(x, f"{name}-it{i}")
                    for i, x in enumerate(s["prefixItems"])
                )
                return f'"[" ws {seq} ws "]"'
            it = gen(items, f"{name}-item")
            lo = s.get("minItems", 0)
            hi = s.get("maxItems")
            if lo == 0 and hi is None:
                return f'"[" ws ( {it} ( "," ws {it} )* )? ws "]"'
            reps = []
            if lo > 0:
                body = f'{it} ( "," ws {it} ){{{lo-1},{hi-1 if hi else ""}}}'.replace("{0,}", "*")
                return f'"[" ws {body} ws "]"'
            else:
                body = f'( {it} ( "," ws {it} ){{0,{hi-1}}} )?'
                return f'"[" ws {body} ws "]"'
        if t == "string":
            return "string"
        if t in ("number",):
            return "number"
        if t == "integer":
            return "integer"
        if t == "boolean":
            return "boolean"
        if t == "null":
            return "null"
        return "value"

    expr = gen(schema, "root0")
    lines = [f"root ::= ws {expr} ws" if expr != "root0" else "root ::= ws root0 ws"]
    for rname, rule in defs.items():
        lines.append(f"{rname} ::= {rule}")
    lines.append(_SPACE.strip())
    lines.append(_PRIMITIVES.strip())
    return "\n".join(lines) + "\n"


# --- regex -> GBNF -----------------------------------------------------------

_CLASS_SHORTHAND = {
    "d": "0-9",
    "w": "a-zA-Z0-9_",
    "s": " \\t\\n\\r",
}
_CTRL = {"n": "\\n", "t": "\\t", "r": "\\r"}
# chars that must be escaped inside a GBNF char class body
_CLASS_META = set("]\\^-")


def regex_to_gbnf(pattern: str) -> str:
    """Regex -> GBNF for constrained decoding (the reference's opt-in
    llguidance path accepts regex constraints; common/llguidance.cpp).

    Whole-match semantics.  Supported subset: literals, ``.``, escapes
    (``\\d \\D \\w \\W \\s \\S`` + control/identity escapes), char classes
    with ranges/negation/shorthands, groups ``( )`` / ``(?: )``,
    alternation ``|``, quantifiers ``* + ? {m} {m,} {m,n}`` (non-greedy
    suffixes accepted — greediness is moot for a token mask), and
    anchors ``^ $`` at the ends (implied).  Backrefs and lookaround raise.
    """
    pos = [0]
    n = len(pattern)

    def peek() -> str:
        return pattern[pos[0]] if pos[0] < n else ""

    def take() -> str:
        c = peek()
        pos[0] += 1
        return c

    def class_escape_body(c: str) -> str:
        """One escaped char -> GBNF char-class fragment."""
        if c in _CLASS_SHORTHAND:
            return _CLASS_SHORTHAND[c]
        if c in _CTRL:
            return _CTRL[c]
        if c in _CLASS_META:
            return "\\" + c
        if c in "DWS":
            raise GrammarError(
                f"negated shorthand \\{c} unsupported inside a class"
            )
        return re_lit_class(c)

    def re_lit_class(c: str) -> str:
        return ("\\" + c) if c in _CLASS_META else c

    def parse_alt() -> str:
        parts = [parse_concat()]
        while peek() == "|":
            take()
            parts.append(parse_concat())
        return " | ".join(p if p else '""' for p in parts)

    def parse_concat() -> str:
        items: list[str] = []
        while peek() and peek() not in "|)":
            items.append(parse_repeat())
        return " ".join(i for i in items if i)

    def parse_repeat() -> str:
        atom = parse_atom()
        c = peek()
        if c and (c in "*+?" or (c == "{" and _looks_like_rep())):
            if c == "{":
                take()
                spec = ""
                while peek() != "}":
                    spec += take()
                take()
                op = "{" + spec + "}"
            else:
                op = take()
            if peek() == "?":  # non-greedy: same language
                take()
            if not atom:
                raise GrammarError(f"quantifier {op!r} with nothing to repeat")
            return f"{atom}{op}"
        return atom

    def _looks_like_rep() -> bool:
        # '{' only starts a quantifier if it closes as {m}, {m,}, {m,n}
        j = pos[0] + 1
        seen_digit = False
        seen_comma = False
        while j < n:
            ch = pattern[j]
            if ch.isdigit():
                seen_digit = True
            elif ch == "," and not seen_comma:
                seen_comma = True
            elif ch == "}":
                return seen_digit
            else:
                return False
            j += 1
        return False

    def parse_atom() -> str:
        c = take()
        if c == "(":
            if peek() == "?":
                take()
                m = take()
                if m != ":":
                    raise GrammarError(
                        f"unsupported group (?{m}...) — only (?:...) "
                        "and capturing groups"
                    )
            inner = parse_alt()
            if take() != ")":
                raise GrammarError("unbalanced '(' in regex")
            return f"( {inner} )"
        if c == "[":
            neg = peek() == "^"
            if neg:
                take()
            body = ""
            while peek() != "]":
                if not peek():
                    raise GrammarError("unterminated char class")
                ch = take()
                if ch == "\\":
                    body += class_escape_body(take())
                elif ch == "-" and body and peek() not in "]":
                    # range: keep as-is (next char appended on next loop)
                    body += "-"
                else:
                    body += re_lit_class(ch)
            take()
            return f"[{'^' if neg else ''}{body}]"
        if c == ".":
            return "[^\\n]"  # regex dot: any char but newline
        if c == "\\":
            e = take()
            if not e:
                raise GrammarError("trailing backslash")
            if e in _CLASS_SHORTHAND:
                return f"[{_CLASS_SHORTHAND[e]}]"
            if e in "DWS":
                return f"[^{_CLASS_SHORTHAND[e.lower()]}]"
            if e in _CTRL:
                return f"[{_CTRL[e]}]"
            if e.isdigit():
                raise GrammarError("backreferences are unsupported")
            if e == "b":
                raise GrammarError("word-boundary \\b is unsupported")
            return f"[{re_lit_class(e)}]"
        if c in "^$":
            # anchors at the pattern edges are implied (whole match)
            if (c == "^" and pos[0] == 1) or (c == "$" and pos[0] == n):
                return ""
            raise GrammarError(f"mid-pattern anchor {c!r} unsupported")
        if c in "*+?":
            raise GrammarError(f"quantifier {c!r} with nothing to repeat")
        return f"[{re_lit_class(c)}]"

    expr = parse_alt()
    if pos[0] != n:
        raise GrammarError(
            f"unbalanced ')' at offset {pos[0]} in regex {pattern!r}"
        )
    return f"root ::= {expr}\n"


def tool_call_gbnf(tools: list, parallel: bool = True) -> str:
    """Tool definitions -> a GBNF constraining generation to well-formed
    Hermes-style tool calls (reference: common/chat.cpp builds a grammar
    per chat format from the tool JSON schemas; this is the
    template-generic <tool_call>{"name", "arguments"}</tool_call> form the
    server's tool_choice="required" uses).

    Each call is forced to one of the declared function names with
    arguments constrained by that tool's parameter schema.
    """
    alts = []
    for t in tools:
        fn = t.get("function", t)
        args = fn.get("parameters") or {"type": "object"}
        alts.append({
            "type": "object",
            "properties": {
                "name": {"const": fn["name"]},
                "arguments": args,
            },
            "required": ["name", "arguments"],
        })
    inner = json_schema_to_gbnf({"anyOf": alts})
    lines = inner.splitlines()
    if not lines[0].startswith("root ::="):
        raise AssertionError("json_schema_to_gbnf root layout changed")
    lines[0] = "tooljson ::=" + lines[0][len("root ::="):]
    rep = "+" if parallel else ""
    envelope = (
        f"root ::= toolcall{rep} ws\n"
        'toolcall ::= ws "<tool_call>" tooljson "</tool_call>"\n'
    )
    return envelope + "\n".join(lines) + "\n"
