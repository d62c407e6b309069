"""The port's grammar-constrained sampling against the JAX package's on the
CPU.

The port keeps its own copy of the numpy grammar engine: over
``tiny_real``'s vocabulary pieces, its masks are bit-equal to the JAX
``GrammarSampler.mask()`` for a GBNF, a lazy grammar, a regex and a JSON
schema, step by step along an accepted string, and its GBNF translations
of schemas and regexes are the same strings.  Through the engine, a
request with a grammar gives the JAX engine's tokens (``impl=
"pallas_interpret"``), the output parses under its grammar, and a wedged
grammar ends the request with EOS.
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from vlut_tpu.convert.checkpoint import load_checkpoint as jax_load
from vlut_tpu.runtime import grammar as jg
from vlut_tpu.runtime.engine import Engine as JaxEngine
from vlut_tpu.runtime.engine import Request as JaxRequest
from vlut_tpu.runtime.sampling import SamplerParams as JaxSampler
from vlut_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.runtime import grammar as pg
from vlut_tpu_torch.runtime.engine import Engine, Request
from vlut_tpu_torch.runtime.sampling import SamplerParams
from vlut_tpu_torch.utils.tokenizer import CharWordLevel, Tokenizer

torch.set_num_threads(1)

TINY_REAL = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"
SCHEMA = {"type": "object",
          "properties": {"a": {"type": "integer"},
                         "b": {"type": "string", "maxLength": 4},
                         "c": {"type": "array", "items": {"enum": [1, 2]}}},
          "required": ["a", "b"]}
REGEX = r"[a-c]{2,4}-\d+(x|yz)?"
GBNF = 'root ::= "The " ("model" | "lines") " " [a-z]+ "."'


@functools.lru_cache(maxsize=None)
def _toks():
    return JaxTokenizer(TINY_REAL), Tokenizer(TINY_REAL)


def test_pieces_equal_and_char_tokenizer_pieces():
    jt_, pt_ = _toks()
    assert pt_.pieces() == jt_.pieces()
    char = Tokenizer.__new__(Tokenizer)
    char.tk = CharWordLevel(TINY_REAL)
    assert char.pieces() == jt_.pieces()


@pytest.mark.parametrize("schema", [SCHEMA, {}, {"type": "array",
                                                 "items": {"type": "number"},
                                                 "minItems": 1}])
def test_json_schema_gbnf_strings_equal(schema):
    assert pg.json_schema_to_gbnf(schema) == jg.json_schema_to_gbnf(schema)


@pytest.mark.parametrize("rx", [REGEX, r"(ab|cd)*e?", r"[^0-9]{1,3}\.\w"])
def test_regex_gbnf_strings_equal(rx):
    assert pg.regex_to_gbnf(rx) == jg.regex_to_gbnf(rx)


def test_tool_call_gbnf_equal():
    tools = [{"type": "function", "function": {
        "name": "get", "parameters": {"type": "object", "properties": {
            "q": {"type": "string"}}, "required": ["q"]}}}]
    assert pg.tool_call_gbnf(tools) == jg.tool_call_gbnf(tools)


CASES = {
    "gbnf": (GBNF, 'The model abc.'),
    "regex": (REGEX, "abc-42yz"),
    "json_schema": (SCHEMA, '{"a": 12, "b": "xy"}'),
}


def _make(side, kind):
    tok = _toks()[0 if side == "jax" else 1]
    mod = jg if side == "jax" else pg
    src = CASES[kind][0]
    gbnf = {"gbnf": lambda: src, "regex": lambda: mod.regex_to_gbnf(src),
            "json_schema": lambda: mod.json_schema_to_gbnf(src)}[kind]()
    return tok.make_grammar(gbnf)


@pytest.mark.parametrize("kind", list(CASES))
def test_masks_bit_equal_along_an_accepted_string(kind):
    """Both samplers walk the same token ids (the accepted text, one
    character piece at a time); at every step the masks are equal."""
    gj, gp = _make("jax", kind), _make("port", kind)
    text = CASES[kind][1]
    ids = _toks()[1].encode(text, add_bos=False)
    for t in ids:
        mj, mp = gj.mask(), gp.mask()
        np.testing.assert_array_equal(mp, mj)
        assert mp[t], (kind, text, t)
        gj.accept(t)
        gp.accept(t)
    np.testing.assert_array_equal(gp.mask(), gj.mask())
    assert gp.mask()[_toks()[1].eos_id]  # complete: EOS allowed


def test_lazy_grammar_masks_equal():
    """Free text until the trigger, constrained from there on."""
    jt_, pt_ = _toks()
    gj = jg.LazyGrammarSampler(jt_.make_grammar('root ::= "n=" [0-9]+ ";"'),
                               ["n="])
    gp = pg.LazyGrammarSampler(pt_.make_grammar('root ::= "n=" [0-9]+ ";"'),
                               ["n="])
    for t in pt_.encode("so n=42;", add_bos=False):
        assert gp.inactive == gj.inactive
        np.testing.assert_array_equal(gp.mask(), gj.mask())
        gj.accept(t)
        gp.accept(t)
    assert not gp.inactive
    np.testing.assert_array_equal(gp.mask(), gj.mask())


@functools.lru_cache(maxsize=None)
def _jax_engine_outputs(q8):
    cfg, params, _ = jax_load(TINY_REAL, stream=False)
    jt_ = _toks()[0]
    eng = JaxEngine(cfg, params, n_slots=2, max_len=128, kv_quant=q8,
                    impl="pallas_interpret")
    return _run(eng, JaxRequest, JaxSampler, jt_, jg)


def _run(eng, req_cls, sampler_cls, tok, mod):
    prompts = ["The little model", "reads the", "The"]
    grams = [tok.make_grammar(GBNF),
             tok.make_grammar(mod.json_schema_to_gbnf(SCHEMA)), None]
    reqs = [req_cls(prompt=tok.encode(p), max_new_tokens=24,
                    sampler=sampler_cls(temperature=0.0),
                    stop_tokens=(tok.eos_id,), grammar=g)
            for p, g in zip(prompts, grams)]
    eng.run(reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_engine_grammar_requests_match_jax(q8):
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    pt_ = _toks()[1]
    eng = Engine(cfg, model, n_slots=2, max_len=128, kv_quant=q8)
    got = _run(eng, Request, SamplerParams, pt_, pg)
    assert got == _jax_engine_outputs(q8)
    # the first output parses under its grammar (EOS ends it)
    out = [t for t in got[0] if t != pt_.eos_id]
    state = pg.GrammarState(pg.Grammar.from_gbnf(GBNF))
    state = state.advance_text("".join(pt_.pieces()[t] for t in out))
    assert not state.dead
    keys = [p["features"] for p in eng.step_programs()]
    assert ["grammar"] in keys and [] in keys


def test_wedged_grammar_forces_eos():
    """A grammar that admits no vocabulary piece at its root allows only
    EOS: the request ends at once with it."""
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    pt_ = _toks()[1]
    eng = Engine(cfg, model, n_slots=1, max_len=64)
    req = Request(prompt=pt_.encode("The"), max_new_tokens=8,
                  sampler=SamplerParams(temperature=0.0),
                  stop_tokens=(pt_.eos_id,),
                  grammar=pt_.make_grammar('root ::= "\\u00e9"'))
    eng.run([req])
    assert req.output == [pt_.eos_id]


def test_json_schema_output_is_json_prefix():
    """A json_schema request's output is a prefix the grammar accepts, and
    a complete one parses as JSON with the required keys."""
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    pt_ = _toks()[1]
    eng = Engine(cfg, model, n_slots=1, max_len=256)
    req = Request(prompt=pt_.encode("{"), max_new_tokens=48,
                  sampler=SamplerParams(temperature=0.0),
                  stop_tokens=(pt_.eos_id,),
                  grammar=pt_.make_grammar(pg.json_schema_to_gbnf(SCHEMA)))
    eng.run([req])
    text = "".join(pt_.pieces()[t] for t in req.output if t != pt_.eos_id)
    g = pg.Grammar.from_gbnf(pg.json_schema_to_gbnf(SCHEMA))
    assert pg.GrammarState(g).accepts_text_prefix(text)
    if req.output[-1] == pt_.eos_id:
        assert {"a", "b"} <= set(json.loads(text))
