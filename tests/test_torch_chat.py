"""The port's chat pieces and entry-point flags against the JAX package on
the CPU: the chat-output parsers (``serving/chat.py``) on the strings of
tests/test_server.py's parser tests, the ChatML ids of the tokenizer
without transformers against Hugging Face's, and ``generate --override``
/ ``--promote`` on tiny_real."""

import ast
import contextlib
import io
import pathlib

import pytest
import torch

from vlut_tpu import cli as jax_cli
from vlut_tpu.serving.server import _parse_tool_calls as jax_parse
from vlut_tpu.serving.server import _split_reasoning as jax_split
from vlut_tpu_torch import cli
from vlut_tpu_torch.serving.chat import _parse_tool_calls, _split_reasoning
from vlut_tpu_torch.utils.tokenizer import CharWordLevel, Tokenizer

torch.set_num_threads(1)

TESTS = pathlib.Path(__file__).parent
TINY_REAL = TESTS / "fixtures" / "tiny_real"


def _parser_strings(fn_name: str) -> list[str]:
    """Every string literal handed to ``fn_name`` in tests/test_server.py's
    ``test_parse_tool_calls_*`` tests."""
    tree = ast.parse((TESTS / "test_server.py").read_text())
    out = []
    for test in tree.body:
        if not (isinstance(test, ast.FunctionDef)
                and test.name.startswith("test_parse_tool_calls_")):
            continue
        for node in ast.walk(test):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == fn_name
                    and isinstance(node.args[0], ast.Constant)):
                out.append(node.args[0].value)
    return out


TOOL_TEXTS = _parser_strings("_parse_tool_calls")
# the loop of test_parse_tool_calls_formats_wave2 builds its strings from
# these markers
REASONING_TEXTS = _parser_strings("_split_reasoning") + [
    f"{op}why{cl}answer" for op, cl in (
        ("<think>", "</think>"), ("<thinking>", "</thinking>"),
        ("<seed:think>", "</seed:think>"),
        ("<|inner_prefix|>", "<|inner_suffix|>"))]


def test_parser_strings_found():
    assert (len(TOOL_TEXTS), len(REASONING_TEXTS)) == (37, 7)


@pytest.mark.parametrize("text", TOOL_TEXTS)
def test_parse_tool_calls_matches_jax(text):
    assert _parse_tool_calls(text) == jax_parse(text)


@pytest.mark.parametrize("text", REASONING_TEXTS + TOOL_TEXTS[:6])
def test_split_reasoning_matches_jax(text):
    assert _split_reasoning(text) == jax_split(text)


MESSAGES = [
    [{"role": "user", "content": "The little model"}],
    [{"role": "system", "content": "Be brief."},
     {"role": "user", "content": "Hi <0x01> there,\nand ü"},
     {"role": "assistant", "content": "ok"},
     {"role": "user", "content": ""}],
]
TOOLS = [{"type": "function", "function": {
    "name": "get_w", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}},
        "required": ["city"]}}}]


@pytest.mark.parametrize("tools", [None, TOOLS], ids=["plain", "tools"])
@pytest.mark.parametrize("gen_prompt", [True, False])
@pytest.mark.parametrize("messages", MESSAGES, ids=["one", "four"])
def test_chatml_ids_equal_hf(messages, gen_prompt, tools):
    """tiny_real has no chat template: the tokenizer without transformers
    renders ChatML itself and gives the ids of Hugging Face's jinja path
    (the port's Tokenizer over transformers, and the JAX package's)."""
    from vlut_tpu.utils.tokenizer import Tokenizer as JaxTokenizer

    hf = Tokenizer(TINY_REAL)
    assert not isinstance(hf.tk, CharWordLevel)
    plain = Tokenizer.__new__(Tokenizer)
    plain.tk = CharWordLevel(TINY_REAL)
    want = JaxTokenizer(TINY_REAL).apply_chat_template(
        messages, add_generation_prompt=gen_prompt, tools=tools)
    assert hf.apply_chat_template(messages, gen_prompt, tools=tools) == want
    assert plain.apply_chat_template(messages, gen_prompt, tools=tools) == want
    assert plain.fim_prefix_token_id is None


def _generate(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


GEN = ["generate", "--model", str(TINY_REAL), "-p", "The little model reads",
       "-n", "10", "--temp", "0", "--ctx", "128"]


def test_generate_override_matches_jax(monkeypatch):
    """``--override`` retypes the value from the config field; the greedy
    text equals the JAX package's ``generate --override`` (its projections
    through the Pallas kernels in interpret mode) and differs from the
    checkpoint's own."""
    monkeypatch.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
    flags = ["--override", "rope_theta=50", "--override", "rms_eps=0.01"]
    got = _generate(cli.main, GEN + flags + ["--device", "cpu"])
    assert got == _generate(jax_cli.main, GEN + flags)
    assert got != _generate(cli.main, GEN + ["--device", "cpu"])


def test_generate_override_of_unported_field_raises(monkeypatch):
    # causal_attn (ported since: such a checkpoint denoises) and cogvlm's
    # visual experts (ported since: a text request runs the language
    # weights, as the JAX CLI does) no longer raise; a field the config
    # lacks does
    monkeypatch.setenv("VLUT_TPU_MATMUL_IMPL", "pallas_interpret")
    flags = ["--override", "dual_expert=True"]
    assert (_generate(cli.main, GEN + flags + ["--device", "cpu"])
            == _generate(jax_cli.main, GEN + flags))
    with pytest.raises(SystemExit, match="no config field"):
        cli.main(GEN + ["--override", "nope=1", "--device", "cpu"])


def test_generate_promote_gives_the_checkpoints_tokens():
    """``--promote i1`` repacks tiny_real (i2) at load: the same trits, so
    the same greedy text; promoting to its own format changes nothing."""
    plain = _generate(cli.main, GEN + ["--device", "cpu"])
    for fmt in ("i1", "i2"):
        assert _generate(cli.main, GEN + ["--promote", fmt, "--device",
                                          "cpu"]) == plain
