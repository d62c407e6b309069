"""Chat-output parsing of the server's ``/v1/chat/completions`` (port of
``_parse_tool_calls`` and ``_split_reasoning`` in
vlut_tpu/serving/server.py): tool calls in the wire formats of the
reference's per-template parsers, and a leading reasoning block.  Plain
string work on the host; the answers equal the JAX package's.
"""

from __future__ import annotations

import json
import re


def _parse_tool_calls(text: str):
    """Multi-format tool-call extraction (reference: common/chat.cpp's
    per-template parser suite).  Formats, tried in order:

    1. Hermes/Qwen  — <tool_call>{...}</tool_call> blocks (parallel calls)
    2. functionary  — <function=NAME>{json args}</function>
    3. Mistral      — [TOOL_CALLS] [{...}, {...}] JSON array
    4. fenced JSON  — ```json\n{...}\n``` with a name+arguments shape
    5. bare JSON    — whole message is one {"name", "arguments"} object
       (Llama-3.x "parameters" spelling accepted)
    6. Llama-3.x builtin — <|python_tag|>code... becomes an ipython
       call {"code": ...} (chat.cpp llama-3.x builtin-tools path)
    7. DeepSeek V3/R1 — <tool_call_begin>function<tool_sep>NAME
       ```json args``` <tool_call_end> blocks (the fullwidth-bar
       markers; chat.cpp COMMON_CHAT_FORMAT_DEEPSEEK_*)
    8. Command-R7B  — <|START_ACTION|>[{"tool_name","parameters"}, ...]
       <|END_ACTION|> (chat.cpp COMMON_CHAT_FORMAT_COMMAND_R7B)
    9. Granite      — <|tool_call|>[{...}] array prefix

    Checked before the generic forms (several reuse
    the <tool_call> envelope):

    10. GLM 4.5       — <tool_call>NAME <arg_key>/<arg_value> XML pairs
    11. Qwen3-coder   — <tool_call><function=NAME><parameter=K>raw-or-
        JSON values (COMMON_CHAT_FORMAT_QWEN3_CODER_XML)
    12. Seed-OSS      — <seed:tool_call><function=NAME><parameter=K>
    13. MiniMax-M2    — <minimax:tool_call><invoke name="..">
        <parameter name="..">
    14. Kimi-K2       — <|tool_calls_section_begin|> blocks with
        functions.NAME:idx ids + JSON args
    15. Nemotron-v2   — <TOOLCALL>[{name,arguments}...]</TOOLCALL>
    16. Apriel-1.5    — <tool_calls>[{...}]</tool_calls>
    17. LFM2          — <|tool_call_start|>[{...}]<|tool_call_end|>
    18. Apertus       — <|tools_prefix|>[{NAME: args}, ...]<|tools_suffix|>
    19. GPT-OSS       — harmony channels: "to=functions.NAME ...
        <|message|>{args}<|call|>"; final channel is the content
        (chat-parser.cpp common_chat_parse_gpt_oss)
    """
    calls = []

    def _shaped(obj):
        return isinstance(obj, dict) and "name" in obj and (
            "arguments" in obj or "parameters" in obj
        )

    def _val(s):
        """XML arg value: JSON when it parses, raw string otherwise
        (reference chat-parser-xml-toolcall.cpp value handling)."""
        s = s.strip()
        try:
            return json.loads(s)
        except json.JSONDecodeError:
            return s

    # --- GLM 4.5: <tool_call>NAME <arg_key>K</arg_key><arg_value>V
    # </arg_value>...</tool_call> (chat.cpp init_glm_4_5 — must be checked
    # before Hermes, both use <tool_call>)
    if "<arg_key>" in text:
        for m in re.finditer(r"<tool_call>\s*([\w./:-]+)\s*(.*?)</tool_call>",
                             text, re.DOTALL):
            args = {
                k: _val(v) for k, v in re.findall(
                    r"<arg_key>(.*?)</arg_key>\s*<arg_value>(.*?)"
                    r"</arg_value>", m.group(2), re.DOTALL)
            }
            calls.append({"name": m.group(1), "arguments": args})
        if calls:
            rest = re.sub(r"<tool_call>.*?</tool_call>", "", text,
                          flags=re.DOTALL).strip()
            return calls, rest

    # --- Qwen3-coder XML: <tool_call><function=NAME><parameter=K>V
    # </parameter>...</function></tool_call> (chat.cpp
    # init_qwen3_coder_xml; values raw-or-JSON)
    if "<function=" in text and "<tool_call>" in text:
        for m in re.finditer(
            r"<tool_call>\s*<function=([\w.-]+)>\s*(.*?)</function>\s*"
            r"</tool_call>", text, re.DOTALL,
        ):
            args = {
                k: _val(v) for k, v in re.findall(
                    r"<parameter=([\w.-]+)>\s*(.*?)\s*</parameter>",
                    m.group(2), re.DOTALL)
            }
            calls.append({"name": m.group(1), "arguments": args})
        if calls:
            rest = re.sub(r"<tool_call>.*?</tool_call>", "", text,
                          flags=re.DOTALL).strip()
            return calls, rest

    # --- Seed-OSS: <seed:tool_call><function=NAME><parameter=K>V
    # </parameter>...</function></seed:tool_call> (chat.cpp init_seed_oss)
    if "<seed:tool_call>" in text:
        for m in re.finditer(
            r"<seed:tool_call>\s*<function=([\w.-]+)>\s*(.*?)"
            r"</function>\s*</seed:tool_call>", text, re.DOTALL,
        ):
            args = {
                k: _val(v) for k, v in re.findall(
                    r"<parameter=([\w.-]+)>\s*(.*?)\s*</parameter>",
                    m.group(2), re.DOTALL)
            }
            calls.append({"name": m.group(1), "arguments": args})
        if calls:
            rest = re.sub(r"<seed:tool_call>.*?</seed:tool_call>", "",
                          text, flags=re.DOTALL).strip()
            return calls, rest

    # --- MiniMax-M2: <minimax:tool_call><invoke name="NAME">
    # <parameter name="K">V</parameter>...</invoke></minimax:tool_call>
    if "<minimax:tool_call>" in text:
        for m in re.finditer(r'<invoke name="([^"]+)">\s*(.*?)</invoke>',
                             text, re.DOTALL):
            args = {
                k: _val(v) for k, v in re.findall(
                    r'<parameter name="([^"]+)">(.*?)</parameter>',
                    m.group(2), re.DOTALL)
            }
            calls.append({"name": m.group(1), "arguments": args})
        if calls:
            rest = re.sub(r"<minimax:tool_call>.*?</minimax:tool_call>",
                          "", text, flags=re.DOTALL).strip()
            return calls, rest

    # --- Kimi-K2: <|tool_calls_section_begin|><|tool_call_begin|>
    # functions.NAME:idx<|tool_call_argument_begin|>{json}
    # <|tool_call_end|>...<|tool_calls_section_end|>
    for m in re.finditer(
        r"<\|tool_call_begin\|>\s*([\w.:-]+)\s*"
        r"<\|tool_call_argument_begin\|>\s*(\{.*?\})\s*<\|tool_call_end\|>",
        text, re.DOTALL,
    ):
        name = m.group(1)
        name = re.sub(r"^functions\.", "", name)
        name = re.sub(r":\d+$", "", name)
        try:
            calls.append({"name": name, "arguments": json.loads(m.group(2))})
        except json.JSONDecodeError:
            continue
    if calls:
        rest = re.sub(
            r"<\|tool_calls_section_begin\|>.*?<\|tool_calls_section_end\|>",
            "", text, flags=re.DOTALL).strip()
        return calls, rest

    # --- shaped-JSON-array envelopes: nemotron-v2 <TOOLCALL>[...]
    # </TOOLCALL>, apriel-1.5 <tool_calls>[...]</tool_calls>, lfm2
    # <|tool_call_start|>[...]<|tool_call_end|>
    for pat in (r"<TOOLCALL>\s*(\[.*?\])\s*</TOOLCALL>",
                r"<tool_calls>\s*(\[.*?\])\s*</tool_calls>",
                r"<\|tool_call_start\|>\s*(\[.*?\])\s*<\|tool_call_end\|>"):
        m = re.search(pat, text, re.DOTALL)
        if not m:
            continue
        try:
            arr = json.loads(m.group(1))
        except json.JSONDecodeError:
            arr = None
        if isinstance(arr, list) and arr and all(_shaped(o) for o in arr):
            rest = (text[: m.start()] + text[m.end():]).strip()
            return arr, rest

    # --- Apertus: <|tools_prefix|>[{NAME: {args}}, ...]<|tools_suffix|>
    # (single-key objects keyed BY the function name, chat.cpp
    # init_apertus)
    m = re.search(r"<\|tools_prefix\|>\s*(\[.*?\])\s*<\|tools_suffix\|>",
                  text, re.DOTALL)
    if m:
        try:
            arr = json.loads(m.group(1))
        except json.JSONDecodeError:
            arr = None
        if isinstance(arr, list) and arr and all(
            isinstance(o, dict) and len(o) == 1 for o in arr
        ):
            calls = [
                {"name": k, "arguments": v}
                for o in arr for k, v in o.items()
            ]
            rest = (text[: m.start()] + text[m.end():]).strip()
            return calls, rest

    # --- GPT-OSS harmony: headers like "<|channel|>commentary
    # to=functions.NAME <|constrain|>json<|message|>{args}<|call|>";
    # "<|channel|>final ...<|message|>content" is the user-visible text
    # (chat-parser.cpp common_chat_parse_gpt_oss)
    if "<|channel|>" in text:
        for m in re.finditer(
            r"to=functions\.([\w.-]+)[^{}]*?<\|message\|>\s*(\{.*?\})\s*"
            r"(?=<\|call\|>|<\|end\|>|<\|channel\|>|$)",
            text, re.DOTALL,
        ):
            try:
                calls.append({"name": m.group(1),
                              "arguments": json.loads(m.group(2))})
            except json.JSONDecodeError:
                continue
        final = re.search(
            r"<\|channel\|>final[^<]*<\|message\|>(.*?)"
            r"(?:<\|end\|>|<\|return\|>|$)", text, re.DOTALL)
        if calls or final:
            return calls, (final.group(1).strip() if final else "")

    # --- DeepSeek V3.1: <tool_call_begin>NAME<tool_sep>{json}
    # <tool_call_end> — no 'function' prefix and no ```json fence
    # (chat-parser.cpp parse_deepseek_v3_1_content; R1's fenced form is
    # handled further down)
    for m in re.finditer(
        r"<｜tool▁call▁begin｜>([^\n<｜]+)<｜tool▁sep｜>\s*(\{.*?\})\s*"
        r"<｜tool▁call▁end｜>", text, re.DOTALL,
    ):
        try:
            calls.append({"name": m.group(1).strip(),
                          "arguments": json.loads(m.group(2))})
        except json.JSONDecodeError:
            continue
    if calls:
        rest = re.sub(r"<｜tool▁calls▁begin｜>.*?<｜tool▁calls▁end｜>", "",
                      text, flags=re.DOTALL)
        rest = re.sub(r"<｜tool▁call▁begin｜>.*?<｜tool▁call▁end｜>", "",
                      rest, flags=re.DOTALL).strip()
        return calls, rest

    # --- FireFunction v2: ' functools[{...}, ...]' JSON-array prefix
    m = re.search(r" ?functools\[", text)
    if m:
        try:
            arr = json.loads(text[m.end() - 1:])
        except json.JSONDecodeError:
            arr = None
        if isinstance(arr, list) and arr and all(_shaped(o) for o in arr):
            return arr, text[: m.start()].strip()

    # --- Functionary v3.2: 'name\n{json}' at message start and
    # '>>>name\n{json}' for subsequent calls; '>>>python\n<raw code>' is
    # a raw code-interpreter call; 'all\n' prefixes plain content
    # (chat-parser.cpp parse_functionary_v3_2).  Only committed when at
    # least one call parses — bare 'word\n' prose must fall through, and
    # a bare '>>>' (e.g. a Python REPL prompt in prose/code, which is
    # '>>> ' with a space) must not trigger the parse at all: require the
    # start-of-message 'name\n{' form or a '>>>name\n'-shaped segment
    if re.match(r"\w+\n\s*\{", text) or re.search(
        r">>>\w+\n", text
    ):
        rest_parts = []
        for si, seg in enumerate(re.split(r">>>", text)):
            m = re.match(r"(\w+)\n(.*)", seg, re.DOTALL)
            if not m:
                rest_parts.append(seg)
                continue
            nm, body = m.group(1), m.group(2)
            if nm == "all" and si == 0:
                rest_parts.append(body)
                continue
            if nm == "python" and si > 0:
                calls.append({"name": "python",
                              "arguments": {"code": body.rstrip()}})
                continue
            body_s = body.strip()
            if body_s.startswith("{"):
                try:
                    calls.append({"name": nm,
                                  "arguments": json.loads(body_s)})
                    continue
                except json.JSONDecodeError:
                    pass
            rest_parts.append(seg)
        if calls:
            return calls, "".join(rest_parts).strip()
        calls = []

    # 1. Hermes / Qwen
    for m in re.finditer(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", text,
                         re.DOTALL):
        try:
            calls.append(json.loads(m.group(1)))
        except json.JSONDecodeError:
            continue
    if calls:
        rest = re.sub(r"<tool_call>.*?</tool_call>", "", text,
                      flags=re.DOTALL).strip()
        return calls, rest

    # 2. functionary v3 style <function=NAME>{...}</function>
    for m in re.finditer(
        r"<function=([\w.-]+)>\s*(\{.*?\})\s*</function>", text, re.DOTALL
    ):
        try:
            calls.append(
                {"name": m.group(1), "arguments": json.loads(m.group(2))}
            )
        except json.JSONDecodeError:
            continue
    if calls:
        rest = re.sub(r"<function=[\w.-]+>.*?</function>", "", text,
                      flags=re.DOTALL).strip()
        return calls, rest

    # 3. Mistral [TOOL_CALLS] [...]
    m = re.search(r"\[TOOL_CALLS\]\s*(\[.*\])", text, re.DOTALL)
    if m:
        try:
            arr = json.loads(m.group(1))
            if isinstance(arr, list) and all(_shaped(o) for o in arr):
                rest = text[: m.start()].strip()
                return arr, rest
        except json.JSONDecodeError:
            pass

    # 4. fenced ```json blocks
    for m in re.finditer(r"```(?:json)?\s*(\{.*?\})\s*```", text, re.DOTALL):
        try:
            obj = json.loads(m.group(1))
            if _shaped(obj):
                calls.append(obj)
        except json.JSONDecodeError:
            continue
    if calls:
        rest = re.sub(r"```(?:json)?\s*\{.*?\}\s*```", "", text,
                      flags=re.DOTALL).strip()
        return calls, rest

    # 5. the whole message is one JSON call; also the GENERIC format's
    # {"tool_call": {...}} / {"tool_calls": [...]} / {"response": ...}
    # envelope (chat-parser.cpp parse_generic)
    stripped = text.strip()
    if stripped.startswith("{"):
        try:
            obj = json.loads(stripped)
        except json.JSONDecodeError:
            obj = None
        if _shaped(obj):
            return [obj], ""
        if isinstance(obj, dict):
            if _shaped(obj.get("tool_call")):
                return [obj["tool_call"]], ""
            tc = obj.get("tool_calls")
            if isinstance(tc, list) and tc and all(_shaped(o) for o in tc):
                return tc, ""
            if "response" in obj and len(obj) == 1:
                r = obj["response"]
                return [], r if isinstance(r, str) else json.dumps(r)

    # 6. Llama-3.x <|python_tag|> builtin tool (code interpreter)
    if stripped.startswith("<|python_tag|>"):
        code = stripped[len("<|python_tag|>"):]
        code = code.removesuffix("<|eom_id|>").strip()
        if code:
            return [{"name": "ipython", "arguments": {"code": code}}], ""

    # 7. DeepSeek V3/R1 tool-call blocks (fullwidth-bar special tokens)
    ds = re.finditer(
        r"<｜tool▁call▁begin｜>(?:function<｜tool▁sep｜>)?([\w.-]+)\s*"
        r"```(?:json)?\s*(\{.*?\})\s*```\s*<｜tool▁call▁end｜>",
        text, re.DOTALL,
    )
    for m in ds:
        try:
            calls.append(
                {"name": m.group(1), "arguments": json.loads(m.group(2))}
            )
        except json.JSONDecodeError:
            continue
    if calls:
        rest = re.sub(r"<｜tool▁calls▁begin｜>.*?<｜tool▁calls▁end｜>", "",
                      text, flags=re.DOTALL)
        rest = re.sub(r"<｜tool▁call▁begin｜>.*?<｜tool▁call▁end｜>", "",
                      rest, flags=re.DOTALL).strip()
        return calls, rest

    # 8. Command-R7B <|START_ACTION|>[...]<|END_ACTION|>
    m = re.search(r"<\|START_ACTION\|>\s*(\[.*?\])\s*<\|END_ACTION\|>",
                  text, re.DOTALL)
    if m:
        try:
            arr = json.loads(m.group(1))
        except json.JSONDecodeError:
            arr = None
        if isinstance(arr, list) and all(
            isinstance(o, dict) and "tool_name" in o for o in arr
        ):
            calls = [
                {"name": o["tool_name"],
                 "arguments": o.get("parameters", {})}
                for o in arr
            ]
            rest = (text[: m.start()] + text[m.end():])
            rest = re.sub(r"<\|(?:START|END)_(?:THINKING|RESPONSE)\|>", "",
                          rest).strip()
            return calls, rest

    # 9. Granite <|tool_call|>[{...}] prefix
    if stripped.startswith("<|tool_call|>"):
        try:
            arr = json.loads(stripped[len("<|tool_call|>"):])
            if isinstance(arr, list) and all(_shaped(o) for o in arr):
                return arr, ""
        except json.JSONDecodeError:
            pass
    return [], text


def _split_reasoning(text: str):
    """Leading thinking-block split (reference: server reasoning_content
    handling; chat.cpp try_parse_reasoning per format): <think> (R1/Qwen/
    GLM/Kimi/MiniMax/nemotron-v2), <thinking> (apriel), <seed:think>
    (seed-oss), <|inner_prefix|> (apertus), <|channel|>analysis harmony
    blocks (gpt-oss)."""
    for op, cl in (("<think>", "</think>"),
                   ("<thinking>", "</thinking>"),
                   ("<seed:think>", "</seed:think>"),
                   ("<|inner_prefix|>", "<|inner_suffix|>"),
                   ("[THINK]", "[/THINK]"),          # magistral
                   # solar-open pre-content reasoning channel
                   ("<|think|>", "<|end|><|begin|>assistant<|content|>")):
        m = re.match(
            rf"\s*{re.escape(op)}(.*?){re.escape(cl)}(.*)", text, re.DOTALL)
        if m:
            return m.group(1).strip(), m.group(2).strip()
    m = re.match(
        r"\s*<\|channel\|>analysis<\|message\|>(.*?)<\|end\|>(.*)",
        text, re.DOTALL)
    if m:
        return m.group(1).strip(), m.group(2).strip()
    return None, text
