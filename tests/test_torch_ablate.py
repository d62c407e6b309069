"""``forward``'s ablation switches (``bench/ablate.py``) on tiny_real: each
keeps the logits' shape and removes what it names (spies see no KV row
write, no decode attention, no head, no small-M kernel), the step of
``make_generate_fn`` runs under each, and no module but the tool passes
a switch."""

import pathlib
import re

import pytest
import torch

from vlut_tpu_torch.bench import ablate
from vlut_tpu_torch.convert.checkpoint import load_checkpoint
from vlut_tpu_torch.models import transformer as tt
from vlut_tpu_torch.ops import ternary_gemm as tg

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = dict(ablate.CONFIGS)


@pytest.fixture(scope="module")
def tiny():
    cfg, model, _ = load_checkpoint(ROOT / "tests" / "fixtures" / "tiny_real",
                                    device="cpu")
    return cfg, tt.unstack_layers(tt.fuse_projections(model, cfg), cfg)


def _spies(monkeypatch):
    calls = {}

    def spy(obj, name, key):
        fn = getattr(obj, name)
        calls[key] = 0

        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(obj, name, call)

    spy(tt, "write_rows_pair", "kv_write")
    spy(tt.dattn, "decode_attention", "decode_attention")
    spy(tt, "_attention", "attention")
    spy(tt, "head_logits", "head")
    for name in ("ternary_gemm_decode", "ternary_gemm_fused_quant",
                 "ternary_gemm_tiled"):
        spy(tg, name, name)
    return calls


def _prefill(cfg, model):
    torch.manual_seed(0)
    b = 3
    cache = tt.init_kv_cache(cfg, b, max_len=32)
    toks = torch.randint(0, cfg.vocab_size, (b, 6))
    tt.forward(model, cfg, toks, torch.arange(6)[None].repeat(b, 1), cache)
    return cache, toks[:, -1:]


def _decode(cfg, model, cache, last, decode_attn, switches):
    before = {k: [a.clone() for a in v] for k, v in cache.items()}
    logits, _ = tt.forward(model, cfg, last, torch.full(last.shape, 6),
                           cache, decode_attn=decode_attn, ablate=switches)
    written = any(not torch.equal(x, y) for k in cache
                  for x, y in zip(cache[k], before[k]))
    return logits, written


@pytest.mark.parametrize("decode_attn", ["composed", "fused"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_switch_removes_what_it_names(tiny, monkeypatch, name, decode_attn):
    """One decode step after a prefill: the switches' step against the
    full one, its calls counted by spies."""
    cfg, model = tiny
    want, _ = _decode(cfg, model, *_prefill(cfg, model), decode_attn,
                      frozenset())
    cache, last = _prefill(cfg, model)
    calls = _spies(monkeypatch)
    switches = CONFIGS[name]
    logits, written = _decode(cfg, model, cache, last, decode_attn, switches)
    assert logits.shape == want.shape and logits.dtype == want.dtype
    assert bool(torch.isfinite(logits).all())
    fused = decode_attn == "fused"
    attends = "no_attn" not in switches
    writes = attends if fused else "no_kv_write" not in switches
    assert written == writes
    n = cfg.n_layers
    assert calls["decode_attention"] == (n if fused and attends else 0)
    assert calls["kv_write"] == (n if writes and not fused else 0)
    assert calls["attention"] == (n if attends and not fused else 0)
    assert calls["head"] == ("no_head" not in switches)
    small = calls["ternary_gemm_decode"] + calls["ternary_gemm_fused_quant"]
    assert (small == 0) == ("unfused" in switches)
    assert (calls["ternary_gemm_tiled"] > 0) == ("unfused" in switches)
    if not switches or (fused and switches == {"no_kv_write"}):
        assert torch.equal(logits, want)


def test_unknown_switch_raises(tiny):
    cfg, model = tiny
    with pytest.raises(ValueError, match="unknown ablation"):
        tt.forward(model, cfg, torch.zeros((1, 1), dtype=torch.long),
                   torch.zeros((1, 1), dtype=torch.long),
                   ablate=frozenset({"no_ffn"}))


def test_fused_no_kv_write_alone_is_not_timed():
    assert not ablate.applicable(frozenset({"no_kv_write"}), "fused")
    assert all(ablate.applicable(s, "composed") for _, s in ablate.CONFIGS)


def test_run_on_cpu_gives_each_configuration(tiny, monkeypatch):
    """The tool's protocol on tiny_real (host clock: a check of the paths,
    not a measurement), fewer slots and steps."""
    monkeypatch.setattr(ablate, "NP_SLOTS", 2)
    monkeypatch.setattr(ablate, "PROMPT_LEN", 8)
    monkeypatch.setattr(ablate, "N_LO", 1)
    monkeypatch.setattr(ablate, "N_HI", 3)
    out = ablate.run(tiny, torch.device("cpu"), "fused", reps=1)
    assert list(out) == list(CONFIGS)
    assert out["no_kv_write"] is None
    assert all(isinstance(v, float) for k, v in out.items()
               if k != "no_kv_write")


def test_only_the_tool_passes_a_switch():
    """No module passes a switch (``ablate=`` other than an empty
    default or the pass-through of a caller's own ``ablate``) but the
    tool, and none reads one from the environment."""
    found = []
    for path in sorted((ROOT / "vlut_tpu_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        if path.name == "ablate.py" and path.parent.name == "bench":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            for m in re.finditer(r"\bablate=(frozenset\(\)|[^,)\s]+)", line):
                if m.group(1) not in ("ablate", "frozenset()"):
                    found.append(f"{path.relative_to(ROOT)}:{i}: {line}")
            if re.search(r"environ.*(ABLATE|FUSED_DECODE)", line):
                found.append(f"{path.relative_to(ROOT)}:{i}: {line}")
    assert found == []
