"""The port's HF converter (``vlut_tpu_torch/convert/convert.py``) against
the JAX package's, on the JAX converter tests' own writers, HF1BitLLM's
packed layout, BF16 sources and the refusals; the CLI's ``convert`` and
the round trip of ``tests/fixtures/tiny_real`` through an HF directory.

Each case converts one HF directory with both converters (the port on the
CPU) and holds the two checkpoints equal array for array
(``_torch_convert.convert_both``).
"""

import dataclasses
import json
import logging
import pathlib
import struct

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

import test_convert  # noqa: E402
from _torch_convert import (  # noqa: E402
    convert_both,
    forward_case,
    hf_source,
    jax_source,
    port_arrays,
)

from vlut_tpu_torch import cli  # noqa: E402
from vlut_tpu_torch.bench import hf_writer  # noqa: E402
from vlut_tpu_torch.config import ModelConfig  # noqa: E402
from vlut_tpu_torch.convert import convert as pc  # noqa: E402
from vlut_tpu_torch.convert.checkpoint import (  # noqa: E402
    load_checkpoint,
    read_safetensors,
    safetensors_arrays,
)
from vlut_tpu_torch.models import dims  # noqa: E402
from vlut_tpu_torch.models import transformer as tt  # noqa: E402

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "tiny_real"

# test_convert.py's writers: name -> (the JAX test, the format)
CONVERT_WRITERS = {
    "exact_ternary": (test_convert.test_convert_exact_ternary, "i2"),
    "exact_ternary_i1": (test_convert.test_convert_exact_ternary, "i1"),
    "qwen2_biases": (test_convert.test_convert_qwen2_biases, "i2"),
    "qwen2_biases_i1": (test_convert.test_convert_qwen2_biases, "i1"),
    "mixtral": (test_convert.test_convert_mixtral_moe, "i2"),
    "gemma2_postnorms": (test_convert.test_convert_gemma2_postnorms, "i2"),
    "phi3_fused": (test_convert.test_convert_phi3_fused, "i2"),
    "qwen3_qk_norm": (test_convert.test_convert_qwen3_qk_norm, "i2"),
}


@pytest.mark.parametrize("name", list(CONVERT_WRITERS))
def test_convert_writers_equal_jax(name, tmp_path, monkeypatch):
    test_fn, fmt = CONVERT_WRITERS[name]
    src, _ = jax_source(test_fn, tmp_path, monkeypatch)
    out = convert_both(src, tmp_path, fmt=fmt)
    meta = json.loads((out / "vlut_config.json").read_text())
    assert meta["ternarized_tensors"] == 0
    assert meta["model_config"]["weight_fmt"] == fmt


@pytest.mark.parametrize("fmt", ["i2", "i1"])
def test_absmean_fallback_warns_like_jax(fmt, tmp_path, caplog):
    """A float source takes BitNet absmean in both converters: the same
    trits and scales, the same count in ``ternarized_tensors`` and the
    same warning."""
    hf = tmp_path / "hf"
    hf.mkdir()
    test_convert._make_hf_dir(hf, ternary=False, seed=1)
    with caplog.at_level(logging.WARNING):
        out = convert_both(hf, tmp_path, fmt=fmt)
    meta = json.loads((out / "vlut_config.json").read_text())
    assert meta["ternarized_tensors"] == 14  # 7 projections x 2 layers
    said = {(r.name, r.getMessage()) for r in caplog.records
            if "NOT exactly ternary" in r.getMessage()}
    assert {n for n, _ in said} == {"vlut_tpu.convert",
                                    "vlut_tpu_torch.convert"}
    assert len({m for _, m in said}) == 1


def _llama(layers: int = 2, d_ff: int = 512) -> ModelConfig:
    """A llama with no padding anywhere (head_dim 128, widths of whole
    pack chunks), so a written tree comes back bit for bit."""
    return ModelConfig(vocab_size=512, d_model=256, n_layers=layers,
                       n_heads=2, n_kv_heads=1, d_ff=d_ff, head_dim=128,
                       max_seq_len=256)


def _written_back(cfg, tree, dst: pathlib.Path, layout: str) -> None:
    """Every leaf of the converted checkpoint equals the tree written:
    packed bytes, embedding, norms and the head's logical columns (its
    padding zero); each scale the tree's, or under HF1BitLLM's layout
    ``np.float32(1) / weight_scale`` of the bf16 ``1 / scale`` written."""
    got = read_safetensors(dst / "model.safetensors")
    want = {}

    def flat(node, key=""):
        for k, v in node.items():
            if isinstance(v, dict):
                flat(v, f"{key}{k}.")
            else:
                want[key + k] = v

    flat(tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k.endswith(".scale") and layout == "hf1bitllm":
            ws = (1.0 / w).to(torch.bfloat16).to(torch.float32)
            w = torch.from_numpy(np.float32(1) / ws.numpy())
        if k == "lm_head":
            v = cfg.vocab_size
            assert not g[:, v:].any()
            g, w = g[:, :v], w[:, :v]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.view(torch.uint8) if g.dtype == torch.bfloat16
                           else g, w.view(torch.uint8)
                           if w.dtype == torch.bfloat16 else w), k


@pytest.mark.parametrize("layout", ["hf1bitllm", "float32"])
def test_written_tree_converts_back(layout, tmp_path):
    """``bench/hf_writer.py`` writes a port tree as HF's llama layout (in
    shards, so the shards' sorted order is taken); both converters give
    back the same checkpoint, which holds the tree."""
    cfg = _llama()
    tree = tt.init_params_fast(cfg, seed=5, device="cpu").tree()
    src = hf_writer.write_hf(tmp_path / "hf", cfg, tree, layout=layout,
                             shard_bytes=200_000)
    assert len(list(src.glob("*.safetensors"))) > 2
    out = convert_both(src, tmp_path)
    _written_back(cfg, tree, out, layout)
    got_cfg = load_checkpoint(out, device="cpu")[0]
    assert got_cfg == cfg


def _two_bit_case(tmp_path, scale: float, field3: bool):
    # up_proj (1024, 256): the exact-ternary test samples every 2nd row of
    # its (K, N) transpose, so column 3 of the HF tensor goes unsampled
    cfg = _llama(layers=1, d_ff=1024)
    tree = tt.init_params_fast(cfg, seed=6, device="cpu").tree()
    src = hf_writer.write_hf(tmp_path / "hf", cfg, tree, layout="hf1bitllm")
    arrays = safetensors_arrays(src / "model.safetensors")
    header = json.loads((src / "model.safetensors").read_bytes()[
        8:8 + struct.unpack("<Q", (src / "model.safetensors").read_bytes()[
            :8])[0]])
    key = "model.layers.0.mlp.up_proj.weight_scale"
    arrays[key] = (np.array([scale], np.float32).view(np.uint32)
                   >> 16).astype(np.uint16)
    if field3:  # a trit + 1 of 3 in a byte no sampled row reads
        w = arrays["model.layers.0.mlp.up_proj.weight"]
        w[5, 3] |= 3
    from vlut_tpu_torch.convert.checkpoint import write_safetensors

    write_safetensors(src / "model.safetensors", arrays, frozenset(
        k for k, v in header.items() if isinstance(v, dict)
        and v.get("dtype") == "BF16"))
    return src


@pytest.mark.parametrize("scale,field3", [
    (-20.0, False), (20.0, True), (0.0, False), (float("inf"), False)])
def test_two_bit_device_path_equals_the_float_path(scale, field3, tmp_path):
    """HF1BitLLM's uint8 trits come from integer work on the device where
    the float path gives the same ones: a negative ``weight_scale`` flips
    them, a field of 3 outside the sampled rows packs by sign as +1, and a
    zero or infinite divisor takes the float path; every case equals the
    JAX converter."""
    src = _two_bit_case(tmp_path, scale, field3)
    convert_both(src, tmp_path)
    w = safetensors_arrays(src / "model.safetensors")
    name = "model.layers.0.mlp.up_proj.weight"
    s = pc._float_of(w[name + "_scale"], "BF16")
    tb = pc._TwoBit(name, w[name], s)
    fast = tb.trits("cpu")
    wf = tb.host().T
    if not (np.isfinite(s).all() and s.all()):
        assert fast is None
        return
    exact, sc = pc._is_exact_ternary(wf)
    assert exact and fast[1] == np.float32(sc)
    np.testing.assert_array_equal(fast[0].numpy(),
                                  np.sign(wf).astype(np.int8))


def test_two_bit_sample_not_ternary_takes_absmean(tmp_path):
    """A field of 3 in a sampled row: the sample is not exactly ternary, so
    both converters take absmean on the float unpack."""
    src = _two_bit_case(tmp_path, 20.0, False)
    arrays = safetensors_arrays(src / "model.safetensors")
    arrays["model.layers.0.mlp.up_proj.weight"][:, 0] |= 3
    from vlut_tpu_torch.convert.checkpoint import write_safetensors

    bf16 = {k for k in arrays if k.endswith("_scale") or "embed" in k
            or k == "lm_head.weight"}
    write_safetensors(src / "model.safetensors", arrays, frozenset(bf16))
    out = convert_both(src, tmp_path)
    meta = json.loads((out / "vlut_config.json").read_text())
    assert meta["ternarized_tensors"] == 1


def _tiny_llama():
    import transformers

    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=96, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False))


@pytest.mark.parametrize("ternary", [True, False])
def test_bf16_source_equals_jax(ternary, tmp_path):
    """A model stored in BF16: the port reads it without ml_dtypes (the
    bits shifted up 16) and its conversion equals the JAX converter's,
    exact-ternary or through absmean."""
    src = hf_source(_tiny_llama, 11, tmp_path, ternarize=None if ternary
                    else (), dtype=torch.bfloat16)
    head = json.loads((src / "model.safetensors").read_bytes()[8:8 + int(
        np.frombuffer((src / "model.safetensors").read_bytes()[:8],
                      np.uint64)[0])])
    assert {v["dtype"] for k, v in head.items() if k != "__metadata__"} == {
        "BF16"}
    out = convert_both(src, tmp_path)
    meta = json.loads((out / "vlut_config.json").read_text())
    assert (meta["ternarized_tensors"] == 0) == ternary
    if ternary:
        forward_case(out)


def test_bf16_upcast_and_casts_round_like_jax():
    """The exact BF16 upcast equals ml_dtypes', and the float32 -> bf16
    cast rounds to nearest even as JAX's ``astype(bfloat16)`` does (ties,
    subnormals, infinities, the largest finite values)."""
    import jax.numpy as jnp
    import ml_dtypes

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 16, 1 << 16, dtype=np.uint16)
    bits = bits[~np.isnan(bits.view(ml_dtypes.bfloat16).astype(np.float32))]
    np.testing.assert_array_equal(
        pc._float_of(bits, "BF16"),
        bits.view(ml_dtypes.bfloat16).astype(np.float32))
    f = np.concatenate([
        rng.standard_normal(1 << 16).astype(np.float32),
        (rng.integers(0, 1 << 16, 4096).astype(np.uint32) << 16
         | 0x8000).view(np.float32),  # exact ties
        np.array([1e-40, -3e-39, np.inf, -np.inf, 3.4e38, 0.0, -0.0],
                 np.float32)])
    f = f[np.isfinite(f) | np.isinf(f)]
    got = pc._hp(f, "bfloat16").view(torch.int16).numpy().view(np.uint16)
    want = np.asarray(jnp.asarray(f).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_shard_names_sorted_whatever_the_header_order(tmp_path):
    """Within a shard the tensors come in sorted name order, as
    ``safe_open(...).keys()`` yields them, though the header lists ``z``
    before ``a``."""
    from safetensors import safe_open

    a = np.arange(4, dtype=np.float32)
    z = np.arange(3, dtype=np.float32) + 10
    head = {"z": {"dtype": "F32", "shape": [3], "data_offsets": [0, 12]},
            "a": {"dtype": "F32", "shape": [4], "data_offsets": [12, 28]}}
    raw = json.dumps(head).encode()
    raw += b" " * (-len(raw) % 8)
    (tmp_path / "m.safetensors").write_bytes(
        struct.pack("<Q", len(raw)) + raw + z.tobytes() + a.tobytes())
    got = list(pc._iter_hf_tensors(tmp_path))
    with safe_open(str(tmp_path / "m.safetensors"), "numpy") as sf:
        assert [n for n, _ in got] == list(sf.keys()) == ["a", "z"]
    np.testing.assert_array_equal(got[0][1], a)
    np.testing.assert_array_equal(got[1][1], z)


def test_dims_helpers_are_the_jax_packages():
    from vlut_tpu.models import dims as jd

    rng = np.random.default_rng(2)
    for hd, hd_p, h in ((32, 128, 4), (128, 128, 2), (100, 128, 3)):
        v = rng.standard_normal(h * hd).astype(np.float32)
        np.testing.assert_array_equal(dims.pad_vec_heads(v, h, hd, hd_p),
                                      jd.pad_vec_heads(v, h, hd, hd_p))
    for chunk, chunk_p, total in ((48, 128, 512), (128, 128, 256)):
        v = rng.standard_normal(total // chunk_p * chunk).astype(np.float32)
        np.testing.assert_array_equal(
            dims.scatter_vec(v, chunk, chunk_p, total),
            jd.scatter_vec(v, chunk, chunk_p, total))


# the checkpoints once refused under ROADMAP item 8: name -> (the JAX test
# that writes one, its converter's name, which call)
REFUSED = {
    "vision_lfm2_vl": ("test_vision_wave3", "test_lfm2_vl_parity",
                       "convert_hf", 0),
    "vision_pixtral": ("test_archs_wave5", "test_mistral3_text_parity",
                       "convert_hf", 0),
    "vision_qwen3vl": ("test_archs_wave4", "test_qwen3vl_moe_text_parity",
                       "convert_hf", 0),
    "cogvlm": ("test_archs_wave5", "test_cogvlm_dual_expert", "convert_hf",
               0),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_unported_families_are_refused(name, tmp_path, monkeypatch):
    """The vision towers (lfm2-vl's among them) and cogvlm's visual
    experts, refused until this slice, now convert: the text model, the
    tower's sidecar and the meta equal the JAX converter's array for
    array."""
    import importlib

    mod, test, converter, nth = REFUSED[name]
    test_fn = getattr(importlib.import_module(mod), test)
    src, kw = jax_source(test_fn, tmp_path, monkeypatch, nth, converter)
    out = convert_both(src, tmp_path, config=name != "vision_lfm2_vl", **kw)
    meta = json.loads((out / "vlut_config.json").read_text())
    if name == "cogvlm":
        assert "vis_wq.packed" in " ".join(port_arrays(out))
    else:
        assert {"lfm2vl_config", "pixtral_config",
                "qwen3vl_vision_config"} & set(meta)


def test_cli_convert_needs_the_card_or_cpu(tmp_path, monkeypatch):
    """``cli convert`` with no ``--device`` runs on the card, and without
    one raises, writing nothing; with ``--device cpu`` it converts, as
    ``python -m vlut_tpu_torch.convert.convert`` does."""
    src, _ = jax_source(test_convert.test_convert_qwen3_qk_norm, tmp_path,
                        monkeypatch)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["convert", str(src), str(tmp_path / "a")])
    assert not (tmp_path / "a").exists()
    cli.main(["convert", str(src), str(tmp_path / "a"), "--device", "cpu",
              "--fmt", "i1"])
    pc.main([str(src), str(tmp_path / "b"), "--device", "cpu", "--fmt",
             "i1"])
    a, b = port_arrays(tmp_path / "a"), port_arrays(tmp_path / "b")
    assert sorted(a) == sorted(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert json.loads((tmp_path / "a" / "vlut_config.json").read_text())[
        "model_config"]["weight_fmt"] == "i1"


def test_tiny_real_round_trip(tmp_path, capsys):
    """tiny_real (bitnet, sub-norms, per-tensor scales, head and sub-norm
    gains in the padded layout) written as an HF directory in the float32
    layout, converted by ``cli convert --device cpu``: every array equals
    the fixture's but the sub-norms' padded positions (the fixture's
    training left 0.99988 there; an HF directory carries no padding and
    the converter writes 0, which no forward reads), the config equals it
    field for field, and ``cli generate --temp 0`` gives the fixture's
    tokens."""
    cfg, model, _ = load_checkpoint(FIXTURE, device="cpu")
    src = hf_writer.write_hf(tmp_path / "hf", cfg, model.tree(),
                             tokenizer_src=FIXTURE)
    out = tmp_path / "out"
    cli.main(["convert", str(src), str(out), "--device", "cpu"])
    want = safetensors_arrays(FIXTURE / "model.safetensors")
    got = safetensors_arrays(out / "model.safetensors")
    assert sorted(got) == sorted(want)
    plan = dims.make_plan(cfg)
    logical = {
        "layers.attn_sub_norm": dims.chunk_positions(
            cfg.n_heads * plan.hd_p, plan.wo_chunk, plan.wo_chunk_p).reshape(
                cfg.n_heads, plan.hd_p)[:, dims.head_positions(
                    plan.hd, plan.hd_p)].reshape(-1),
        "layers.ffn_sub_norm": dims.chunk_positions(
            cfg.d_ff, plan.ff_chunk, plan.ff_chunk_p)}
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape)
        if k in logical:
            pad = np.ones(want[k].shape[-1], bool)
            pad[logical[k]] = False
            np.testing.assert_array_equal(got[k][:, ~pad], want[k][:, ~pad])
            assert not got[k][:, pad].any()
            assert (want[k][:, pad] != 0).all()
        else:
            assert got[k].tobytes() == want[k].tobytes(), k
    got_cfg = load_checkpoint(out, device="cpu")[0]
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    for f in ("tokenizer.json", "tokenizer_config.json",
              "special_tokens_map.json"):
        assert (out / f).read_bytes() == (FIXTURE / f).read_bytes()
    capsys.readouterr()
    texts = []
    for ckpt in (FIXTURE, out):
        cli.main(["generate", "--model", str(ckpt), "-p", "The little model",
                  "-n", "12", "--temp", "0", "--device", "cpu"])
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and texts[0].strip()
