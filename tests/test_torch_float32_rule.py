"""Every float32 entry of the port holds TF32 off itself
(``device.full_float32``), whatever the caller allows: each image tower
and projector, the recurrent families' forwards, the encoders, T5 and
gemma3n, the transformer's ``forward`` and the trainer's step.  Spies on
the float products and convolutions record the precision settings in
force at each call, with TF32 allowed for matmuls and cuDNN convolutions
around the entry; every call must see full float32, and the caller's
settings must come back after (the pattern of
``tests/test_torch_audio.py::test_audio_entries_hold_tf32_off``)."""

import contextlib
import json
import pathlib
import tempfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vlut_tpu_torch.bench import encoder_zoo as ez
from vlut_tpu_torch.bench import recurrent_zoo as rz
from vlut_tpu_torch.bench import vision_zoo as vz
from vlut_tpu_torch.device import tf32

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FULL = ("ieee", "ieee")


@contextlib.contextmanager
def tf32_allowed_and_spied(monkeypatch):
    """Within: TF32 allowed by the caller, and ``seen`` lists the (matmul,
    conv) precisions at each float product or convolution."""
    mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    seen: list = []

    def spy(fn):
        def call(*a, **kw):
            seen.append((mm.fp32_precision, conv.fp32_precision))
            return fn(*a, **kw)
        return call

    with monkeypatch.context() as mp:
        for name in ("conv1d", "conv2d", "linear"):
            mp.setattr(F, name, spy(getattr(F, name)))
        for name in ("matmul", "einsum", "bmm"):
            mp.setattr(torch, name, spy(getattr(torch, name)))
        mp.setattr(torch.Tensor, "__matmul__", spy(torch.Tensor.__matmul__))
        with tf32(matmul=True, conv=True):
            yield seen
            assert (mm.fp32_precision, conv.fp32_precision) == ("tf32",
                                                                "tf32")


def _replay(calls):
    for name, args, kw, _ in calls:
        getattr(vz.module_of(name), name)(*args, **kw)


# cogvlm's source has no tower of its own here: its visual pass is the
# language model's, and its tower is the twin cogvlm_tower
@pytest.mark.parametrize("name", [n for n in vz.SOURCES if n != "cogvlm"])
def test_vision_source_towers(monkeypatch, name):
    """Each tower and projector function a converted family's
    ``encode_image_auto`` runs, called again with the same arguments
    under TF32; then ``encode_image_auto`` itself."""
    from vlut_tpu_torch.convert.convert import convert_hf
    from vlut_tpu_torch.models.vision import encode_image_auto

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        d = pathlib.Path(d)
        convert_hf(vz.write_source(name, d / "hf", 0), d / "ckpt",
                   device="cpu")
        side = vz.image_side(json.loads(
            (d / "ckpt" / "vlut_config.json").read_text()))
        img = np.random.default_rng(0).random((side, side, 3)).astype(
            np.float32)
        calls: list = []
        with vz.recorded(calls), torch.inference_mode():
            encode_image_auto(d / "ckpt", img, device="cpu")
        assert calls
        with tf32_allowed_and_spied(monkeypatch) as seen, \
                torch.inference_mode():
            _replay(calls)
            encode_image_auto(d / "ckpt", img, device="cpu")
    assert seen and set(seen) == {FULL}


@pytest.mark.parametrize("name", vz.TWINS)
def test_vision_twin_towers(monkeypatch, name):
    """The towers and projectors with no converted source (LDP / LDPv2's
    and GLM-Edge's convolutions among them)."""
    calls = vz.twin_calls(name)
    with tf32_allowed_and_spied(monkeypatch) as seen, torch.inference_mode():
        _replay(calls)
    assert seen and set(seen) == {FULL}


@pytest.mark.parametrize("name", rz.FAMILIES)
def test_recurrent_forwards(monkeypatch, name):
    """Mamba, Mamba2, RWKV7 / 6, arwkv7 and the hybrids: a prefill and a
    step (``recurrent_zoo.logits_run``)."""
    cfg, tree = rz.family(name)
    model = rz.model_on(cfg, tree, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 12)))
    with tf32_allowed_and_spied(monkeypatch) as seen:
        rz.logits_run(model, cfg, toks, 1)
    assert seen and set(seen) == {FULL}


@pytest.mark.parametrize("name", [n for n in ez.FAMILIES
                                  if n not in ez.DIFFUSION])
def test_encoder_t5_gemma3n(monkeypatch, name):
    """The encoders' ``forward_encoder`` and ``embed``, T5's ``encode``,
    ``decode_logits`` and ``generate``, gemma3n's ``forward``."""
    cfg, tree = ez.family(name)
    model = ez.model_on(cfg, tree, "cpu")
    with tf32_allowed_and_spied(monkeypatch) as seen:
        ez._float_family(name, cfg, model, model, 0)
    assert seen and set(seen) == {FULL}


def test_transformer_forward_and_train_step(monkeypatch):
    """The transformer's float32 products (the composed attention, a
    float head, a float twin's dense projections) and a QAT step's
    forward and backward."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.train import finetune as ft

    cfg = PRESETS["tiny"]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    model = tt.init_params(cfg, seed=2)
    params = ft.trainable(ft.float_twin_params(tt.init_params(cfg, seed=2),
                                               cfg))
    opt = torch.optim.SGD(ft.leaves(params), lr=0.1)
    step = ft.make_train_step(cfg, opt, qat=True)
    with tf32_allowed_and_spied(monkeypatch) as seen:
        with torch.inference_mode():
            tt.forward(model, cfg, toks, torch.arange(16)[None].repeat(2, 1))
        n_forward = len(seen)
        assert torch.isfinite(step(params, toks))
    assert n_forward and len(seen) > n_forward and set(seen) == {FULL}


def test_server_rerank(monkeypatch):
    """The server's rerank: a forward, then the head in float32 outside
    it (``project_head`` over chunks of rows)."""
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models import transformer as tt
    from vlut_tpu_torch.runtime.engine import Engine
    from vlut_tpu_torch.serving.server import ServerState

    cfg = PRESETS["tiny"]
    state = ServerState(Engine(cfg, tt.init_params(cfg, seed=2), n_slots=1,
                               max_len=64), None)
    with tf32_allowed_and_spied(monkeypatch) as seen:
        scores = state.rerank([5, 6, 7], [[8, 9], [10, 11, 12]])
    assert len(scores) == 2
    assert seen and set(seen) == {FULL}
