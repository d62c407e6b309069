"""The port stands alone: no module of vlut_tpu_torch, and not chip_smoke.py,
imports JAX or the JAX package (nor optax, safetensors or transformers,
which the card's machine lacks); entry points refuse to run without a GPU
unless the CPU is asked for; chip_smoke.py fails without a GPU or without
the repository beside it."""

import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import vlut_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY_REAL = ROOT / "tests" / "fixtures" / "tiny_real"

_IMPORT_ALL = """
import importlib, pkgutil, runpy, sys
import vlut_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vlut_tpu_torch.__path__,
                                                "vlut_tpu_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "vlut_tpu", "optax",
                                    "safetensors", "transformers"))
missing = {"vlut_tpu_torch.models.audio", "vlut_tpu_torch.models.vocoder",
           "vlut_tpu_torch.runtime.tts",
           "vlut_tpu_torch.bench.audio_zoo"} - set(names)
print(len(names), "modules;", "imported:", bad, "not walked:", missing)
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""


def test_no_jax_imports():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_load_checkpoint_needs_gpu_or_cpu_asked(no_cuda):
    from vlut_tpu_torch.convert.checkpoint import load_checkpoint

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint(TINY_REAL)
    cfg, model, _ = load_checkpoint(TINY_REAL, device="cpu")
    assert model.device.type == "cpu"


@pytest.mark.parametrize("argv", [
    ["batched", "--model", "{m}", "-p", "a", "-np", "1", "-n", "1"],
    ["generate", "--model", "{m}", "-p", "a", "-n", "1"],
    ["serve", "--model", "{m}", "--port", "0"],
    ["bench", "-m", "falcon_1b", "-ns", "1", "--fmt", "tq1"],
    ["bench-sweep", "-m", "{m}", "-p", "4", "-n", "1"],
    ["batched-bench", "-m", "{m}", "-npp", "4", "-ntg", "1", "-npl", "1"],
    ["ppl", "--model", "{m}", "-f", "{txt}", "--window", "64"],
    ["eval", "--model", "{m}", "--task", "mc", "-f", "{mc}"],
    ["describe", "--model", "{m}", "--audio", "{wav}", "--audio-encoder",
     "{enc}", "-p", "<audio>", "-n", "2"],
    ["tts", "--model", "{m}", "--vocoder", "{voc}", "-p", "hi", "-n", "2",
     "--code-offset", "0", "-o", "{out}"],
    ["convert-audio", "{hf_audio}", "{out_dir}", "--d-llm", "128"],
    ["convert-vocoder", "{hf_voc}", "{out_dir}"],
], ids=["batched", "generate", "serve", "bench", "bench-sweep",
        "batched-bench", "ppl", "eval", "describe-audio", "tts",
        "convert-audio", "convert-vocoder"])
def test_cli_needs_gpu_or_cpu_asked(no_cuda, argv, tmp_path, capsys):
    from vlut_tpu_torch import cli

    import dataclasses

    import numpy as np

    from vlut_tpu_torch.bench import audio_zoo
    from vlut_tpu_torch.models import vocoder
    from vlut_tpu_torch.runtime.tts import save_wav

    mc, txt = tmp_path / "mc.jsonl", tmp_path / "text.txt"
    mc.write_text('{"question": "a", "choices": ["b", "c"], "answer": 0}')
    txt.write_bytes((ROOT / "SURVEY.md").read_bytes()[:200])
    paths = dict(m=TINY_REAL, mc=mc, txt=txt, wav=tmp_path / "a.wav",
                 enc=tmp_path / "enc", voc=tmp_path / "voc",
                 out=tmp_path / "o.wav", hf_audio=tmp_path / "hf_audio",
                 hf_voc=tmp_path / "hf_voc", out_dir=tmp_path / "out")
    if argv[0] in ("describe", "tts", "convert-audio", "convert-vocoder"):
        acfg = dataclasses.replace(audio_zoo.TINY, d_llm=128)
        audio_zoo.write_ultravox_source(paths["hf_audio"], acfg, seed=1,
                                        proj_hidden=16)
        audio_zoo.write_wavtokenizer_source(paths["hf_voc"],
                                            audio_zoo.TINY_VOCODER, seed=1)
        cli.main(["convert-audio", str(paths["hf_audio"]), str(paths["enc"]),
                  "--d-llm", "128", "--device", "cpu"])
        voc = dataclasses.replace(audio_zoo.TINY_VOCODER, vocab_size=256)
        vocoder.save_vocoder(str(paths["voc"]), voc,
                             vocoder.init_params(voc, seed=1))
        save_wav(str(paths["wav"]), np.zeros(3200, np.float32), 1600)
    argv = [a.format(**paths) for a in argv]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv)
    if argv[0] in ("bench", "bench-sweep", "batched-bench", "ppl", "eval",
                   "describe", "tts", "convert-audio", "convert-vocoder"):
        cli.main(argv + ["--device", "cpu"])
        assert capsys.readouterr().out


def test_flagship_needs_gpu_or_cpu_asked(no_cuda):
    from vlut_tpu_torch.bench import flagship

    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship.run("tiny", n_layers=1)
    out = flagship.run("tiny", device="cpu", n_layers=1, reps=1, np_slots=2,
                       prompt_len=8, n_lo=1, n_hi=2)
    assert out["device"] == "cpu" and out["n_layers"] == 1


def test_init_params_fast_needs_gpu_or_cpu_asked(no_cuda):
    from vlut_tpu_torch.config import PRESETS
    from vlut_tpu_torch.models.transformer import init_params_fast

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params_fast(PRESETS["tiny"])
    assert init_params_fast(PRESETS["tiny"], device="cpu").device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: chip_smoke.py would run")
        cwd = ROOT
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_package_is_the_checkouts():
    assert pathlib.Path(vlut_tpu_torch.__file__).parents[1] == ROOT
