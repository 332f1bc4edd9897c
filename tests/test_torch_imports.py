"""The port stands alone: it imports no JAX and nothing of the JAX package,
and its entry points refuse to fall back to the CPU silently."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "dex_tts_tpu_torch")


def _modules():
    return ["dex_tts_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG_DIR], prefix="dex_tts_tpu_torch.")
    ]


def test_every_module_imports_without_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax',"
        " 'orbax', 'dex_tts_tpu')]\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert len(_modules()) > 15
    assert {"dex_tts_tpu_torch.main", "dex_tts_tpu_torch.ops.mas", "dex_tts_tpu_torch.ops.segment",
            "dex_tts_tpu_torch.train.trainer", "dex_tts_tpu_torch.train.checkpoint",
            "dex_tts_tpu_torch.data.dataset", "dex_tts_tpu_torch.bench",
            "dex_tts_tpu_torch.bench_train", "dex_tts_tpu_torch.eval",
            "dex_tts_tpu_torch.eval.evaluation", "dex_tts_tpu_torch.serving",
            "dex_tts_tpu_torch.synthesize", "dex_tts_tpu_torch.serve",
            "dex_tts_tpu_torch.train.preemption", "dex_tts_tpu_torch.train.vocoder",
            "dex_tts_tpu_torch.train_vocoder", "dex_tts_tpu_torch.eval.metric",
            "dex_tts_tpu_torch.data.vocoder_dataset",
            "dex_tts_tpu_torch.models.vocoder.discriminators", "dex_tts_tpu_torch.eval.speaker",
            "dex_tts_tpu_torch.preprocess", "dex_tts_tpu_torch.preprocess.preprocessor",
            "dex_tts_tpu_torch.preprocess.filelists", "dex_tts_tpu_torch.preprocess.text_frontend",
            "dex_tts_tpu_torch.preprocess.__main__", "dex_tts_tpu_torch.parallel",
            "dex_tts_tpu_torch.parallel.collectives", "dex_tts_tpu_torch.parallel.mesh",
            "dex_tts_tpu_torch.parallel.runtime", "dex_tts_tpu_torch.parallel.tp",
            "dex_tts_tpu_torch.dryrun", "dex_tts_tpu_torch.models.xpos",
            "dex_tts_tpu_torch.utils.mfu", "dex_tts_tpu_torch.utils.profiling",
            "dex_tts_tpu_torch.entry",
            "dex_tts_tpu_torch.utils.config", "dex_tts_tpu_torch.export"} <= set(_modules())


def test_source_names_no_jax_or_jax_package():
    pattern = re.compile(
        r"^\s*(import (jax|flax|optax|orbax)\b|from (jax|flax|optax|orbax)\b"
        r"|import dex_tts_tpu\b(?!_torch)|from dex_tts_tpu\b(?!_torch))",
        re.M,
    )
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "scripts", n) for n in ("ab_mas.py", "ab_snake.py", "profile_port.py")]
    for root, _, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path, encoding="utf-8") as f:
            hits = pattern.findall(f.read())
        assert not hits, (path, hits)


def test_entry_points_raise_without_cuda(monkeypatch):
    from dex_tts_tpu_torch import main as port_main
    from dex_tts_tpu_torch.config import build_model, build_vocoder, load_preset
    from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, HiFiGANConfig
    from dex_tts_tpu_torch.ops.kernels import load_library
    from dex_tts_tpu_torch.pipeline import Synthesizer
    from tests.torch_port_util import BIGVGAN_TINY, tiny_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for source in ("flash_attention.cu", "snake.cu", "mas.cu"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_library(source)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            load_library(source, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(tiny_cfg())
    for voc in (BigVGANConfig(**BIGVGAN_TINY), HiFiGANConfig()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_vocoder(voc)
    assert build_vocoder(BigVGANConfig(**BIGVGAN_TINY), device="cpu").conv_pre.weight.is_cpu
    model = build_model(tiny_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(model)
    assert Synthesizer(model, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.train(load_preset("esd"), "unused")  # the train entry point


def test_load_and_serve_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The loader, `python -m dex_tts_tpu_torch.synthesize` and
    `python -m dex_tts_tpu_torch.serve` default to CUDA and raise without
    it, before looking for any checkpoint."""
    from dex_tts_tpu_torch import serve, synthesize
    from dex_tts_tpu_torch.config import PRESETS, Preset
    from dex_tts_tpu_torch.eval import load_synthesizer, load_vocoder
    from tests.torch_port_util import tiny_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    preset = Preset(model=tiny_cfg(), vocoder_path=str(tmp_path))
    monkeypatch.setitem(PRESETS, "tiny_no_cuda", lambda: preset)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_synthesizer(preset, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_vocoder(preset)
    argv = ["--preset", "tiny_no_cuda", "--weight_path", str(tmp_path), "--random_init"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthesize.main(argv + ["--input_text", "Hi.", "--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_server(serve.parse_args(argv + ["--port", "0"]))


def test_vocoder_trainer_raises_without_cuda(monkeypatch, tmp_path):
    """`python -m dex_tts_tpu_torch.train_vocoder` and the state it builds
    default to CUDA and raise without it, before any step."""
    from chip_smoke import write_reference_wavs
    from dex_tts_tpu_torch import train_vocoder
    from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig
    from dex_tts_tpu_torch.train.vocoder import create_vocoder_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_reference_wavs(str(tmp_path), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_vocoder_train_state(HiFiGANConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vocoder.main(["--data", str(tmp_path), "--steps", "1",
                            "--ckpt_dir", str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()


def test_eval_and_preprocess_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """`python -m dex_tts_tpu_torch.main test`, `python -m
    dex_tts_tpu_torch.preprocess` and the scorers they build default to
    CUDA and raise without it, before reading a filelist or writing a
    file."""
    from chip_smoke import write_vctk_corpus
    from dex_tts_tpu_torch import main as port_main
    from dex_tts_tpu_torch.eval import ASRScorer, SpeakerScorer, run_objective_eval
    from dex_tts_tpu_torch.eval.speaker import BuiltinVoiceEncoder
    from dex_tts_tpu_torch.preprocess import PreprocessConfig, Preprocessor
    from dex_tts_tpu_torch.preprocess import __main__ as preprocess_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(["test", "--preset", "vctk", "--test_checkpoint", str(tmp_path / "exp"),
                        "--val_path", str(tmp_path / "missing.txt")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_objective_eval(None, str(tmp_path / "exp"))
    write_vctk_corpus(str(tmp_path / "corpus"), n_speakers=1, n_utts=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess_cli.main(["--dataset", "VCTK", "--corpus_path", str(tmp_path / "corpus"),
                             "--raw_path", str(tmp_path / "raw"),
                             "--out_path", str(tmp_path / "pre")])
    assert sorted(os.listdir(tmp_path)) == ["corpus"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Preprocessor(PreprocessConfig())
    for make in (ASRScorer, BuiltinVoiceEncoder, lambda: SpeakerScorer(backend="random-init")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_data_parallel_entry_points_raise_without_cuda_or_cards(monkeypatch, tmp_path):
    """``--n_devices 2`` of `main train` and `train_vocoder`, and a rank
    that torchrun started, raise without CUDA unless ``--device cpu`` is
    given, and asking for more cards than there are raises, naming both
    counts; nothing is started. The dry run starts nothing without
    ``--device cpu``, with or without a card."""
    from chip_smoke import write_reference_wavs
    from dex_tts_tpu_torch import dryrun, parallel, train_vocoder
    from dex_tts_tpu_torch import main as port_main

    def no_launch(*args, **kwargs):
        raise AssertionError("no rank may start")

    monkeypatch.setattr(parallel, "launch", no_launch)
    write_reference_wavs(str(tmp_path), 1)
    voc = ["--data", str(tmp_path), "--steps", "1", "--ckpt_dir", str(tmp_path / "ckpt"),
           "--n_devices", "2"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(["train", "--exp_dir", str(tmp_path / "exp"), "--n_devices", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vocoder.main(voc)
    with pytest.raises(SystemExit):
        dryrun.main(["2"])
    monkeypatch.setenv("WORLD_SIZE", "2")  # as torchrun sets it
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.initialize()
    monkeypatch.delenv("WORLD_SIZE")
    assert port_main.data_parallel_size(32, 2, "cpu") == 2
    assert port_main.data_parallel_size(30, 4, "cpu") == 3  # lowered until it divides
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"--n_devices 2 .*device_count\(\) is 1"):
        port_main.main(["train", "--exp_dir", str(tmp_path / "exp"), "--n_devices", "2"])
    with pytest.raises(ValueError, match=r"--n_devices 2 .*device_count\(\) is 1"):
        train_vocoder.main(voc)
    assert port_main.data_parallel_size(32, None) == 1
    with pytest.raises(SystemExit):
        dryrun.main(["2", "--device", "cuda"])
    assert not (tmp_path / "exp").exists() and not (tmp_path / "ckpt").exists()
