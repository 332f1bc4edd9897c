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
            "dex_tts_tpu_torch.bench_train"} <= set(_modules())


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
