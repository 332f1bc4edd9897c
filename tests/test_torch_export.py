"""The port's export (dex_tts_tpu_torch/export.py and its CLI) against the
JAX package's exporter (dex_tts_tpu/export.py) and loaders."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.convert import (  # noqa: E402
    load_torch_trainer_checkpoint as jax_trainer_checkpoint,
)
from dex_tts_tpu.export import bigvgan_flax_to_torch as jax_bigvgan_export  # noqa: E402
from dex_tts_tpu.export import hifigan_flax_to_torch as jax_hifigan_export  # noqa: E402
from dex_tts_tpu.export import split_weight_norm as jax_split_weight_norm  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANConfig as JaxBigVGANConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANGenerator as JaxBigVGAN  # noqa: E402
from dex_tts_tpu.models.vocoder import HiFiGANConfig as JaxHiFiGANConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import HiFiGANGenerator as JaxHiFiGAN  # noqa: E402
from dex_tts_tpu_torch import export  # noqa: E402
from dex_tts_tpu_torch.config import build_model, preset_from_config  # noqa: E402
from dex_tts_tpu_torch.convert import (  # noqa: E402
    bigvgan_flax_to_torch,
    fold_weight_norm,
    hifigan_flax_to_torch,
    load_numpy_state,
)
from dex_tts_tpu_torch.eval.evaluation import load_vocoder  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import (  # noqa: E402
    BigVGANConfig,
    BigVGANGenerator,
    HiFiGANConfig,
    HiFiGANGenerator,
)
from dex_tts_tpu_torch.train import create_train_state  # noqa: E402
from dex_tts_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from dex_tts_tpu_torch.utils.config import Config, load_config  # noqa: E402
from tests.test_e2e_train import make_corpus, tiny_cfg  # noqa: E402
from tests.torch_port_util import BIGVGAN_TINY, perturb  # noqa: E402

HIFIGAN_TINY = dict(num_mels=12, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                    upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                    resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
VOCODERS = {  # name → (JAX config and module, port config and module, converters, kind)
    "hifigan": (JaxHiFiGANConfig(**HIFIGAN_TINY), JaxHiFiGAN, HiFiGANConfig(**HIFIGAN_TINY),
                HiFiGANGenerator, hifigan_flax_to_torch, jax_hifigan_export, "hifigan"),
    "bigvgan_resblock1": (JaxBigVGANConfig(**BIGVGAN_TINY), JaxBigVGAN,
                          BigVGANConfig(**BIGVGAN_TINY), BigVGANGenerator,
                          bigvgan_flax_to_torch, jax_bigvgan_export, "bigvgan"),
    "bigvgan_resblock2": (JaxBigVGANConfig(**BIGVGAN_TINY, resblock="2"), JaxBigVGAN,
                          BigVGANConfig(**BIGVGAN_TINY, resblock="2"), BigVGANGenerator,
                          bigvgan_flax_to_torch, jax_bigvgan_export, "bigvgan"),
}


def vocoder_pair(name, seed=0):
    """(JAX params as numpy, every one perturbed; the port generator on the
    CPU carrying them through the port's converter)."""
    jcfg, jcls, pcfg, pcls, convert, _, _ = VOCODERS[name]
    params = jcls(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, jcfg.num_mels, 8)))
    params = perturb(jax.tree_util.tree_map(np.asarray, dict(params)), seed)["params"]
    port = pcls(pcfg).eval()
    load_numpy_state(port, convert(params, pcfg))
    return params, port


@pytest.mark.parametrize("name", VOCODERS)
def test_vocoder_reference_state_equals_the_jax_export(name):
    """The weight-normed reference state of a generator carried over from
    JAX params equals JAX's `hifigan_flax_to_torch`/`bigvgan_flax_to_torch`
    of the same params bit for bit: the same keys (no ``.filter``
    buffers, ``ups.{i}.0``, the snakes at ``activations.{j}.act``), dtypes
    and values."""
    params, port = vocoder_pair(name)
    jcfg, jax_export = VOCODERS[name][0], VOCODERS[name][5]
    want = jax_export(params, jcfg)
    got = export.vocoder_reference_state(port)
    assert sorted(got) == sorted(want)
    assert any(k.endswith(".weight_g") for k in got) and not any(k.endswith(".weight") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_split_weight_norm_equals_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    state = {"a.weight": rng.standard_normal((4, 3, 5)).astype(np.float32),
             "b.weight": rng.standard_normal((6, 2, 3, 3)).astype(np.float32) * 1e-3,
             "c.weight": rng.standard_normal((5, 7)).astype(np.float32),
             "norm.weight": rng.standard_normal(4).astype(np.float32),
             "a.bias": rng.standard_normal(4).astype(np.float32),
             "act.alpha": rng.standard_normal(4).astype(np.float32)}
    want = jax_split_weight_norm(state)
    got = export.split_weight_norm({k: torch.from_numpy(v) for k, v in state.items()})
    assert sorted(got) == sorted(want)
    assert {"a.weight_g", "a.weight_v", "c.weight_g", "norm.weight"} <= set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fold_inverts_split():
    rng = np.random.default_rng(2)
    state = {"a.weight": rng.standard_normal((4, 3, 5)).astype(np.float32),
             "a.bias": rng.standard_normal(4).astype(np.float32),
             "act.alpha": rng.standard_normal(4).astype(np.float32)}
    split = export.split_weight_norm(state)
    assert set(split) == {"a.weight_g", "a.weight_v", "a.bias", "act.alpha"}
    folded = fold_weight_norm(split)
    np.testing.assert_allclose(folded["a.weight"], state["a.weight"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(folded["a.bias"], state["a.bias"])
    np.testing.assert_array_equal(folded["act.alpha"], state["act.alpha"])


def vocoder_config(tmp_path, name: str, vocoder_path: str, arch_dir: str) -> str:
    """dex_tts_tpu/config/presets/vctk.yaml with the vocoder ``kind`` at
    ``vocoder_path``, its tiny architecture in a config.json in ``arch_dir``."""
    pcfg, kind = VOCODERS[name][2], VOCODERS[name][6]
    arch = {k: getattr(pcfg, k) for k in HIFIGAN_TINY}
    with open(os.path.join(arch_dir, "config.json"), "w") as f:
        json.dump(arch, f)
    path = str(tmp_path / f"{os.path.basename(arch_dir)}.yaml")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    load_config(os.path.join(root, "dex_tts_tpu", "config", "presets", "vctk.yaml"),
                {"vocoder": kind, "path": {"vocoder_path": vocoder_path}}).dump(path)
    return path


@pytest.mark.parametrize("name", ["hifigan", "bigvgan_resblock1"])
def test_export_cli_vocoder_file_loads_back(tmp_path, name):
    """`python -m dex_tts_tpu_torch.export --config Y --vocoder` on the
    vocoder trainer's ``gen_last.pth`` writes ``{'generator': ...}`` that
    the port's `load_vocoder` reads back (as ``g_05000000``/``generator``
    beside the same config.json) with the same CPU output within 1e-6 ×
    max|y|."""
    params, port = vocoder_pair(name, seed=1)
    trained = tmp_path / "trained"
    trained.mkdir()
    torch.save(port.state_dict(), trained / "gen_last.pth")  # the trainer's handoff
    out_dir = tmp_path / "exported"
    out_dir.mkdir()
    out_name = "g_05000000" if VOCODERS[name][6] == "bigvgan" else "generator_universal.pth.tar"
    out = export.main(["--config", vocoder_config(tmp_path, name, str(trained), str(trained)),
                       "--vocoder", "--out", str(out_dir / out_name)])
    saved = torch.load(out, map_location="cpu", weights_only=True)
    assert list(saved) == ["generator"]
    assert sorted(saved["generator"]) == sorted(export.vocoder_reference_state(port))
    mel = torch.randn(2, 12, 9, generator=torch.Generator().manual_seed(3))
    loaded = {}
    for where in (trained, out_dir):
        preset = preset_from_config(Config(vocoder_config(tmp_path, name, str(where),
                                                          str(where))))
        loaded[where] = load_vocoder(preset, device="cpu")
    assert type(loaded[out_dir]) is type(port)
    with torch.no_grad():
        want, got = loaded[trained](mel), loaded[out_dir](mel)
    assert torch.equal(want, port(mel))
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_export_cli_vocoder_without_a_checkpoint_raises(tmp_path):
    path = vocoder_config(tmp_path, "hifigan", str(tmp_path / "nothing"), str(tmp_path))
    with pytest.raises(FileNotFoundError):
        export.main(["--config", path, "--vocoder", "--out", str(tmp_path / "g.pth")])
    assert not (tmp_path / "g.pth").exists()


def test_export_cli_tts_file_reads_in_the_jax_loader(tmp_path):
    """Without ``--vocoder``: the port's ``<exp>/ckpt/<tag>.pth`` becomes
    ``<exp>/export/model-export.pth`` holding ``state_dict`` and ``ema``
    alone, which JAX's `load_torch_trainer_checkpoint` reads with tensors
    equal to the checkpoint's."""
    cfg = tiny_cfg(make_corpus(str(tmp_path)), "dex")
    path = str(tmp_path / "cfg.yaml")
    cfg.dump(path)
    torch.manual_seed(0)
    model = build_model(preset_from_config(Config(path)).model, device="cpu")
    state = create_train_state(model)
    with torch.no_grad():
        for name, value in state.ema.items():  # an EMA apart from the weights
            value.add_(0.01 * torch.randn_like(value))
    exp = tmp_path / "exp"
    CheckpointManager(str(exp / "ckpt")).save(state, "last")
    out = export.main(["--config", path, "--weight_path", str(exp), "--tag", "last"])
    assert out == str(exp / "export" / "model-export.pth")
    assert set(torch.load(out, map_location="cpu", weights_only=True)) == {"state_dict", "ema"}
    ckpt = torch.load(exp / "ckpt" / "last.pth", map_location="cpu", weights_only=True)
    sd, ema = jax_trainer_checkpoint(out)
    assert sorted(sd) == sorted(ckpt["state_dict"]) and sorted(ema) == sorted(ckpt["ema"])
    for got, want in ((sd, ckpt["state_dict"]), (ema, ckpt["ema"])):
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    assert any(not np.array_equal(sd[k], ema[k]) for k in sd)
    shutil.rmtree(exp / "export")
    with pytest.raises(FileNotFoundError):  # no such tag
        export.main(["--config", path, "--weight_path", str(exp)])
