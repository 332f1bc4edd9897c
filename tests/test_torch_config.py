"""The port's presets hold the JAX package's configurations field for
field, and the full-width parameter layout carries over strictly."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from __graft_entry__ import _full_size_dex, _full_size_gedex  # noqa: E402
from dex_tts_tpu.config import build_model as jax_build_model  # noqa: E402
from dex_tts_tpu.config import load_preset as jax_load_preset  # noqa: E402
from dex_tts_tpu.export import bigvgan_flax_to_torch as jax_bigvgan_export  # noqa: E402
from dex_tts_tpu.models.edm import SamplerConfig as JaxSamplerConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANConfig as JaxBigVGANConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANGenerator as JaxBigVGAN  # noqa: E402
from dex_tts_tpu_torch.config import TrainConfig, build_model, build_vocoder, load_preset  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig  # noqa: E402
from dex_tts_tpu_torch.convert import (  # noqa: E402
    bigvgan_flax_to_torch,
    dex_tts_flax_to_torch,
    load_numpy_state,
)
from dex_tts_tpu_torch.models.tts import TTSConfig  # noqa: E402
from dex_tts_tpu_torch.pipeline import Synthesizer  # noqa: E402


def assert_same_fields(port_cfg: TTSConfig, jax_model):
    for f in dataclasses.fields(TTSConfig):
        if not hasattr(jax_model, f.name):  # DeX's style fields, on a GeDEX
            assert not port_cfg.use_style and getattr(port_cfg, f.name) == f.default, f.name
            continue
        want = getattr(jax_model, f.name)
        got = getattr(port_cfg, f.name)
        if f.name == "dit":
            assert got.__dict__ == want.__dict__
        else:
            assert got == want, f.name


@pytest.mark.parametrize(
    "name,jax_factory",
    [("vctk", lambda: jax_build_model(jax_load_preset("vctk"))), ("vctk_bench", _full_size_dex),
     ("vctk_bench_bigvgan", _full_size_dex), ("gedex_bench", _full_size_gedex)]
    + [(name, lambda name=name: jax_build_model(jax_load_preset(name)))
       for name in ("libritts", "gedex_vctk", "gedex_ljspeech")],
)
def test_preset_equals_jax(name, jax_factory):
    assert_same_fields(load_preset(name).model, jax_factory())


def test_vctk_synthesis_settings_equal_yaml():
    cfg = jax_load_preset("vctk")
    preset = load_preset("vctk")
    assert preset.n_timesteps == cfg.test.n_timesteps
    assert preset.temperature == cfg.test.temperature
    defaults = {k: p.default for k, p in inspect.signature(Synthesizer).parameters.items()}
    assert defaults["add_blank"] == cfg.model.add_blank == preset.add_blank
    assert (defaults["x_quantum"], defaults["y_quantum"]) == (cfg.train.x_quantum,
                                                              cfg.train.y_quantum)
    assert cfg.vocoder == "hifigan"
    assert preset.cmu_path.endswith(cfg.path.cmu_path.removeprefix("resources"))


@pytest.mark.parametrize("name", ["vctk", "esd", "libritts", "gedex_vctk", "gedex_ljspeech"])
def test_preset_inference_and_train_fields_equal_yaml(name):
    """What the loader and the entry points read besides the model: the
    test block (``ema``, steps, temperature), the vocoder and its path,
    the filelists and the ``train:`` block (JAX main.py's defaults for
    keys the YAML leaves out)."""
    cfg = jax_load_preset(name)
    preset = load_preset(name)
    assert preset.ema == cfg.test.ema
    assert preset.vocoder_path == cfg.path.vocoder_path
    assert (preset.n_timesteps, preset.temperature) == (cfg.test.n_timesteps, cfg.test.temperature)
    assert preset.add_blank == cfg.model.add_blank
    assert cfg.vocoder == "hifigan" and preset.vocoder == HiFiGANConfig()
    assert (preset.sample_rate, preset.hop_length) == (cfg.preprocess.sample_rate,
                                                       cfg.preprocess.hop_length)
    # the mel parameters the vocoder trainer reads (train_vocoder.py:103-118)
    pre = cfg.preprocess
    assert (preset.n_fft, preset.win_length, preset.n_mels, preset.f_min, preset.f_max) == (
        pre.n_fft, pre.win_length, pre.n_mels, pre.f_min, pre.f_max)
    if name == "vctk":  # synthesis only: the port trains the ESD preset of this model
        assert preset.train is None
        return
    tr = cfg.train
    assert preset.train == TrainConfig(
        epoch=tr.epoch, batch_size=tr.batch_size, lr=tr.lr, save_epoch=tr.save_epoch,
        syn_every=tr.syn_every, fix_len=tr.fix_len, out_size=tr.out_size,
        max_grad=tr.max_grad, ema_decay=tr.ema_decay, mask_ratio=tr.mask_ratio,
        ref_type=tr.get("ref_type", "mel"), sty_type=tr.get("sty_type", "mel"),
        aug_type=tuple(tr.get("aug_type", ("N", "N", "N"))), unseen_spk=tuple(tr.unseen_spk),
        x_quantum=tr.x_quantum, y_quantum=tr.y_quantum)
    assert (preset.train_path, preset.val_path) == (cfg.path.train_path, cfg.path.val_path)


def test_full_width_layout_loads_strictly():
    """The benchmark DeX's JAX variables (shapes only, zeros) carry over
    through the port's converter into the port's module with strict
    loading: every parameter and buffer at full width lines up."""
    jmodel = _full_size_dex()
    b, tx, t_ref = 1, 8, 16
    shapes = jax.eval_shape(
        lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jax.random.PRNGKey(2), jnp.ones((b, tx), jnp.int32), jnp.full((b,), tx, jnp.int32),
            y_max_length=16, sampler=JaxSamplerConfig(num_steps=2),
            ref=jnp.zeros((b, 80, t_ref)), ref_lengths=jnp.full((b,), t_ref),
            sty=jnp.zeros((b, 80, t_ref)), sty_lengths=jnp.full((b,), t_ref),
            lf0=jnp.zeros((b, t_ref)), lf0_lengths=jnp.full((b,), t_ref),
            method=type(jmodel).synthesize,
        )
    )
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    cfg = load_preset("vctk_bench").model
    port = build_model(cfg, device="cpu")
    load_numpy_state(port, dex_tts_flax_to_torch(variables, cfg))
    n_params = sum(p.numel() for p in port.parameters())
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(variables["params"]))
    # torch's GRU also has hidden-side r/z biases (zero after conversion):
    # 2 gates × hidden per direction × 2 directions × layers
    gru_extra = 2 * (cfg.lf0_c_h // 2) * 2 * cfg.lf0_layers
    assert n_params == n_jax + gru_extra


def test_bigvgan_preset_equals_jax_bench():
    """`vctk_bench_bigvgan`'s vocoder is the JAX bench's `--vocoder
    bigvgan` (bench.py:108-119, vocoder dtype "auto" → bf16) field for
    field."""
    want = JaxBigVGANConfig(num_mels=80, dtype="bfloat16")
    got = load_preset("vctk_bench_bigvgan").vocoder
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_bigvgan_full_width_layout_loads_strictly():
    """The full-width BigVGAN's JAX parameters (shapes only, zeros) carry
    over through the port's converter with strict loading, and the key
    set is the JAX export's."""
    cfg = load_preset("vctk_bench_bigvgan").vocoder
    jcfg = JaxBigVGANConfig(num_mels=80, dtype="bfloat16")
    shapes = jax.eval_shape(
        lambda: JaxBigVGAN(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 4)))
    )["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = bigvgan_flax_to_torch(params, cfg)
    assert set(state) == set(jax_bigvgan_export(params, jcfg, weight_norm=False))
    port = build_vocoder(cfg, device="cpu")
    load_numpy_state(port, state)
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in port.parameters()) == n_jax
