"""Port vs JAX package: the readers of reference-format torch checkpoints
(convert.py), the vocoder loader with its config.json, and
`load_synthesizer` on one .pth, EMA on and off, at a tiny size. The port
raises where the JAX loader falls back to random weights."""

import functools
import json
import os
import pickle
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu import convert as jax_convert  # noqa: E402
from dex_tts_tpu.config import build_model as jax_build_model  # noqa: E402
from dex_tts_tpu.eval.evaluation import load_synthesizer as jax_load_synthesizer  # noqa: E402
from dex_tts_tpu.eval.evaluation import load_vocoder as jax_load_vocoder  # noqa: E402
from dex_tts_tpu.export import bigvgan_flax_to_torch as jax_bigvgan_export  # noqa: E402
from dex_tts_tpu.export import hifigan_flax_to_torch as jax_hifigan_export  # noqa: E402
from dex_tts_tpu.models.edm import SamplerConfig as JaxSamplerConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANConfig as JaxBigVGANConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANGenerator as JaxBigVGAN  # noqa: E402
from dex_tts_tpu.models.vocoder import HiFiGANConfig as JaxHiFiGANConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import HiFiGANGenerator as JaxHiFiGAN  # noqa: E402
from dex_tts_tpu.utils import Config  # noqa: E402
from dex_tts_tpu_torch import convert  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from dex_tts_tpu_torch.config import Preset  # noqa: E402
from dex_tts_tpu_torch.eval.evaluation import load_synthesizer, load_vocoder  # noqa: E402
from dex_tts_tpu_torch.models.edm import SamplerConfig  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, HiFiGANConfig  # noqa: E402
from dex_tts_tpu_torch.train import create_train_state  # noqa: E402
from dex_tts_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from tests.test_torch_config import assert_same_fields  # noqa: E402
from tests.torch_port_util import BIGVGAN_TINY, build_pair, perturb, style_inputs, t, tiny_cfg  # noqa: E402

CFG = tiny_cfg(n_spks=0)  # DeX: the JAX config builder forces n_spks 0
HIFIGAN_TINY = dict(num_mels=12, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                    upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                    resblock_dilation_sizes=((1, 3), (1, 3)))
N_STEPS, TEMP = 2, 1.5


def _jax_generator(kind, seed=3):
    """(JAX config, perturbed params as numpy) of a tiny generator."""
    jcls, gcls, arch = {"hifigan": (JaxHiFiGANConfig, JaxHiFiGAN, HIFIGAN_TINY),
                        "bigvgan": (JaxBigVGANConfig, JaxBigVGAN, BIGVGAN_TINY)}[kind]
    jcfg = jcls(**arch)
    params = jax.jit(gcls(jcfg).init)(jax.random.PRNGKey(seed), jnp.zeros((1, 12, 8)))
    return jcfg, perturb(jax.tree_util.tree_map(np.asarray, dict(params)), seed)["params"]


@functools.cache
def _reference_generator_state(kind, seed=3):
    """A generator state_dict in the reference layout: weight-normed
    convs (weight_g, weight_v); BigVGAN with the Kaiser-sinc filter
    buffers its alias-free activations keep. Cached: callers do not
    modify it."""
    jcfg, params = _jax_generator(kind, seed)
    if kind == "hifigan":
        return jcfg, params, jax_hifigan_export(params, jcfg, weight_norm=True)
    state = jax_bigvgan_export(params, jcfg, weight_norm=True)
    taps = np.random.default_rng(seed).standard_normal((1, 1, 12)).astype(np.float32)
    for prefix in sorted({k.rsplit(".act.", 1)[0] for k in state if ".act." in k}):
        state[f"{prefix}.upsample.filter"] = taps
        state[f"{prefix}.downsample.lowpass.filter"] = taps
    return jcfg, params, state


def _tensors(state):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}


def _plain_zip(inner_path, zip_path):
    """A plain (not torch) zip archive holding one checkpoint file, as the
    HiFi-GAN release ships generator_universal.pth.tar.zip."""
    with zipfile.ZipFile(zip_path, "w") as zf:
        zf.write(inner_path, os.path.basename(inner_path))
    return zip_path


class NotAllowed:
    """An object ``torch.load(weights_only=True)`` refuses."""


def _write(kind, d):
    """One file of each kind the readers meet → its path."""
    rng = np.random.default_rng(0)
    sd = {"a.weight": rng.standard_normal((3, 4)).astype(np.float32),
          "a.bias": rng.standard_normal(3).astype(np.float32),
          "bn.num_batches_tracked": np.asarray(7, np.int64)}
    ema = {k: v + 1 for k, v in sd.items()}
    path = os.path.join(d, f"{kind}.pth")
    if kind == "bare":
        payload = _tensors(sd)
    elif kind == "trainer":
        payload = {"scores": {"loss": 1.0}, "state_dict": _tensors(sd), "ema": _tensors(ema),
                   "optimizer": {}}
    elif kind == "trainer_no_ema":
        payload = {"scores": {}, "state_dict": _tensors(sd), "optimizer": {}}
    elif kind in ("hifigan", "hifigan_zip"):
        payload = {"generator": _tensors(_reference_generator_state("hifigan")[2])}
    elif kind == "bigvgan":
        payload = {"generator": _tensors(_reference_generator_state("bigvgan")[2])}
    elif kind == "torch_zip_refused":
        payload = {"state_dict": _tensors(sd), "extra": NotAllowed()}
    torch.save(payload, path)
    if kind == "hifigan_zip":
        path = _plain_zip(path, os.path.join(d, "generator_universal.pth.tar.zip"))
    return path


@pytest.mark.parametrize("kind", ["bare", "trainer", "trainer_no_ema", "hifigan", "hifigan_zip",
                                  "bigvgan"])
def test_readers_match_jax(kind, tmp_path):
    """Both readers give equal dicts (names, dtypes, values) on each file
    kind, ``key="ema"`` included; the fold of weight norm is bit-identical."""
    path = _write(kind, str(tmp_path))

    def same(got, want):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    same(convert.load_torch_checkpoint(path), jax_convert.load_torch_checkpoint(path))
    got_sd, got_ema = convert.load_torch_trainer_checkpoint(path)
    want_sd, want_ema = jax_convert.load_torch_trainer_checkpoint(path)
    same(got_sd, want_sd)
    assert (got_ema is None) == (want_ema is None) == (kind != "trainer")
    if kind == "trainer":
        same(got_ema, want_ema)
        same(convert.load_torch_checkpoint(path, key="ema"),
             jax_convert.load_torch_checkpoint(path, key="ema"))
    state = convert.load_torch_checkpoint(path)
    folded = convert.fold_weight_norm(state)
    same(folded, jax_convert.fold_weight_norm(state))
    assert not any(k.endswith(("weight_g", "weight_v")) for k in folded)
    if kind.startswith(("hifigan", "bigvgan")):
        assert any(k.endswith("weight_g") for k in state)


def test_torch_zip_that_fails_to_load_reraises_like_jax(tmp_path):
    """A torch zip file that fails ``weights_only`` deserialization is also
    a zipfile: both readers re-raise the original error instead of
    extracting a storage blob."""
    path = _write("torch_zip_refused", str(tmp_path))
    assert zipfile.is_zipfile(path)
    with pytest.raises(pickle.UnpicklingError) as want:
        jax_convert.load_torch_checkpoint(path)
    with pytest.raises(pickle.UnpicklingError) as got:
        convert.load_torch_checkpoint(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["hifigan", "bigvgan"])
def test_load_vocoder_matches_jax(kind, tmp_path):
    """A reference generator file (HiFi-GAN: weight-normed, in a plain
    zip; BigVGAN: weight-normed ``g_05000000`` with its filter buffers)
    beside a config.json of the tiny architecture: both loaders read the
    same architecture keys and give the same waveform (f32 on the CPU)."""
    jcfg, params, state = _reference_generator_state(kind)
    d = str(tmp_path)
    arch = {k: getattr(jcfg, k) for k in ("num_mels", "upsample_rates", "upsample_kernel_sizes",
                                          "upsample_initial_channel", "resblock_kernel_sizes",
                                          "resblock_dilation_sizes")}
    if kind == "bigvgan":
        arch.update(activation=jcfg.activation, snake_logscale=jcfg.snake_logscale)
        torch.save(_tensors(state), os.path.join(d, "g_05000000"))
    else:
        raw = os.path.join(d, "generator_universal.pth.tar")
        torch.save({"generator": _tensors(state)}, raw)
        _plain_zip(raw, os.path.join(d, "generator_universal.pth.tar.zip"))
        os.remove(raw)
    # lists as a config.json has them, plus keys that are not architecture
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({**arch, "resblock": "1", "sampling_rate": 22050}, f)

    jvoc, jparams = jax_load_vocoder(Config({"vocoder": kind, "path": {"vocoder_path": d},
                                             "preprocess": {"n_mels": 12}}))
    base = BigVGANConfig() if kind == "bigvgan" else HiFiGANConfig()
    voc = load_vocoder(Preset(model=CFG, vocoder=base, vocoder_path=d), device="cpu")
    for k in arch:
        assert getattr(voc.cfg, k) == getattr(jvoc.cfg, k) == getattr(jcfg, k), k
    assert voc.cfg.dtype == jvoc.cfg.dtype == "float32"
    mel = np.random.default_rng(4).standard_normal((2, 12, 21)).astype(np.float32)
    want = np.asarray(jax.jit(jvoc.apply)({"params": jparams}, jnp.asarray(mel)))
    with torch.no_grad():
        got = voc(t(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def jax_config(cfg, ema: bool, vocoder_path: str = "") -> Config:
    """The JAX package's YAML layout for a port TTSConfig (DeX)."""
    dit = cfg.dit
    return Config({
        "model_family": "dex", "n_vocab": cfg.n_vocab, "vocoder": "hifigan",
        "path": {"val_path": "no/such/filelist.txt", "vocoder_path": vocoder_path},
        "preprocess": {"n_mels": cfg.n_feats},
        "model": {
            "add_blank": True, "n_feats": cfg.n_feats, "spk_emb_dim": cfg.spk_emb_dim,
            "tv_encoder": {"c_h": cfg.tv_c_h, "c_out": cfg.tv_c_out, "c_out_g": cfg.tv_c_out_g,
                           "num_layer": cfg.tv_layers, "n_emb": cfg.tv_n_emb,
                           "commit_w": cfg.tv_commit_w},
            "lf0_encoder": {"c_h": cfg.lf0_c_h, "c_out": cfg.lf0_c_out,
                            "c_out_g": cfg.lf0_c_out_g, "num_layer": cfg.lf0_layers},
            "tiv_encoder": {"c_h": cfg.tiv_c_h, "c_out": cfg.tiv_c_out,
                            "num_layer": cfg.tiv_layers},
            "encoder": {"n_channels": cfg.enc_channels, "filter_channels": cfg.enc_filter_channels,
                        "filter_channels_dp": cfg.enc_filter_channels_dp,
                        "n_layers": cfg.enc_layers, "kernel_size": cfg.enc_kernel,
                        "p_dropout": cfg.enc_dropout, "n_heads": cfg.enc_heads},
            "decoder": {"dim": cfg.dec_dim, "dim_mults": list(cfg.dec_dim_mults),
                        "pe_scale": cfg.pe_scale},
            "dit": {k: getattr(dit, k) for k in ("patch_size", "stride_size", "hidden_size",
                                                 "depth", "num_heads", "mlp_ratio", "conv_pos",
                                                 "conv_pos_groups")},
        },
        "test": {"ema": ema},
    })


@pytest.fixture(scope="module")
def weights():
    """(JAX model, port models A and B with two perturbed weight sets)."""
    jmodel, variables, port_a = build_pair(CFG, seed=0)
    port_b = build_tts(CFG)
    convert.load_numpy_state(port_b, convert.dex_tts_flax_to_torch(perturb(variables, seed=1), CFG))
    return jmodel, port_a, port_b


@pytest.fixture(scope="module")
def run_jax(weights):
    """JAX synthesize (2 euler steps) of the fixture's model, jitted once
    for the variables of every loader call."""
    jmodel = weights[0]

    @jax.jit
    def run(variables, x, x_lengths, noise, style):
        return jmodel.apply(variables, jax.random.PRNGKey(0), x, x_lengths, y_max_length=128,
                            sampler=JaxSamplerConfig(num_steps=N_STEPS), temperature=TEMP,
                            latents_noise=noise, method=type(jmodel).synthesize, **style)

    return run


def test_jax_config_builds_the_tiny_model():
    assert_same_fields(CFG, jax_build_model(jax_config(CFG, ema=False)))


@pytest.mark.parametrize("layout", ["port", "reference"])
@pytest.mark.parametrize("ema", [False, True])
def test_load_synthesizer_matches_jax(layout, ema, weights, run_jax, tmp_path):
    """One .pth holding weights A as ``state_dict`` and B as ``ema``: the
    port's own layout (`CheckpointManager`, read from <exp_dir>/ckpt) or a
    reference ``model-train-best.pth``. Both loaders pick A, or B under
    EMA; the mel agrees within the f32 bound of test_torch_tts.py (same
    initial noise), the waveform through the tiny HiFi-GAN within 1e-4."""
    jmodel, port_a, port_b = weights
    exp_dir, voc_dir = str(tmp_path / "exp"), str(tmp_path / "voc")
    os.makedirs(exp_dir)
    os.makedirs(voc_dir)
    jcfg, _, voc_state = _reference_generator_state("hifigan")
    torch.save({"generator": _tensors(voc_state)}, os.path.join(voc_dir, "generator_universal.pth.tar"))
    with open(os.path.join(voc_dir, "config.json"), "w") as f:
        json.dump(HIFIGAN_TINY, f)
    if layout == "port":
        state = create_train_state(port_a)
        state.ema = {n: p.detach().clone() for n, p in port_b.named_parameters()}
        CheckpointManager(os.path.join(exp_dir, "ckpt")).save(state, "best-train")
        pth = os.path.join(exp_dir, "ckpt", "best-train.pth")
        port_a.eval()
        # the port's EMA holds parameters; its buffers are the model's
        ema_state = {**port_a.state_dict(), **state.ema}
    else:
        pth = os.path.join(exp_dir, "model-train-best.pth")
        ema_state = port_b.state_dict()
        torch.save({"scores": {}, "state_dict": port_a.state_dict(), "ema": ema_state,
                    "optimizer": {}}, pth)
    chosen = ema_state if ema else port_a.state_dict()

    preset = Preset(model=CFG, vocoder=HiFiGANConfig(), vocoder_path=voc_dir, ema=ema)
    synth = load_synthesizer(preset, exp_dir, n_timesteps=N_STEPS, device="cpu")
    assert synth.sampler == SamplerConfig(num_steps=N_STEPS)
    for k, v in chosen.items():
        torch.testing.assert_close(synth.model.state_dict()[k], v, rtol=0, atol=0)
    # the JAX loader goes to orbax when <exp_dir>/ckpt is a directory: it
    # gets the .pth file itself
    jsynth, _ = jax_load_synthesizer(jax_config(CFG, ema, voc_dir), pth, n_timesteps=N_STEPS)

    rng = np.random.default_rng(0)
    b, tx, tr = 2, 9, 11
    x = rng.integers(1, 30, (b, tx)).astype(np.int32)
    x_lengths = np.asarray([tx, 6], np.int32)
    x[1, 6:] = 0
    style = style_inputs(rng, b, tr, lengths=[tr, 8])
    noise = rng.standard_normal((b, CFG.n_feats, 128)).astype(np.float32)
    want = run_jax(jsynth.variables, jnp.asarray(x), jnp.asarray(x_lengths), jnp.asarray(noise),
                   {k: jnp.asarray(v) for k, v in style.items()})
    with torch.no_grad():
        got = synth.model.synthesize(
            t(x, torch.long), t(x_lengths, torch.long), y_max_length=128,
            sampler=SamplerConfig(num_steps=N_STEPS), temperature=TEMP, latents_noise=t(noise),
            **{k: t(v) for k, v in style.items()})
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # y_lengths
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-3, rtol=1e-2)
    mel = np.asarray(want[1])
    want_wav = np.asarray(jsynth.vocoder.apply({"params": jsynth.vocoder_params}, jnp.asarray(mel)))
    with torch.no_grad():
        got_wav = synth.vocoder(t(mel)).numpy()
    np.testing.assert_allclose(got_wav, want_wav, atol=1e-4)
    assert synth.vocoder.cfg.upsample_rates == jcfg.upsample_rates


def test_missing_checkpoints_raise_unless_random_init(weights, tmp_path):
    """No tag under <exp_dir>/ckpt and no reference file: FileNotFoundError
    naming the tag and every path tried; no vocoder file: the same. Random
    weights only with ``random_init=True``, with a warning."""
    exp_dir, voc_dir = str(tmp_path / "exp"), str(tmp_path / "voc")
    os.makedirs(os.path.join(exp_dir, "ckpt"))
    os.makedirs(voc_dir)
    preset = Preset(model=CFG, vocoder=HiFiGANConfig(**HIFIGAN_TINY), vocoder_path=voc_dir)
    with pytest.raises(FileNotFoundError) as err:
        load_synthesizer(preset, exp_dir, n_timesteps=N_STEPS, tag="last", device="cpu")
    msg = str(err.value)
    assert "'last'" in msg
    for tried in (os.path.join(exp_dir, "ckpt", "last.pth"),
                  os.path.join(exp_dir, "model-last.pth")):
        assert tried in msg
    with pytest.raises(FileNotFoundError, match="hifigan checkpoint"):
        load_vocoder(preset, device="cpu")
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        synth = load_synthesizer(preset, exp_dir, n_timesteps=N_STEPS, tag="last", device="cpu",
                                 random_init=True)
    assert synth.vocoder is not None and synth.device.type == "cpu"
    # a checkpoint is present but the vocoder is not: still raises
    torch.save(weights[1].state_dict(), os.path.join(exp_dir, "model-last.pth"))
    with pytest.raises(FileNotFoundError, match="hifigan checkpoint"):
        load_synthesizer(preset, exp_dir, n_timesteps=N_STEPS, tag="last", device="cpu")


def test_ema_preset_without_ema_weights_warns(weights, tmp_path):
    """``preset.ema`` on a bare state_dict: a warning, and the raw weights
    (JAX: evaluation.py:296-305)."""
    _, port_a, _ = weights
    pth = str(tmp_path / "model.pth")
    torch.save(port_a.state_dict(), pth)
    preset = Preset(model=CFG, vocoder=HiFiGANConfig(), vocoder_path="", ema=True)
    with pytest.warns(UserWarning, match="no 'ema' weights"):
        synth = load_synthesizer(preset, pth, n_timesteps=N_STEPS, device="cpu", random_init=True)
    for k, v in port_a.state_dict().items():
        torch.testing.assert_close(synth.model.state_dict()[k], v, rtol=0, atol=0)


def test_load_synthesizer_argument_checks():
    preset = Preset(model=CFG)
    for kw, msg in ((dict(n_timesteps=10, dit_cache_interval=3), "multiple"),
                    (dict(solver="rk4"), "unknown solver"),
                    (dict(solver="dpmpp2m", dit_cache_interval=2, n_timesteps=4), "euler")):
        with pytest.raises(ValueError, match=msg):
            load_synthesizer(preset, "unused", device="cpu", **kw)
        with pytest.raises(ValueError, match=msg):
            jax_load_synthesizer(jax_config(CFG, ema=False), "unused", **kw)
