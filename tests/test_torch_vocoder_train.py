"""Port vs JAX package: vocoder GAN training (train/vocoder.py,
data/vocoder_dataset.py, train_vocoder.py). The optimizer chain against
optax fed the same gradients; the critics' and the generator's losses and
gradients of a tiny HiFi-GAN and a tiny BigVGAN against the JAX train
step's ``disc_loss_fn``/``gen_loss_fn``, and one whole step's metrics; the
dataset's crops; checkpoints, a resume, the serving handoff through
`load_vocoder`, the warm start from a weight-normed release, and the CLI
on the CPU."""

import functools
import importlib.util
import json
import math
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import write_reference_wavs  # noqa: E402
from dex_tts_tpu.audio.stft import MelSpectrogram as JaxMel  # noqa: E402
from dex_tts_tpu.audio.wav import write_wav  # noqa: E402
from dex_tts_tpu.data import vocoder_dataset as jds  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANConfig as JaxBigVGANConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANGenerator as JaxBigVGAN  # noqa: E402
from dex_tts_tpu.models.vocoder import HiFiGANConfig as JaxHiFiGANConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import HiFiGANGenerator as JaxHiFiGAN  # noqa: E402
from dex_tts_tpu.models.vocoder import discriminators as jd  # noqa: E402
from dex_tts_tpu.train import vocoder as jtv  # noqa: E402
from dex_tts_tpu_torch import train_vocoder  # noqa: E402
from dex_tts_tpu_torch.audio.stft import MelSpectrogram  # noqa: E402
from dex_tts_tpu_torch.config import Preset  # noqa: E402
from dex_tts_tpu_torch.convert import (  # noqa: E402
    bigvgan_flax_to_torch,
    discriminators_flax_to_torch,
    hifigan_flax_to_torch,
    load_numpy_state,
)
from dex_tts_tpu_torch.data import vocoder_dataset as pds  # noqa: E402
from dex_tts_tpu_torch.eval.evaluation import load_vocoder  # noqa: E402
from dex_tts_tpu_torch.export import vocoder_reference_state  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import (  # noqa: E402
    BigVGANConfig,
    BigVGANGenerator,
    HiFiGANConfig,
    HiFiGANGenerator,
)
from dex_tts_tpu_torch.models.vocoder.discriminators import DiscriminatorConfig  # noqa: E402
from dex_tts_tpu_torch.train import vocoder as ptv  # noqa: E402
from tests.torch_port_util import BIGVGAN_TINY, perturb, t, tiny_cfg  # noqa: E402

HIFIGAN_TINY = dict(num_mels=12, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                    upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                    resblock_dilation_sizes=((1, 3),))
GENERATORS = {  # kind → (JAX config, JAX module, port config, port module, converter)
    "hifigan": (JaxHiFiGANConfig(**HIFIGAN_TINY), JaxHiFiGAN, HiFiGANConfig(**HIFIGAN_TINY),
                HiFiGANGenerator, hifigan_flax_to_torch),
    "bigvgan": (JaxBigVGANConfig(**BIGVGAN_TINY), JaxBigVGAN, BigVGANConfig(**BIGVGAN_TINY),
                BigVGANGenerator, bigvgan_flax_to_torch),
}
HOP = {"hifigan": 16, "bigvgan": 8}  # Π upsample_rates
DISC = dict(mpd_periods=(2, 3), mrd_resolutions=((64, 16, 32),), channel_mult=0.125)
SEGMENT = 256
# f32 sums in another order through the generator, both mels and both
# critics (largest error seen ~1e-5 of the bound's scale)
LOSS_RTOL = 1e-4
GRAD_REL = 1e-3
# the L1 mel term's gradient is ill-conditioned where the log-mel of the
# generated waveform is small (mel bins near the 1e-5 floor, |rfft| of
# ~1e-3 formed by cancellation): the two FFTs' rounding moves it by up to
# 1.6e-3 of the bound's scale on the tiny BigVGAN (adversarial and
# feature-matching terms alone: 1e-5)
MEL_GRAD_REL = 1e-2


def _mels(kind, cls):
    """(input mel, full-band loss mel) at the generator's hop."""
    kw = dict(n_fft=64, hop_length=HOP[kind], win_length=64, n_mels=12)
    return cls(**kw), cls(**kw, fmax=11025.0)


def _wav(b=2, seed=0):
    rng = np.random.default_rng(seed)
    tt = np.arange(SEGMENT) / 22050.0
    wav = 0.5 * np.sin(2 * np.pi * rng.uniform(200, 800, (b, 1)) * tt)
    return (wav + 0.05 * rng.standard_normal(wav.shape)).astype(np.float32)


@functools.cache
def _jax_params(kind):
    """Perturbed JAX generator and critic params (numpy) of a tiny setup."""
    jcfg, jgen, *_ = GENERATORS[kind]
    wav = _wav()
    mel_in = JaxMel(n_fft=64, hop_length=HOP[kind], win_length=64, n_mels=12)(wav)[0]
    gen = jax.jit(jgen(jcfg).init)(jax.random.PRNGKey(1), mel_in[:, :, :SEGMENT // HOP[kind]])
    dcfg = jd.DiscriminatorConfig(**DISC)
    disc = {"mpd": jax.jit(jd.MultiPeriodDiscriminator(dcfg).init)(jax.random.PRNGKey(2),
                                                                   wav, wav)["params"],
            "mrd": jax.jit(jd.MultiResolutionDiscriminator(dcfg).init)(jax.random.PRNGKey(3),
                                                                       wav, wav)["params"]}
    tree = jax.tree_util.tree_map(np.asarray, {"gen": gen["params"], "disc": disc})
    # the reference init normal(0, 0.01) keeps the generator's output near 0
    return perturb(tree, seed=4, scale=0.1)


def _port_state(kind, seed=0):
    """A port train state on the CPU carrying `_jax_params(kind)`."""
    _, _, pcfg, _, convert = GENERATORS[kind]
    params = _jax_params(kind)
    state = ptv.create_vocoder_train_state(pcfg, DiscriminatorConfig(**DISC), seed=seed,
                                           device="cpu")
    load_numpy_state(state.generator, convert(params["gen"], pcfg))
    load_numpy_state(state.critics, discriminators_flax_to_torch(params["disc"],
                                                                 DiscriminatorConfig(**DISC)))
    return state


def _jax_losses_and_grads(kind, wav):
    """JAX's disc_loss_fn and gen_loss_fn (train/vocoder.py:157-186) at the
    same critic params → (loss_d, critic grads, gen losses, gen grads of
    {"adv_fm": adversarial + feature matching, "mel": the L1 mel term}),
    grads in port names."""
    jcfg, jgen, pcfg, _, convert = GENERATORS[kind]
    params = _jax_params(kind)
    gen = jgen(jcfg)
    dcfg = jd.DiscriminatorConfig(**DISC)
    mpd, mrd = jd.MultiPeriodDiscriminator(dcfg), jd.MultiResolutionDiscriminator(dcfg)
    mel_input, mel_loss = _mels(kind, JaxMel)

    @jax.jit
    def run(gp, dp, wav):
        mel_in = mel_input(wav)[0][:, :, : wav.shape[1] // HOP[kind]]
        mel_target = mel_loss(wav)[0]
        fake = jax.lax.stop_gradient(gen.apply({"params": gp}, mel_in))

        def disc_loss_fn(dp):
            r_p, f_p, _, _ = mpd.apply({"params": dp["mpd"]}, wav, fake)
            r_r, f_r, _, _ = mrd.apply({"params": dp["mrd"]}, wav, fake)
            return jd.discriminator_loss(r_p, f_p)[0] + jd.discriminator_loss(r_r, f_r)[0]

        def gen_loss_parts(gp):
            fake = gen.apply({"params": gp}, mel_in)
            l_mel = jnp.mean(jnp.abs(mel_loss(fake)[0] - mel_target))
            _, f_p, fmap_rp, fmap_gp = mpd.apply({"params": dp["mpd"]}, wav, fake)
            _, f_r, fmap_rr, fmap_gr = mrd.apply({"params": dp["mrd"]}, wav, fake)
            adv = jd.generator_loss(f_p)[0] + jd.generator_loss(f_r)[0]
            fm = jd.feature_loss(fmap_rp, fmap_gp) + jd.feature_loss(fmap_rr, fmap_gr)
            return ({"adv_fm": adv + fm, "mel": l_mel},
                    {"loss_gen": adv + fm + 45.0 * l_mel, "loss_mel": l_mel, "loss_adv": adv,
                     "loss_fm": fm})

        loss_d, d_grads = jax.value_and_grad(disc_loss_fn)(dp)
        _, vjp, losses = jax.vjp(gen_loss_parts, gp, has_aux=True)
        g_grads = {part: vjp({"adv_fm": float(part == "adv_fm"), "mel": float(part == "mel")})[0]
                   for part in ("adv_fm", "mel")}
        return loss_d, d_grads, losses, g_grads

    loss_d, d_grads, g_losses, g_grads = jax.tree_util.tree_map(
        np.asarray, run(params["gen"], params["disc"], wav))
    return (float(loss_d), discriminators_flax_to_torch(d_grads, DiscriminatorConfig(**DISC)),
            {k: float(v) for k, v in g_losses.items()},
            {part: convert(g, pcfg) for part, g in g_grads.items()})


def _assert_grads(named_grads, want, rel=GRAD_REL):
    """Per tensor |g − g_jax| ≤ rel × (max|g_jax| + 1e-3 × the largest)."""
    top = max(np.abs(g).max() for g in want.values())
    assert sorted(want) == sorted(named_grads)
    for name, g in named_grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, err_msg=name,
                                   atol=rel * (np.abs(want[name]).max() + 1e-3 * top))


@pytest.mark.parametrize("kind", ["hifigan", "bigvgan"])
def test_losses_and_gradients_match_jax(kind):
    """The critics' loss and every critic gradient on the generator's
    output (detached), then the generator's loss parts and every
    generator gradient against the same critics: of the adversarial and
    feature-matching terms, and of the L1 mel term."""
    wav = _wav()
    want_d, want_dg, want_g, want_gg = _jax_losses_and_grads(kind, wav)
    state = _port_state(kind)
    mel_input, mel_loss = _mels(kind, MelSpectrogram)
    mel_in, mel_target = ptv.vocoder_mels(t(wav), mel_input, mel_loss)
    fake = state.generator(mel_in)
    loss_d = ptv.critic_loss(state.critics, t(wav), fake.detach())
    loss_d.backward()
    assert math.isclose(loss_d.item(), want_d, rel_tol=LOSS_RTOL)
    _assert_grads({n: p.grad for n, p in state.critics.named_parameters()}, want_dg)
    state.critics.requires_grad_(False)
    losses = ptv.generator_losses(state.critics, t(wav), fake, mel_target, mel_loss, 45.0)
    for k, v in want_g.items():
        assert math.isclose(losses[k].item(), v, rel_tol=LOSS_RTOL), (k, losses[k].item(), v)
    names, params = zip(*state.generator.named_parameters())
    for part, value, rel in (("adv_fm", losses["loss_adv"] + losses["loss_fm"], GRAD_REL),
                             ("mel", losses["loss_mel"], MEL_GRAD_REL)):
        grads = torch.autograd.grad(value, params, retain_graph=True)
        _assert_grads(dict(zip(names, grads)), want_gg[part], rel)


def test_one_step_matches_jax():
    """One whole step from the same weights: the critics' loss, and the
    generator's losses against the critics after their update (JAX's
    order), within LOSS_RTOL of the JAX step's."""
    kind = "hifigan"
    jcfg, jgen, *_ = GENERATORS[kind]
    params = _jax_params(kind)
    gen_tx, disc_tx = jtv.make_vocoder_optimizer(), jtv.make_vocoder_optimizer()
    gp, dp = jax.tree_util.tree_map(jnp.asarray, (params["gen"], params["disc"]))
    jstate = jtv.VocoderTrainState(step=jnp.zeros((), jnp.int32), gen_params=gp,
                                   gen_opt_state=gen_tx.init(gp), disc_params=dp,
                                   disc_opt_state=disc_tx.init(dp))
    dcfg = jd.DiscriminatorConfig(**DISC)
    jstep = jtv.make_vocoder_train_step(jgen(jcfg), jd.MultiPeriodDiscriminator(dcfg),
                                        jd.MultiResolutionDiscriminator(dcfg), gen_tx, disc_tx,
                                        *_mels(kind, JaxMel))
    wav = _wav(seed=1)
    _, want = jax.jit(jstep)(jstate, {"wav": wav})
    state = _port_state(kind)
    got = ptv.make_vocoder_train_step(*_mels(kind, MelSpectrogram))(state, {"wav": wav})
    assert sorted(got) == sorted(want)
    for k in want:
        assert math.isclose(got[k].item(), float(want[k]), rel_tol=LOSS_RTOL), k
    assert state.step == 1


def test_optimizer_chain_matches_optax():
    """clip_by_global_norm(1000) → AdamW(0.8, 0.99, wd 0.01) under the
    staircase decay, fed the same gradients over six updates (the second
    one clipped): the parameters and the learning rate of each update."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = jtv.make_vocoder_optimizer(lr=1e-2, lr_decay=0.5, steps_per_epoch=2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(t(v)) for k, v in params.items()})
    opt = ptv.make_vocoder_optimizer(module, lr=1e-2, lr_decay=0.5, steps_per_epoch=2)
    for n in range(6):
        assert math.isclose(opt.adamw.param_groups[0]["lr"], 1e-2 * 0.5 ** (n // 2))
        grads = {k: (rng.standard_normal(s) * (3000.0 if n == 1 else 1.0)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = {k: jparams[k] + updates[k] for k in jparams}
        want_norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
        for k, p in module.items():
            p.grad = t(grads[k]).clone()  # the clip works in place
        norm = opt.step()
        assert math.isclose(norm.item(), want_norm, rel_tol=1e-5)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=2e-6, err_msg=f"update {n}, {k}")
    module["b"].grad = None
    with pytest.raises(RuntimeError, match="got no gradient"):
        opt.step()


def test_segment_must_be_a_hop_multiple():
    state = _port_state("hifigan")
    step = ptv.make_vocoder_train_step(*_mels("hifigan", MelSpectrogram))
    with pytest.raises(ValueError, match="must be a multiple of the mel hop 16"):
        step(state, {"wav": _wav()[:, :250]})
    assert state.step == 0
    jstep = jtv.make_vocoder_train_step(None, None, None, None, None,
                                        *_mels("hifigan", JaxMel))
    with pytest.raises(ValueError, match="must be a multiple of the mel hop 16"):
        jstep(None, {"wav": _wav()[:, :250]})


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Four 16 kHz reference recordings (resampled to 22.05 kHz by the
    dataset) and one 22.05 kHz file shorter than a segment."""
    d = tmp_path_factory.mktemp("wavs")
    write_reference_wavs(str(d), 4)
    os.makedirs(d / "short")
    write_wav(str(d / "short" / "tiny.wav"), 0.1 * np.ones(3000, np.float32))
    return d


def test_dataset_crops_equal_jax(wav_dir, tmp_path):
    paths = pds.wav_paths_from_source(str(wav_dir))
    assert paths == jds.wav_paths_from_source(str(wav_dir)) and len(paths) == 5
    filelist = tmp_path / "train.txt"
    filelist.write_text("/data/LJ/mel/spk/spk-mel-LJ001.npy|Hi.|0\n\n/x/a.wav|Yo.|1\n")
    assert pds.wav_paths_from_source(str(filelist)) == jds.wav_paths_from_source(str(filelist))
    assert pds.wav_paths_from_source(str(filelist))[0] == "/data/LJ/wav/spk/LJ001.wav"
    got = pds.WavSegmentDataset(paths, segment=8192, seed=3)
    want = jds.WavSegmentDataset(paths, segment=8192, seed=3)
    for a, b in zip(got.batches(4, 6), want.batches(4, 6)):
        assert a["wav"].dtype == np.float32 and a["wav"].shape == (4, 8192)
        np.testing.assert_array_equal(a["wav"], b["wav"])
    short = paths.index(str(wav_dir / "short" / "tiny.wav"))
    padded = got.sample_segment(short)
    assert not padded[3000:].any() and padded[:3000].all()


def test_dataset_errors_and_cache_bound(wav_dir):
    paths = pds.wav_paths_from_source(str(wav_dir))
    for mod in (pds, jds):
        with pytest.raises(ValueError, match="no wav files"):
            mod.WavSegmentDataset([])
        with pytest.raises(FileNotFoundError, match="1/6 wav paths do not exist"):
            mod.WavSegmentDataset(paths + ["/nonexistent/x.wav"])
    bound = 3 * 22050 * 4  # three seconds of f32 audio: some files fit, not all
    got = pds.WavSegmentDataset(paths, seed=1, cache_bytes=bound)
    want = jds.WavSegmentDataset(paths, seed=1, cache_bytes=bound)
    for i in range(len(paths)):
        np.testing.assert_array_equal(got.sample_segment(i), want.sample_segment(i))
    assert sorted(got._cache) == sorted(want._cache) and got._cached_bytes == want._cached_bytes
    assert 0 < len(got._cache) < len(paths) and got._cached_bytes <= bound


def test_checkpoint_round_trip_and_resume_repeats_the_next_step(tmp_path):
    state = _port_state("bigvgan")
    step = ptv.make_vocoder_train_step(*_mels("bigvgan", MelSpectrogram))
    for seed in (1, 2):
        step(state, {"wav": _wav(seed=seed)})
    ckpt = ptv.VocoderCheckpoints(str(tmp_path))
    ckpt.save(state, "last")
    raw = torch.load(ckpt.path("last"), weights_only=True)
    assert sorted(raw) == ["critics", "disc_optimizer", "gen_optimizer", "generator", "step"]
    fresh = ptv.create_vocoder_train_state(BigVGANConfig(**BIGVGAN_TINY),
                                           DiscriminatorConfig(**DISC), seed=9, device="cpu")
    ckpt.restore(fresh, "last")
    assert fresh.step == 2
    batch = {"wav": _wav(seed=3)}
    want = {k: v.item() for k, v in step(state, batch).items()}
    got = {k: v.item() for k, v in step(fresh, batch).items()}
    assert got == want
    for module in ("generator", "critics"):
        for (name, p), q in zip(getattr(state, module).state_dict().items(),
                                getattr(fresh, module).state_dict().values()):
            assert torch.equal(p, q), name
    assert fresh.gen_optimizer.adamw.param_groups[0]["lr"] == \
        state.gen_optimizer.adamw.param_groups[0]["lr"]


def test_gen_last_is_served_by_load_vocoder(tmp_path):
    """``gen_last.pth`` loads strictly through `load_vocoder` and gives the
    trained generator's output; ``gen_best.pth`` comes first when both
    are there."""
    state = _port_state("hifigan")
    step = ptv.make_vocoder_train_step(*_mels("hifigan", MelSpectrogram))
    step(state, {"wav": _wav()})
    ckpt = ptv.VocoderCheckpoints(str(tmp_path / "voc"))
    ckpt.save_generator(state, "gen_last")
    preset = Preset(model=tiny_cfg(), vocoder=HiFiGANConfig(**HIFIGAN_TINY),
                    vocoder_path=ckpt.root)
    mel = t(np.random.default_rng(6).standard_normal((2, 12, 9)).astype(np.float32))
    served = load_vocoder(preset, device="cpu")
    with torch.no_grad():
        assert torch.equal(served(mel), state.generator(mel))
    other = _port_state("hifigan", seed=1)
    with torch.no_grad():
        for p in other.generator.parameters():
            p.add_(0.01)
    ckpt.save_generator(other, "gen_best")
    with torch.no_grad():
        assert torch.equal(load_vocoder(preset, device="cpu")(mel), other.generator(mel))


def _load_jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_vocoder", os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                          "train_vocoder.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_init_gen_from_a_weight_normed_release(tmp_path):
    """``--init_gen``: a released BigVGAN file (weight-normed convs, the
    Kaiser-sinc filter buffers, a ``generator`` wrapper) lands in the
    fresh state's generator exactly as the JAX CLI converts it."""
    jcfg, jgen, pcfg, _, convert = GENERATORS["bigvgan"]
    source = _port_state("bigvgan")
    release = {k: torch.from_numpy(v)
               for k, v in vocoder_reference_state(source.generator).items()}
    release["resblocks.0.activations.0.upsample.filter"] = torch.ones(1, 1, 12)
    release["activation_post.downsample.lowpass.filter"] = torch.ones(1, 1, 12)
    path = str(tmp_path / "g_release.pth")
    torch.save({"generator": release}, path)

    state = ptv.create_vocoder_train_state(pcfg, DiscriminatorConfig(**DISC), seed=7,
                                           device="cpu")
    train_vocoder.warm_start_generator(state, path)
    jax_cli = _load_jax_cli()
    gen_tx = jtv.make_vocoder_optimizer()
    jstate = jtv.VocoderTrainState(step=0, gen_params=None, gen_opt_state=None,
                                   disc_params=None, disc_opt_state=None)
    jstate = jax_cli.warm_start_generator(jstate, jgen(jcfg), gen_tx, "bigvgan", path)
    want = convert(jax.tree_util.tree_map(np.asarray, jstate.gen_params), jcfg)
    got = state.generator.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k, v in source.generator.state_dict().items():  # folding g·v/‖v‖ with g = ‖v‖
        torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-7)
    ptv.make_vocoder_train_step(*_mels("bigvgan", MelSpectrogram))(state, {"wav": _wav()})
    with pytest.raises(ValueError, match="fresh state"):
        train_vocoder.warm_start_generator(state, path)


def test_cli_on_the_cpu(wav_dir, tmp_path, capsys, monkeypatch):
    """`python -m dex_tts_tpu_torch.train_vocoder` with ``--device cpu``:
    JSON log lines, the checkpoint tags, a resume, and SIGTERM raised
    inside the loader (``preempt`` and ``last`` saved, the loop stops, the
    signal handlers come back). The generator and the critics are narrowed
    (the CLI's flow is the point, not their width); the hop stays 256."""
    monkeypatch.setattr(train_vocoder, "HiFiGANConfig", lambda num_mels: HiFiGANConfig(
        num_mels=num_mels, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
        upsample_initial_channel=16, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),)))
    monkeypatch.setattr(train_vocoder, "DiscriminatorConfig",
                        lambda: DiscriminatorConfig(channel_mult=0.0625))
    ckpt_dir = str(tmp_path / "ckpt")
    argv = ["--data", str(wav_dir), "--vocoder", "hifigan", "--preset", "esd", "--segment",
            "1024", "--batch", "2", "--log_every", "1", "--save_every", "2", "--ckpt_dir",
            ckpt_dir, "--device", "cpu", "--cache_gb", "0"]
    state = train_vocoder.main(argv + ["--steps", "3"])
    assert state.step == 3
    assert sorted(os.listdir(ckpt_dir)) == ["gen_last.pth", "last.pth", "step_2.pth"]
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert {"loss_disc", "loss_gen", "loss_mel", "loss_adv", "loss_fm"} <= set(lines[0])
    assert all(math.isfinite(r["loss_gen"]) for r in lines)
    again = train_vocoder.main(argv + ["--steps", "4", "--resume"])
    assert again.step == 4

    before = signal.getsignal(signal.SIGTERM)
    batches = pds.WavSegmentDataset.batches

    def interrupted(self, batch_size, steps):
        for i, batch in enumerate(batches(self, batch_size, steps)):
            if i == 1:
                signal.raise_signal(signal.SIGTERM)
            yield batch

    monkeypatch.setattr(pds.WavSegmentDataset, "batches", interrupted)
    os.remove(os.path.join(ckpt_dir, "last.pth"))
    stopped = train_vocoder.main(argv + ["--steps", "50"])
    assert stopped.step == 1
    assert os.path.isfile(os.path.join(ckpt_dir, "preempt.pth"))
    assert torch.load(os.path.join(ckpt_dir, "last.pth"), weights_only=True)["step"] == 1
    assert signal.getsignal(signal.SIGTERM) == before
    with pytest.raises(SystemExit):
        train_vocoder.main(argv + ["--steps", "1", "--segment", "1000"])  # not a hop multiple
    assert train_vocoder.parse_args(["--data", "x", "--n_devices", "2"]).n_devices == 2
