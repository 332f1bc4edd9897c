"""Port vs JAX package: the vocoder critics (MPD, MRD) and the GAN losses
(models/vocoder/discriminators.py). The JAX parameters, perturbed so the
zero biases count, carry over through `convert.discriminators_flax_to_torch`
with strict loading; logits, feature maps, the three losses and the
critics' gradients (and the gradient that reaches the generated
waveform) are held against JAX's."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.models.vocoder import discriminators as jd  # noqa: E402
from dex_tts_tpu_torch.convert import discriminators_flax_to_torch, load_numpy_state  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import discriminators as pd  # noqa: E402
from dex_tts_tpu_torch.train.vocoder import build_critics, critic_loss  # noqa: E402
from tests.torch_port_util import perturb, t  # noqa: E402

# periods 3 and 5 do not divide T (reflect padding); two MRD resolutions,
# one with win < n_fft (the zero-padded window)
CFG = dict(mpd_periods=(2, 3, 5), mrd_resolutions=((64, 16, 32), (128, 32, 128)),
           channel_mult=0.125)
B, T = 2, 500
# f32 against f32, convolution sums in another order
ATOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    """(JAX critics, perturbed JAX params {"mpd", "mrd"} as numpy, port
    critics with the same weights, numpy y and y_hat)."""
    jcfg = jd.DiscriminatorConfig(**CFG)
    mpd, mrd = jd.MultiPeriodDiscriminator(jcfg), jd.MultiResolutionDiscriminator(jcfg)
    rng = np.random.default_rng(0)
    y = (0.5 * rng.standard_normal((B, T))).astype(np.float32)
    y_hat = (0.5 * rng.standard_normal((B, T))).astype(np.float32)
    params = {"mpd": jax.jit(mpd.init)(jax.random.PRNGKey(1), y, y_hat)["params"],
              "mrd": jax.jit(mrd.init)(jax.random.PRNGKey(2), y, y_hat)["params"]}
    params = perturb(jax.tree_util.tree_map(np.asarray, params), seed=3)
    port = build_critics(pd.DiscriminatorConfig(**CFG))
    load_numpy_state(port, discriminators_flax_to_torch(params, pd.DiscriminatorConfig(**CFG)))
    return (mpd, mrd), params, port, y, y_hat


def _nchw(fmap):
    return np.transpose(np.asarray(fmap), (0, 3, 1, 2))  # flax NHWC → torch NCHW


@pytest.mark.parametrize("critic", ["mpd", "mrd"])
def test_logits_and_feature_maps_match_jax(pair, critic):
    (mpd, mrd), params, port, y, y_hat = pair
    jmod = mpd if critic == "mpd" else mrd
    want = jmod.apply({"params": params[critic]}, y, y_hat)
    with torch.no_grad():
        got = port[critic](t(y), t(y_hat))
    n_sub = len(CFG["mpd_periods"] if critic == "mpd" else CFG["mrd_resolutions"])
    for logits_got, logits_want in zip(got[:2], want[:2]):
        assert len(logits_got) == len(logits_want) == n_sub
        for g, w in zip(logits_got, logits_want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=1e-5)
    for fmaps_got, fmaps_want in zip(got[2:], want[2:]):
        for sub_got, sub_want in zip(fmaps_got, fmaps_want):
            assert len(sub_got) == len(sub_want) == 6
            for g, w in zip(sub_got, sub_want):
                np.testing.assert_allclose(g.numpy(), _nchw(w), atol=ATOL, rtol=1e-5)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    outs = [[rng.standard_normal((B, n)).astype(np.float32) for n in (7, 3, 11)]
            for _ in range(2)]
    fmaps = [[[rng.standard_normal((B, 2, n, 3)).astype(np.float32) for n in (5, 4)]
              for _ in range(3)] for _ in range(2)]
    tt = lambda tree: [[t(a) for a in sub] for sub in tree]  # noqa: E731
    got, want = pd.discriminator_loss(*[[t(a) for a in o] for o in outs]), \
        jd.discriminator_loss(*outs)
    assert math.isclose(got[0].item(), float(want[0]), rel_tol=1e-6)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert math.isclose(g.item(), float(w), rel_tol=1e-6)
    got, want = pd.generator_loss([t(a) for a in outs[1]]), jd.generator_loss(outs[1])
    assert math.isclose(got[0].item(), float(want[0]), rel_tol=1e-6)
    assert [round(g.item(), 5) for g in got[1]] == [round(float(w), 5) for w in want[1]]
    got = pd.feature_loss(tt(fmaps[0]), tt(fmaps[1])).item()
    assert math.isclose(got, float(jd.feature_loss(*fmaps)), rel_tol=1e-6)


def test_critic_gradients_match_jax(pair):
    """The critics' LSGAN objective (JAX train step's ``disc_loss_fn``):
    its value and every critic parameter's gradient; and the generator's
    adversarial + feature-matching objective's gradient with respect to
    the generated waveform."""
    (mpd, mrd), params, port, y, y_hat = pair

    def disc_loss_fn(dp, fake):
        r_p, f_p, _, _ = mpd.apply({"params": dp["mpd"]}, y, fake)
        r_r, f_r, _, _ = mrd.apply({"params": dp["mrd"]}, y, fake)
        return jd.discriminator_loss(r_p, f_p)[0] + jd.discriminator_loss(r_r, f_r)[0]

    def adv_fm_fn(fake, dp):
        _, f_p, fr_p, fg_p = mpd.apply({"params": dp["mpd"]}, y, fake)
        _, f_r, fr_r, fg_r = mrd.apply({"params": dp["mrd"]}, y, fake)
        return (jd.generator_loss(f_p)[0] + jd.generator_loss(f_r)[0]
                + jd.feature_loss(fr_p, fg_p) + jd.feature_loss(fr_r, fg_r))

    want_loss, want_grads = jax.jit(jax.value_and_grad(disc_loss_fn))(params, y_hat)
    want_grads = discriminators_flax_to_torch(jax.tree_util.tree_map(np.asarray, want_grads),
                                              pd.DiscriminatorConfig(**CFG))
    port.zero_grad(set_to_none=True)
    loss = critic_loss(port, t(y), t(y_hat))
    loss.backward()
    assert math.isclose(loss.item(), float(want_loss), rel_tol=1e-5)
    top = max(np.abs(g).max() for g in want_grads.values())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name],
                                   atol=1e-4 * (np.abs(want_grads[name]).max() + 1e-3 * top),
                                   rtol=0, err_msg=name)

    want_dfake = np.asarray(jax.jit(jax.grad(adv_fm_fn))(jnp.asarray(y_hat), params))
    fake = t(y_hat).requires_grad_(True)
    _, f_p, fr_p, fg_p = port["mpd"](t(y), fake)
    _, f_r, fr_r, fg_r = port["mrd"](t(y), fake)
    (pd.generator_loss(f_p)[0] + pd.generator_loss(f_r)[0] + pd.feature_loss(fr_p, fg_p)
     + pd.feature_loss(fr_r, fg_r)).backward()
    np.testing.assert_allclose(fake.grad.numpy(), want_dfake,
                               atol=1e-4 * np.abs(want_dfake).max(), rtol=0)


def test_init_is_flax_default_and_names_map():
    """Truncated-normal LeCun kernels (std 1/sqrt(fan_in), cut at 2 std of
    the untruncated normal), zero biases; the converter's names are the
    module's, one to one."""
    cfg = pd.DiscriminatorConfig()
    torch.manual_seed(0)
    critics = build_critics(cfg)
    conv = critics["mpd"].p2.conv_2  # 128 → 512, (5, 1)
    fan_in = 128 * 5
    w = conv.weight.detach().numpy()
    assert conv.weight.shape == (512, 128, 5, 1)
    assert abs(w.std() * math.sqrt(fan_in) - 1.0) < 0.02
    assert np.abs(w).max() <= 2 / 0.87962566103423978 / math.sqrt(fan_in) + 1e-7
    assert all(not torch.any(m.bias) for m in critics.modules() if isinstance(m, torch.nn.Conv2d))
    shapes = {k: np.zeros(tuple(v.shape[2:]) + (v.shape[1], v.shape[0]), np.float32)
              for k, v in critics.state_dict().items() if k.endswith("weight")}
    flax_like = {}
    for key, kernel in shapes.items():
        critic, sub, conv_name, _ = key.split(".")
        flax_like.setdefault(critic, {}).setdefault(sub, {})[conv_name] = {
            "kernel": kernel, "bias": np.zeros(kernel.shape[-1], np.float32)}
    assert set(discriminators_flax_to_torch(flax_like, cfg)) == set(critics.state_dict())
