"""Port vs JAX package: the RetNet knobs that no preset sets (the GLU
activation, ``layernorm_eps``, ``use_lm_decay``, ``value_dim``), the
recurrent and chunkwise retention forms, and xPos. f32 throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.models import retention as jret  # noqa: E402
from dex_tts_tpu.models import xpos as jxpos  # noqa: E402
from dex_tts_tpu_torch.convert import _dense, load_numpy_state, retnet_flax_to_torch  # noqa: E402
from dex_tts_tpu_torch.models import retention as pret  # noqa: E402
from dex_tts_tpu_torch.models import xpos as pxpos  # noqa: E402
from tests.test_retention_forms import parallel_reference  # noqa: E402
from tests.torch_port_util import perturb, t  # noqa: E402

ATOL = 1e-4  # the text encoder's own bound (tests/test_torch_encoders.py)
BASE = dict(embed_dim=16, value_dim=16, ffn_dim=24, num_layers=2, num_heads=2,
            dropout=0.1, drop_path_rate=0.1)


def _inputs(seed=0, b=2, tmax=13):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, tmax, 16)).astype(np.float32)
    mask = (np.arange(tmax)[None] < np.asarray([tmax, 8])[:, None]).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("knobs", [
    dict(activation="gelu"),
    dict(activation="relu"),
    dict(activation="swish"),
    dict(layernorm_eps=0.5),
    dict(use_decay=True),
    dict(use_decay=True, use_lm_decay=True),
    dict(use_decay=True, use_lm_decay=True, use_softmax=False, num_heads=4),
], ids=["gelu", "relu", "swish", "eps", "decay", "lm_decay", "lm_decay_normalised"])
def test_encoder_matches_jax(knobs):
    cfg = dict(BASE, **knobs)
    x, mask = _inputs()
    jmod = jret.RetNetEncoder(jret.RetNetEncoderConfig(**cfg))
    params = perturb(jax.tree_util.tree_map(np.asarray, dict(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask)))), scale=0.3)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    state = {}
    retnet_flax_to_torch(params["params"], state, "enc", cfg["num_layers"], False)
    port = pret.RetNetEncoder(pret.RetNetEncoderConfig(**cfg))
    load_numpy_state(port, {k[len("enc."):]: v for k, v in state.items()})
    with torch.no_grad():
        got = port(t(x), t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("use_lm_decay", [False, True])
def test_head_decay_schedules_match_jax(use_lm_decay):
    np.testing.assert_array_equal(pret._head_decay(4, use_lm_decay),
                                  jret._head_decay(4, use_lm_decay))


def test_retention_at_another_value_width_matches_jax():
    """value_dim 24 ≠ embed_dim 16: v and g split by value_dim / heads,
    out_proj value_dim → value_dim, as in the JAX package."""
    cfg = dict(BASE, value_dim=24, use_decay=True)
    x, mask = _inputs(1)
    jcfg = jret.RetNetEncoderConfig(**cfg)
    sin, cos, decay = jret.rel_pos(jcfg, x.shape[1], jnp.asarray(mask))
    jmod = jret.MultiScaleRetention(jcfg)
    params = perturb(jax.tree_util.tree_map(np.asarray, dict(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), sin, cos, decay))), scale=0.3)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), sin, cos, decay))
    assert want.shape == (2, 13, 24)
    state = {}
    for name in ("q", "k", "v", "g", "out"):
        _dense(state, params["params"][f"{name}_proj"], f"{name}_proj")
    port = pret.MultiScaleRetention(pret.RetNetEncoderConfig(**cfg))
    load_numpy_state(port, state)
    psin, pcos, pdecay = pret.rel_pos(pret.RetNetEncoderConfig(**cfg), x.shape[1], t(mask))
    with torch.no_grad():
        got = port(t(x), psin, pcos, pdecay).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encoder_at_another_value_width_raises():
    """The JAX encoder layer fails at its residual add; the port refuses at
    construction, naming both widths."""
    cfg = dict(BASE, value_dim=24)
    x, mask = _inputs()
    with pytest.raises(TypeError, match="incompatible shapes"):
        jret.RetNetEncoder(jret.RetNetEncoderConfig(**cfg)).init(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    with pytest.raises(ValueError, match="value_dim 24.*embed_dim 16"):
        pret.RetNetEncoder(pret.RetNetEncoderConfig(**cfg))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="'tanh'"):
        pret.RetNetEncoder(pret.RetNetEncoderConfig(**dict(BASE, activation="tanh")))


def _qkv(seed, b=2, h=2, t_=17, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t_, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("use_lm_decay", [False, True])
def test_recurrent_retention_matches_jax_and_the_parallel_form(use_lm_decay):
    q, k, v = _qkv(0)
    decay = pret._head_decay(2, use_lm_decay)
    want, want_state = jret.recurrent_retention(*(jnp.asarray(a) for a in (q, k, v, decay)))
    got, state = pret.recurrent_retention(*(t(a) for a in (q, k, v, decay)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), parallel_reference(q, k, v, decay), atol=1e-4,
                               rtol=1e-4)
    assert state.shape == (2, 2, 8, 8)


@pytest.mark.parametrize("t_,chunk", [(50, 16), (48, 16), (17, 64)])
def test_chunkwise_retention_matches_jax_and_the_recurrent_form(t_, chunk):
    """Outputs equal the recurrent form's at any T; the final state only
    where T is a multiple of the chunk (the zero padding decays it), as in
    the JAX package, whose state the port's equals either way."""
    q, k, v = _qkv(1, t_=t_)
    decay = pret._head_decay(2, False)
    want, want_state = jret.chunkwise_retention(*(jnp.asarray(a) for a in (q, k, v, decay)),
                                                chunk_size=chunk)
    got, state = pret.chunkwise_retention(*(t(a) for a in (q, k, v, decay)), chunk_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), atol=1e-4, rtol=1e-4)
    rec, rec_state = pret.recurrent_retention(*(t(a) for a in (q, k, v, decay)))
    np.testing.assert_allclose(got.numpy(), rec.numpy(), atol=1e-4, rtol=1e-4)
    if t_ % chunk == 0:
        np.testing.assert_allclose(state.numpy(), rec_state.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("offset,downscale", [(0, False), (0, True), (4, False), (5, True)])
def test_xpos_matches_jax(offset, downscale):
    x = np.random.default_rng(2).standard_normal((2, 10, 16)).astype(np.float32)
    want = jxpos.XPos(16)(jnp.asarray(x), offset=offset, downscale=downscale)
    got = pxpos.XPos(16)(t(x), offset=offset, downscale=downscale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_xpos_keeps_inner_products_relative():
    """The reference's own self-test property, as tests/test_xpos.py holds
    it for the JAX package: q·k after xPos (k downscaled) depends only on
    the offset between the positions."""
    rng = np.random.default_rng(0)
    xpos = pxpos.XPos(16)
    v = t(rng.standard_normal((1, 6, 16)).astype(np.float32))
    w = t(rng.standard_normal((1, 6, 16)).astype(np.float32))
    s1 = float((xpos(v)[0, 2] * xpos(w, downscale=True)[0, 0]).sum())
    v2, w2 = torch.roll(v, 1, dims=1), torch.roll(w, 1, dims=1)
    s2 = float((xpos(v2)[0, 3] * xpos(w2, downscale=True)[0, 1]).sum())
    np.testing.assert_allclose(s1, s2, rtol=1e-4)


def test_text_encoder_passes_its_width_as_the_value_width():
    from dex_tts_tpu_torch.models.text_encoder import TextEncoder

    enc = TextEncoder(149, n_feats=12, n_channels=16, filter_channels=24,
                      filter_channels_dp=10, n_layers=1)
    cfg = enc.encoder.cfg
    assert cfg.value_dim == cfg.embed_dim == 16
    assert dataclasses.replace(cfg, value_dim=16) == cfg
