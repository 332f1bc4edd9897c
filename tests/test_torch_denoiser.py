"""Port vs JAX package: the DiT middle block (einsum and flash routes) and
the DeX U-Net denoiser with reference statistics and style, in f32 and at
the bf16 compute dtype, with its DiT-cache hooks (return_mid,
mid_override)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.models import dit as jdit  # noqa: E402
from dex_tts_tpu_torch.convert import _dit, dex_tts_flax_to_torch, load_numpy_state  # noqa: E402
from dex_tts_tpu_torch.models import dit as pdit  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from tests.torch_port_util import N_FEATS, build_pair, jax_model, perturb, t, tiny_cfg  # noqa: E402

DIT = dict(in_channels=16, grid_h=3, patch_size=3, stride_size=2, hidden_size=32,
           depth=2, num_heads=2, mlp_ratio=2.0, conv_pos=4, conv_pos_groups=2)


@pytest.mark.parametrize("attention", ["einsum", "flash", "splash_bf16"])
def test_dit_matches_jax(attention):
    cfg = dict(DIT, attention=attention)
    rng = np.random.default_rng(0)
    b, h, w = 2, 6, 23  # W not a multiple of the patch: exercises the pad/crop
    x = rng.standard_normal((b, h, w, 16)).astype(np.float32)
    mask = (np.arange(w)[None] < np.asarray([w, 15])[:, None]).astype(np.float32)
    tt = rng.uniform(-1.5, 1.0, b).astype(np.float32)
    jmod = jdit.DiT(jdit.DiTConfig(**cfg))
    args = (jnp.asarray(x), jnp.asarray(mask[:, None, :, None]), jnp.asarray(tt))
    params = perturb(jax.tree_util.tree_map(np.asarray, dict(jmod.init(jax.random.PRNGKey(0), *args))))
    want = np.asarray(jmod.apply(params, *args))

    state = {}
    _dit(state, params["params"], "vit", cfg["depth"])
    port = pdit.DiT(pdit.DiTConfig(**cfg))
    load_numpy_state(port, {k[len("vit."):]: v for k, v in state.items()})
    with torch.no_grad():
        got = port(t(x.transpose(0, 3, 1, 2)), t(mask[:, None, None, :]), t(tt)).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-4, rtol=1e-3)


def _denoiser_inputs(seed=1, b=2, w=24, ts=9):
    rng = np.random.default_rng(seed)
    mid = 16
    return dict(
        x=rng.standard_normal((b, N_FEATS, w)).astype(np.float32),
        mask=(np.arange(w)[None] < np.asarray([w, 16])[:, None]).astype(np.float32)[:, None],
        mu=rng.standard_normal((b, N_FEATS, w)).astype(np.float32),
        t=rng.uniform(-1.5, 1.0, b).astype(np.float32),
        means=rng.standard_normal((b, 2, mid)).astype(np.float32),
        stds=rng.uniform(0.5, 1.5, (b, 2, mid)).astype(np.float32),
        sty=rng.standard_normal((b, ts, mid)).astype(np.float32),
        sty_lengths=np.asarray([ts, 5], np.int32),
    )


CFG = tiny_cfg(dit=dict(attention="auto", auto_flash_min_tokens=16))


@pytest.fixture(scope="module")
def variables():
    return build_pair(CFG)[1]


def _run_both(cfg, variables, inputs):
    """The denoiser of `cfg` in both frameworks with the same weights (the
    parameter tree does not depend on the compute dtype)."""
    model = jax_model(cfg)
    port = build_tts(cfg)
    load_numpy_state(port, dex_tts_flax_to_torch(variables, cfg))
    i = inputs
    want = jax.jit(lambda v, *a: model.apply(
        v, *a, method=lambda m, x, k, mu, tt, me, sd, s, sl: m.decoder(
            x, k, mu, tt, ref=(me, sd), sty=s, sty_lengths=sl)
    ))(variables, *(jnp.asarray(i[k]) for k in
                    ("x", "mask", "mu", "t", "means", "stds", "sty", "sty_lengths")))
    with torch.no_grad():
        got = port.decoder.denoise_fn(
            t(i["x"]), t(i["mask"]), t(i["mu"]), t(i["t"]), ref=(t(i["means"]), t(i["stds"])),
            sty=t(i["sty"]), sty_lengths=t(i["sty_lengths"], torch.long),
        )
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


def test_dex_denoiser_matches_jax_f32(variables):
    got, want = _run_both(CFG, variables, _denoiser_inputs())
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_dex_denoiser_matches_jax_bf16(variables):
    """bf16 compute: both sides round every conv / matmul output and the
    feature maps to bf16 (half-step 2^-9 ≈ 2e-3 relative), in different
    places and orders, through ~20 rounded layers: up to ~4% of the
    output's scale in the worst case, so the bound is 5% of it."""
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    got, want = _run_both(cfg, variables, _denoiser_inputs(seed=2))
    scale = np.abs(want).max()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.05 * scale, rtol=0)


# f32: as the DeX denoiser's own test; bf16: 5% of the output's scale, as
# there (both sides round ~20 layers to bf16 in different places)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoiser_mid_hooks_match_jax(variables, dtype):
    """``return_mid`` returns the adaptors' + DiT's output in the compute
    dtype, as JAX does; ``mid_override`` runs the conv path around a given
    mid, skipping the adaptors and the DiT (and so the attention)."""
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    model = jax_model(cfg)
    port = build_tts(cfg)
    load_numpy_state(port, dex_tts_flax_to_torch(variables, cfg))
    i = _denoiser_inputs(seed=3)
    names = ("x", "mask", "mu", "t", "means", "stds", "sty", "sty_lengths")

    def jax_run(**kw):
        return jax.jit(lambda v, *a: model.apply(
            v, *a, method=lambda m, x, k, mu, tt, me, sd, s, sl: m.decoder(
                x, k, mu, tt, ref=(me, sd), sty=s, sty_lengths=sl, **kw)
        ))(variables, *(jnp.asarray(i[k]) for k in names))

    def port_run(**kw):
        with torch.no_grad():
            return port.decoder.denoise_fn(
                t(i["x"]), t(i["mask"]), t(i["mu"]), t(i["t"]), ref=(t(i["means"]), t(i["stds"])),
                sty=t(i["sty"]), sty_lengths=t(i["sty_lengths"], torch.long), **kw)

    want_out, want_mid = jax_run(return_mid=True)
    got_out, got_mid = port_run(return_mid=True)
    assert str(got_mid.dtype).removeprefix("torch.") == str(want_mid.dtype) == dtype
    want_mid = np.asarray(want_mid.astype(jnp.float32)).transpose(0, 3, 1, 2)
    got_mid = got_mid.float().numpy()
    tol = dict(atol=1e-4, rtol=1e-3) if dtype == "float32" else {}
    for got, want in ((got_out.numpy(), np.asarray(want_out)), (got_mid, want_mid)):
        if tol:
            np.testing.assert_allclose(got, want, **tol)
        else:
            np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max(), rtol=0)

    # a mid unlike the DiT's own, so the override shows
    mid = (0.5 * want_mid[::-1]).astype(np.float32)
    want = np.asarray(jax_run(mid_override=jnp.asarray(mid.transpose(0, 2, 3, 1))))
    vit = port.decoder.denoise_fn.vit
    vit.forward = lambda *a, **k: pytest.fail("the DiT ran under mid_override")
    got = port_run(mid_override=t(mid)).numpy()
    if tol:
        np.testing.assert_allclose(got, want, **tol)
    else:
        np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max(), rtol=0)
    assert not np.allclose(want, np.asarray(want_out), atol=1e-3)
