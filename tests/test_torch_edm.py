"""Port vs JAX package: EDM schedules (exact), preconditioning and the
euler / heun samplers on a toy denoiser."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.models import edm as jedm  # noqa: E402
from dex_tts_tpu_torch.models import edm as pedm  # noqa: E402
from tests.torch_port_util import t  # noqa: E402

SCHEDULES = [
    dict(),
    dict(num_steps=7, solver="heun"),
    dict(num_steps=5, discretization="vp", schedule="vp", scaling="vp"),
    dict(num_steps=6, discretization="ve", schedule="ve"),
    dict(num_steps=9, discretization="iddpm"),
    dict(num_steps=4, s_churn=10.0, s_min=0.05, s_max=50.0),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_build_schedule_exact(kw):
    want = jedm.build_schedule(jedm.SamplerConfig(**kw))
    got = pedm.build_schedule(pedm.SamplerConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sampler_config_fields_match():
    port = {f.name: f.default for f in dataclasses.fields(pedm.SamplerConfig)}
    jax_ = {f.name: f.default for f in dataclasses.fields(jedm.SamplerConfig)}
    assert port == jax_


def test_precond_scalings_match():
    sigma = np.asarray([0.002, 0.3, 1.0, 80.0], np.float32)
    want = jedm.edm_precond_scalings(jnp.asarray(sigma))
    got = pedm.edm_precond_scalings(t(sigma))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


W = np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32) * 0.5


def jax_toy(x, t_):
    return jnp.tanh(jnp.einsum("ij,bjw->biw", W, x) + t_[:, None, None])


def port_toy(x, t_):
    return torch.tanh(torch.einsum("ij,bjw->biw", t(W), x) + t_[:, None, None])


@pytest.mark.parametrize("solver,steps", [("euler", 2), ("euler", 10), ("heun", 6)])
def test_sampler_matches_jax(solver, steps):
    latents = np.random.default_rng(1).standard_normal((2, 4, 8)).astype(np.float32)
    want = jedm.ablation_sampler(
        jax.random.PRNGKey(0), jax_toy, jnp.asarray(latents),
        jedm.SamplerConfig(num_steps=steps, solver=solver),
    )
    got = pedm.ablation_sampler(
        port_toy, t(latents), pedm.SamplerConfig(num_steps=steps, solver=solver)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_churn_noise_comes_from_the_generator():
    latents = t(np.random.default_rng(2).standard_normal((2, 4, 8)).astype(np.float32))
    cfg = pedm.SamplerConfig(num_steps=4, s_churn=10.0, s_min=0.05, s_max=50.0)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return pedm.ablation_sampler(port_toy, latents, cfg, generator=g)

    plain = pedm.ablation_sampler(port_toy, latents, pedm.SamplerConfig(num_steps=4))
    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.equal(run(0), run(1))
    assert not torch.equal(run(0), plain)


@pytest.mark.parametrize("kw", SCHEDULES + [dict(num_steps=2), dict(num_steps=3)])
def test_build_dpmpp2m_schedule_exact(kw):
    want = jedm.build_dpmpp2m_schedule(jedm.SamplerConfig(**kw))
    got = pedm.build_dpmpp2m_schedule(pedm.SamplerConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dpmpp2m_first_order_at_two_steps():
    """num_steps ≤ 2: every step first order, and the last ratio 0, so the
    last step returns the denoised estimate itself."""
    sched = pedm.build_dpmpp2m_schedule(pedm.SamplerConfig(num_steps=2))
    np.testing.assert_array_equal(sched["c1"], [1, 1])
    np.testing.assert_array_equal(sched["c2"], [0, 0])
    assert sched["ratio"][-1] == 0 and sched["cd"][-1] == 1


@pytest.mark.parametrize("steps", [2, 3, 16])
def test_dpmpp2m_matches_jax(steps):
    latents = np.random.default_rng(3).standard_normal((2, 4, 8)).astype(np.float32)
    want = jedm.ablation_sampler(
        jax.random.PRNGKey(0), jax_toy, jnp.asarray(latents),
        jedm.SamplerConfig(num_steps=steps, solver="dpmpp2m"),
    )
    got = pedm.ablation_sampler(
        port_toy, t(latents), pedm.SamplerConfig(num_steps=steps, solver="dpmpp2m")
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# a toy denoiser split like the U-Net: a "DiT" part whose output mid is
# kept, and a "conv" part that takes x, t and mid
W2 = np.random.default_rng(4).standard_normal((4, 4)).astype(np.float32) * 0.5


def jax_mid(x, t_):
    mid = jnp.tanh(jnp.einsum("ij,bjw->biw", W2, x) * t_[:, None, None])
    return jax_toy(x, t_) + 0.5 * mid, mid


def jax_cached(x, t_, mid=None):
    return jax_toy(x, t_) + 0.5 * mid


def port_mid(x, t_):
    mid = torch.tanh(torch.einsum("ij,bjw->biw", t(W2), x) * t_[:, None, None])
    return port_toy(x, t_) + 0.5 * mid, mid


@pytest.mark.parametrize("steps,k", [(4, 2), (10, 5)])
def test_dit_cache_sampler_matches_jax(steps, k):
    latents = np.random.default_rng(5).standard_normal((2, 4, 8)).astype(np.float32)
    cfg = dict(num_steps=steps, dit_cache_interval=k)
    want = jedm.ablation_sampler(
        jax.random.PRNGKey(0), lambda *a: pytest.fail("exact step"), jnp.asarray(latents),
        jedm.SamplerConfig(**cfg), denoise_fn_mid=jax_mid, denoise_fn_cached=jax_cached,
    )
    calls = {"mid": 0, "cached": 0}

    def mid_fn(x, t_):
        calls["mid"] += 1
        return port_mid(x, t_)

    def cached_fn(x, t_, mid=None):
        calls["cached"] += 1
        return port_toy(x, t_) + 0.5 * mid

    got = pedm.ablation_sampler(
        lambda *a: pytest.fail("the cache ran an exact step"), t(latents),
        pedm.SamplerConfig(**cfg), denoise_fn_mid=mid_fn, denoise_fn_cached=cached_fn,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert calls == {"mid": steps // k, "cached": steps - steps // k}
    exact = pedm.ablation_sampler(lambda x, t_: port_mid(x, t_)[0], t(latents),
                                  pedm.SamplerConfig(num_steps=steps))
    assert not torch.equal(got, exact)


INVALID = [
    dict(solver="ddim"),
    dict(num_steps=4, solver="dpmpp2m", scaling="vp", schedule="vp", discretization="vp"),
    dict(num_steps=4, solver="dpmpp2m", s_churn=1.0),
    dict(num_steps=4, solver="dpmpp2m", dit_cache_interval=2),
    dict(num_steps=4, solver="heun", dit_cache_interval=2),
    dict(num_steps=4, dit_cache_interval=2, s_churn=1.0),
    dict(num_steps=5, dit_cache_interval=2),
    dict(num_steps=4, dit_cache_interval=2, hooks=False),
]


@pytest.mark.parametrize("kw", INVALID)
def test_invalid_sampler_raises_like_jax(kw):
    kw = dict(kw)
    hooks = kw.pop("hooks", True)
    latents = np.zeros((1, 4, 8), np.float32)
    jhooks = dict(denoise_fn_mid=jax_mid, denoise_fn_cached=jax_cached) if hooks else {}
    phooks = dict(denoise_fn_mid=port_mid, denoise_fn_cached=port_toy) if hooks else {}
    with pytest.raises(ValueError) as want:
        jedm.ablation_sampler(jax.random.PRNGKey(0), jax_toy, jnp.asarray(latents),
                              jedm.SamplerConfig(**kw), **jhooks)
    with pytest.raises(ValueError) as got:
        pedm.ablation_sampler(port_toy, t(latents), pedm.SamplerConfig(**kw), **phooks)
    assert str(got.value) == str(want.value)
