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
