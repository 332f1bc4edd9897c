"""Port vs JAX package: the anti-aliased snake (ops/snake.py). The port's
plain version is held against the JAX polyphase form, the reference
composition, and the TPU kernels K3 (`snake_antialias_pallas`) and K2
(`snake_antialias_fold`) run in Pallas interpret mode, as the JAX
package's own tests run them on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.ops import snake as jsk  # noqa: E402
from dex_tts_tpu_torch.models.vocoder.bigvgan import (  # noqa: E402
    downsample2x_antialias,
    upsample2x_antialias,
)
from dex_tts_tpu_torch.ops import snake as sk  # noqa: E402

SHAPES = [(2, 17, 5), (1, 64, 3), (3, 33, 8), (2, 1, 4), (1, 2, 2)]


def _inputs(b, t, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    al = rng.uniform(0.5, 2.0, (c,)).astype(np.float32)
    ib = rng.uniform(0.5, 2.0, (c,)).astype(np.float32)
    return x, al, ib


def _port(x, al, ib, **kw):
    return sk.snake_antialias(torch.from_numpy(x), torch.from_numpy(al),
                              torch.from_numpy(ib), **kw)


@pytest.mark.parametrize("k", [8, 12, 16, 24])
def test_filters_match_jax(k):
    for cutoff, hw in ((0.25, 0.3), (0.125, 0.15)):
        np.testing.assert_array_equal(sk.kaiser_sinc_filter(cutoff, hw, k),
                                      jsk.kaiser_sinc_filter(cutoff, hw, k))
    assert sk._phase_filters(k) == jsk._phase_filters(k)


def test_sin2_fast_matches_jax():
    t = np.random.default_rng(0).uniform(-200, 200, 50000).astype(np.float32)
    got = sk._sin2_fast(torch.from_numpy(t)).numpy()
    want = np.asarray(jsk._sin2_fast(jnp.asarray(t)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


# f32 against f32: the same sums in another order
@pytest.mark.parametrize("k", [8, 12, 16])
@pytest.mark.parametrize("b,t,c", SHAPES)
def test_plain_matches_jax_polyphase(b, t, c, k):
    x, al, ib = _inputs(b, t, c)
    want = np.asarray(jsk.snake_antialias_polyphase(jnp.asarray(x), jnp.asarray(al),
                                                    jnp.asarray(ib), k))
    got = _port(x, al, ib, kernel_size=k)
    assert got.shape == (b, t, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("b,t,c", SHAPES)
def test_plain_matches_reference_composition(b, t, c):
    """up(2×) → snake → down(2×) built from the port's own resamplers,
    the reference's form (bigvgan/alias_free_torch/act.py)."""
    x, al, ib = _inputs(b, t, c, seed=1)
    xt = torch.from_numpy(x)
    up = upsample2x_antialias(xt)
    assert up.shape == (b, 2 * t, c)
    s = up + torch.from_numpy(ib) * torch.sin(up * torch.from_numpy(al)) ** 2
    want = downsample2x_antialias(s)
    np.testing.assert_allclose(_port(x, al, ib).numpy(), want.numpy(), atol=1e-5)


def test_plain_matches_tpu_kernel_k3_interpret():
    """K3, `_snake_kernel` (f32, exact sine), three T-tiles: both global
    edges and the pure-halo middle."""
    x, al, ib = _inputs(2, 768, 24, seed=2)
    want = np.asarray(jsk.snake_antialias_pallas(jnp.asarray(x), jnp.asarray(al),
                                                 jnp.asarray(ib), interpret=True))
    got = _port(x, al, ib, impl="pallas")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_plain_matches_tpu_kernel_k2_interpret_f32():
    """K2, `_snake_fold_kernel` in f32 (exact sine there too)."""
    x, al, ib = _inputs(1, 4096, 24, seed=3)
    want = np.asarray(jsk.snake_antialias_fold(jnp.asarray(x), jnp.asarray(al),
                                               jnp.asarray(ib), interpret=True))
    got = _port(x, al, ib, impl="fold")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_plain_matches_tpu_kernel_k2_interpret_bf16():
    """K2 as the bf16 generator runs it: bf16 storage, f32 compute, the
    polynomial sin², one rounding. Interior: within one bf16 ulp of
    max|y| (both round the same f32 sums, summed in another order). The
    first and last n_edge samples (dex_tts_tpu/ops/snake.py:483) are
    spliced in by the JAX package from the polyphase form computed in
    bf16, so there the two differ by bf16 arithmetic (bound: 4 ulps of
    max|y|); the port's exact edges are held against the f32 polyphase
    form of the same bf16 inputs instead (half an ulp of rounding plus
    the polynomial's 8.8e-6 · max inv_beta)."""
    b, t, c, k = 1, 4096, 24, 12
    x, al, ib = _inputs(b, t, c, seed=4)
    xb = jnp.asarray(x, jnp.bfloat16)
    alb, ibb = jnp.asarray(al, jnp.bfloat16), jnp.asarray(ib, jnp.bfloat16)
    want = np.asarray(jsk.snake_antialias_fold(xb, alb, ibb, interpret=True, fast_sin=True),
                      np.float32)
    got = sk.snake_antialias(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        torch.from_numpy(np.asarray(alb, np.float32)).to(torch.bfloat16),
        torch.from_numpy(np.asarray(ibb, np.float32)).to(torch.bfloat16), impl="auto",
    )
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    f = jsk._fold_factor(c)
    hl = max(1, -(-(k // 2 - 1) // f))
    hr = hl + -(-(k // 2) // f) + 1
    n_edge = max(k + max(hl, hr) * f, 16)
    inner = slice(n_edge, t - n_edge)
    assert np.abs(got[:, inner] - want[:, inner]).max() <= ulp
    assert np.abs(got - want).max() <= 4 * ulp
    exact = np.asarray(jsk.snake_antialias_polyphase(
        xb.astype(jnp.float32), alb.astype(jnp.float32), ibb.astype(jnp.float32), k))
    for edge in (slice(0, n_edge), slice(t - n_edge, t)):
        err = np.abs(got[:, edge] - exact[:, edge]).max()
        assert err <= ulp / 2 + 8.8e-6 * float(np.asarray(ibb, np.float32).max()) + 1e-6


@pytest.mark.parametrize("impl", [None, "auto", "polyphase", "fold", "foldb", "pallas"])
def test_dispatch_takes_plain_version_on_cpu(impl):
    """Every impl runs the plain version on CPU tensors and launches
    nothing; sin² is the polynomial exactly where the JAX route would be
    the fold kernel with bf16 storage."""
    x, al, ib = _inputs(2, 130, 6, seed=5)
    sk.snake_antialias.launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype).transpose(1, 2).contiguous().transpose(1, 2)
        got = sk.snake_antialias(xt, torch.from_numpy(al), torch.from_numpy(ib), impl=impl)
        fast = dtype == torch.bfloat16 and impl in ("auto", "fold", "foldb")
        want = sk.snake_antialias_reference(xt, torch.from_numpy(al), torch.from_numpy(ib),
                                            fast_sin=fast)
        assert got.dtype == dtype and got.shape == xt.shape
        assert torch.equal(got, want)
    assert sk.snake_antialias.launches == 0


def test_fast_sin_is_a_different_function_in_bf16():
    """The sin² rule is observable: the polynomial and the exact sine
    give different bf16 outputs somewhere on a large input."""
    x, al, ib = _inputs(1, 4096, 8, seed=6)
    xt = torch.from_numpy(x * 30).to(torch.bfloat16)
    args = (torch.from_numpy(al), torch.from_numpy(ib))
    fast = sk.snake_antialias(xt, *args, impl="auto")
    exact = sk.snake_antialias(xt, *args, impl="polyphase")
    assert not torch.equal(fast, exact)
    assert torch.equal(fast, sk.snake_antialias(xt, *args, fast_sin=True))


def test_bf16_output_everywhere_including_edges():
    """bf16 in → bf16 out; every sample, edges included, is the f32
    result rounded once (the JAX fold route could write its spliced
    edges from an f32 computation into a bf16 result)."""
    x, al, ib = _inputs(2, 300, 4, seed=7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = sk.snake_antialias(xb, torch.from_numpy(al), torch.from_numpy(ib), impl="polyphase")
    assert got.dtype == torch.bfloat16
    want = sk.snake_antialias(xb.float(), torch.from_numpy(al).to(torch.bfloat16).float(),
                              torch.from_numpy(ib).to(torch.bfloat16).float())
    assert torch.equal(got, want.to(torch.bfloat16))


def test_rejects_unknown_impl():
    x, al, ib = _inputs(1, 8, 2)
    with pytest.raises(ValueError, match="unknown snake impl"):
        _port(x, al, ib, impl="xla")
