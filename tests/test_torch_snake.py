"""Port vs JAX package: the anti-aliased snake (ops/snake.py). The port's
plain version is held against the JAX polyphase form, the reference
composition, and the TPU kernels K3 (`snake_antialias_pallas`) and K2
(`snake_antialias_fold`) run in Pallas interpret mode, as the JAX
package's own tests run them on the CPU."""

import re
from pathlib import Path

import jax
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


# --- the kernel's schedule (csrc/snake.cu), emulated on the CPU ----------
#
# A numpy f32 emulation that follows the kernel step by step: a row cut
# into chunks of 32 lanes × RUN outputs, chunks split evenly into
# segments of at most SEGMENT_CHUNKS, one warp per segment; the lane with
# outputs [t, t+RUN) snakes positions [t+q, t+RUN+q) from x[t, t+RUN+2q),
# on the branch-free path (whole 16-byte loads of its run and the next)
# or the clipped path (clamped loads, s1[T-1] at positions ≥ T); the
# downsample reads the last 2q / 2q-1 snaked values of the lane before
# (np.roll over the lane axis), lane 0 those of lane 31 of the chunk
# before (carried); a segment's first carry is computed again with the
# edge rule. fmaf is emulated in f64 (exact product), sin² is the
# kernel's polynomial or the exact sine, one rounding at the end.

CSRC = Path(sk.__file__).resolve().parent.parent / "csrc" / "snake.cu"
LANES = np.arange(32)
# T on each boundary of the schedule: q, RUN ± 1, a chunk (one warp's
# span per step) ± 1, a segment (SEGMENT_CHUNKS chunks) ± 1, and the
# smallest rows
BOUNDARY_T = [1, 2, 3, 7, 8, 9, 255, 256, 257, 4095, 4096, 4097]


def test_schedule_constants_match_the_kernel_source():
    src = CSRC.read_text()
    consts = {m.group(1): int(m.group(2))
              for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kRun"] == sk.RUN and consts["kSegChunks"] == sk.SEGMENT_CHUNKS
    assert sk.CHUNK == 32 * sk.RUN
    assert "constexpr int kChunk = 32 * kRun;" in src
    assert consts["kMargin"] == sk.RUN and consts["kMaxHalf"] == 8  # the next run, whole


def _fma(a, b, c):
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(np.float32)


def _sin2_poly(t):
    """The kernel's sin2_poly: _sin2_fast's order, Horner steps fused."""
    v = (t * np.float32(0.3183098861837907)).astype(np.float32)
    v = (v - np.rint(v)).astype(np.float32)
    z = (v * v).astype(np.float32)
    c = np.full_like(z, np.float32(jsk._SIN2_COEF[-1]))
    for a in jsk._SIN2_COEF[-2::-1]:
        c = _fma(c, z, np.float32(a))
    return _fma(np.float32(-0.5), c, np.float32(0.5))


class _Row:
    """One (b, c) row as one warp after another walks it."""

    def __init__(self, x, al, ib, k, fast_sin, vec):
        self.x, self.n, self.k, self.q = x, len(x), k, k // 4
        self.al, self.ib, self.fast_sin, self.vec = np.float32(al), np.float32(ib), fast_sin, vec
        self.f0, self.f1, self.ge, self.go = (np.asarray(v, np.float32)
                                              for v in sk._phase_filters(k))

    def snake(self, p):
        t = (p * self.al).astype(np.float32)
        s2 = _sin2_poly(t) if self.fast_sin else (np.sin(t) ** 2).astype(np.float32)
        return _fma(self.ib, s2, p)

    def x_at(self, i):
        return self.x[np.clip(i, 0, self.n - 1)]

    def phases(self, xw, o):
        """p0, p1 → both snaked phases from xw[..., m] = x[t - q + m]."""
        p0 = p1 = np.zeros(xw.shape[:-1], np.float32)
        for a in range(self.k // 2):
            p0 = _fma(self.f0[a], xw[..., o + a], p0)
            p1 = _fma(self.f1[a], xw[..., o + a + 1], p1)
        return self.snake(p0), self.snake(p1)

    def pair_at(self, s):
        """(s̃0, s̃1) at positions s, with the reference's edge rule."""
        sc = np.clip(s, 0, self.n - 1)
        xw = self.x_at(sc[:, None] - self.q + np.arange(self.k // 2 + 1)[None, :])
        v0, v1 = self.phases(xw, 0)
        v1 = np.where(s < 0, v0, v1)
        v0 = np.where(s > self.n - 1, v1, v0)
        return v0, v1

    def snake_chunk(self, j):
        """Each lane's snaked values at [t+q, t+RUN+q), (32, RUN) each."""
        q, r = self.q, sk.RUN
        t = j * sk.CHUNK + LANES * r  # each lane's run of outputs
        idx = t[:, None] + np.arange(r + 2 * q)[None, :]
        if self.vec and (j + 1) * sk.CHUNK + 8 <= self.n:  # branch-free
            assert t.max() + 2 * r <= self.n  # the run's and the next run's loads
            xw = self.x[idx]
            s0, s1 = zip(*(self.phases(xw, o) for o in range(r)))
            return np.stack(s0, 1), np.stack(s1, 1)
        xw = self.x_at(idx)
        s0, s1 = (np.stack(v, 1) for v in zip(*(self.phases(xw, o) for o in range(r))))
        if (j + 1) * sk.CHUNK + q > self.n:
            s_hi = self.pair_at(np.array([self.n - 1]))[1][0]
            beyond = t[:, None] + q + np.arange(r)[None, :] >= self.n
            s0, s1 = np.where(beyond, s_hi, s0), np.where(beyond, s_hi, s1)
        return s0, s1

    def walk(self, j0, j1, y):
        q, r = self.q, sk.RUN
        lane0 = (LANES == 0)[:, None]
        v0, v1 = self.pair_at(j0 * sk.CHUNK - q + LANES)  # lane 0's carry into chunk j0
        carry1 = np.broadcast_to(v1[: 2 * q], (32, 2 * q))
        carry0 = np.broadcast_to(v0[1 : 2 * q], (32, 2 * q - 1))
        for j in range(j0, j1):
            s0, s1 = self.snake_chunk(j)
            tr1 = np.roll(s1[:, r - 2 * q :], 1, axis=0)  # from lane - 1; lane 0: lane 31's
            tr0 = np.roll(s0[:, r - 2 * q + 1 :], 1, axis=0)
            w1 = np.concatenate([np.where(lane0, carry1, tr1), s1[:, : r - 1]], 1)  # s̃1[t-q+m]
            w0 = np.concatenate([np.where(lane0, carry0, tr0), s0], 1)  # s̃0[t-q+1+m]
            out = np.zeros((32, r), np.float32)
            for o in range(r):
                acc = np.zeros(32, np.float32)
                for a in range(self.k // 2):
                    acc = _fma(self.ge[a], w1[:, o + a], acc)
                    acc = _fma(self.go[a], w0[:, o + a], acc)
                out[:, o] = acc
            t = j * sk.CHUNK + LANES[:, None] * r + np.arange(r)[None, :]
            keep = t < self.n
            y[t[keep]] = out[keep]
            carry1, carry0 = tr1, tr0


def emulate_kernel(x, al, ib, k=12, fast_sin=False, vec=True):
    """The kernel's output for x (B, T, C) f32 (in the storage dtype's
    values), in f32 before the final rounding."""
    b, t, c = x.shape
    n_chunks = -(-t // sk.CHUNK)
    n_segs = -(-n_chunks // sk.SEGMENT_CHUNKS)
    y = np.zeros((b, t, c), np.float32)
    for bi in range(b):
        for ci in range(c):
            row = _Row(x[bi, :, ci], al[ci], ib[ci], k, fast_sin, vec)
            out = np.full(t, np.nan, np.float32)
            for seg in range(n_segs):  # one warp each
                row.walk(seg * n_chunks // n_segs, (seg + 1) * n_chunks // n_segs, out)
            y[bi, :, ci] = out
    assert np.isfinite(y).all()
    return y


def _jax_polyphase_fast(x, al, ib, k):
    """JAX's polyphase form with the JAX package's polynomial sin²."""
    q = k // 4
    f0, f1, ge, go = jsk._phase_filters(k)
    t = x.shape[1]
    xe = jnp.concatenate([jnp.repeat(x[:, :1], q, axis=1), x,
                          jnp.repeat(x[:, -1:], q, axis=1)], axis=1)
    p0 = jsk._depthwise_conv(xe[:, : t + k // 2 - 1], f0, 1)
    p1 = jsk._depthwise_conv(xe[:, 1 : t + k // 2], f1, 1)
    s0 = p0 + ib * jsk._sin2_fast(p0 * al)
    s1 = p1 + ib * jsk._sin2_fast(p1 * al)
    left, right = jnp.repeat(s0[:, :1], q, axis=1), jnp.repeat(s1[:, -1:], q, axis=1)
    s0p = jnp.concatenate([left, s0, right], axis=1)
    s1p = jnp.concatenate([left, s1, right], axis=1)
    return (jsk._depthwise_conv(s1p[:, : t + k // 2 - 1], ge, 1)
            + jsk._depthwise_conv(s0p[:, 1 : t + k // 2], go, 1))


@pytest.mark.parametrize("k", [8, 12, 16])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("t", BOUNDARY_T)
def test_schedule_emulation_matches_jax_at_boundaries(t, c, k):
    """Both sines, f32, against JAX's polyphase form (exact sine: the
    package's own; polynomial: its `_sin2_fast` in the same form), on
    the branch-free and the strided schedule. atol 2e-5."""
    x, al, ib = _inputs(1, t, c, seed=t + 7 * c + k)
    x = 3 * x  # reach the sine's second period
    args = [jnp.asarray(v) for v in (x, al, ib)]
    exact = np.asarray(jsk.snake_antialias_polyphase(*args, k))
    fast = np.asarray(_jax_polyphase_fast(*args, k))
    for fast_sin, want in ((False, exact), (True, fast)):
        for vec in (True, False):
            got = emulate_kernel(x, al, ib, k, fast_sin, vec)
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("k", [8, 12, 16])
@pytest.mark.parametrize("c", [1, 3])
def test_schedule_emulation_matches_tpu_kernels_interpret(c, k):
    """The TPU kernels in Pallas interpret mode, at the T they take that
    fall on the schedule's boundaries: one chunk (256), one segment
    (4096), two segments (8192).
    - K3 (`snake_antialias_pallas`, exact sine), f32: atol 2e-5.
    - K2 (`snake_antialias_fold`, polynomial sin²) on bf16 inputs: with
      f32 storage (the kernel's arithmetic, one rounding fewer) atol
      2e-5; with bf16 storage, the emulation rounded once to bf16 within
      4 bf16 ulps of max|y|, the bound this file holds the fold's bf16
      output to: its interpret run on the CPU differs from its own f32
      storage run by up to 2 ulps of |y| (at |y| ≈ 1.4), so the card's
      8e-3 × max|y| is not a bound on the JAX side."""
    for t in (256, 4096):
        x, al, ib = _inputs(1, t, c, seed=t + c + k)
        want = np.asarray(jsk.snake_antialias_pallas(
            jnp.asarray(x), jnp.asarray(al), jnp.asarray(ib), kernel_size=k, interpret=True))
        np.testing.assert_allclose(emulate_kernel(x, al, ib, k), want, atol=2e-5, rtol=0)
    for t in (4096, 8192):
        x, al, ib = _inputs(1, t, c, seed=t + c + k + 1)
        xb, alb, ibb = (jnp.asarray(v, jnp.bfloat16) for v in (x, al, ib))
        f32 = [np.asarray(v, np.float32) for v in (xb, alb, ibb)]
        got = emulate_kernel(*f32, k, fast_sin=True)
        want_f32 = np.asarray(jsk.snake_antialias_fold(
            *(jnp.asarray(v) for v in f32), kernel_size=k, interpret=True, fast_sin=True))
        np.testing.assert_allclose(got, want_f32, atol=2e-5, rtol=0)
        want = np.asarray(jsk.snake_antialias_fold(xb, alb, ibb, kernel_size=k, interpret=True,
                                                   fast_sin=True), np.float32)
        got = np.asarray(jnp.asarray(got).astype(jnp.bfloat16), np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= 4 * ulp



# --- gradients: the plain version under autograd, and the kernel's
# autograd Function (kernel forward, plain backward) ---------------------


def _grads(fn, x, al, ib, dy):
    ins = [v.detach().clone().requires_grad_(True) for v in (x, al, ib)]
    fn(*ins).backward(dy)
    return [v.grad for v in ins]


@pytest.mark.parametrize("b,t,c", [(2, 300, 8), (1, 5, 3)])
def test_plain_gradients_match_jax_vjp_f32(b, t, c):
    x, al, ib = _inputs(b, t, c, seed=8)
    dy = np.random.default_rng(9).standard_normal((b, t, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jsk.snake_antialias_polyphase(*a, 12),
                     jnp.asarray(x), jnp.asarray(al), jnp.asarray(ib))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    got = _grads(lambda *a: sk.snake_antialias_reference(*a, 12), torch.from_numpy(x),
                 torch.from_numpy(al), torch.from_numpy(ib), torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


def test_plain_gradients_match_jax_vjp_bf16():
    """bf16 inputs and output gradient: the plain version differentiates
    in f32 and rounds each gradient once to bf16, so it lies within half
    a bf16 ulp (of the largest) of JAX's f32 vjp on the same bf16 values;
    JAX's vjp in bf16 arithmetic (`_snake_bwd` on bf16 residuals) within
    4 ulps."""
    b, t, c = 2, 300, 8
    x, al, ib = _inputs(b, t, c, seed=10)
    dy = np.random.default_rng(11).standard_normal((b, t, c)).astype(np.float32)
    bf = [jnp.asarray(v, jnp.bfloat16) for v in (x, al, ib, dy)]
    as_f32 = [np.asarray(v, np.float32) for v in bf]
    f = lambda *a: jsk.snake_antialias_polyphase(*a, 12)  # noqa: E731
    _, vjp = jax.vjp(f, *[jnp.asarray(v) for v in as_f32[:3]])
    exact = [np.asarray(g) for g in vjp(jnp.asarray(as_f32[3]))]
    _, vjp = jax.vjp(f, *bf[:3])
    in_bf16 = [np.asarray(g, np.float32) for g in vjp(bf[3])]
    got = _grads(lambda *a: sk.snake_antialias_reference(*a, 12),
                 *[torch.from_numpy(v).to(torch.bfloat16) for v in as_f32])
    for g, e, w in zip(got, exact, in_bf16):
        assert g.dtype == torch.bfloat16
        top = np.abs(e).max()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert np.abs(g.float().numpy() - e).max() <= ulp / 2 + 1e-5 * top
        assert np.abs(g.float().numpy() - w).max() <= 4 * ulp


@pytest.mark.parametrize("dtype,fast", [(torch.float32, False), (torch.bfloat16, True)])
def test_kernel_function_backward_is_the_plain_version(monkeypatch, dtype, fast):
    """`SnakeKernelFunction` with the launch replaced by the plain version
    (no card here): one launch per forward and none in the backward; the
    gradients, back to BigVGAN's logscale parameters through ``exp`` and
    `per_channel`, are bit-equal to autograd through the plain version with
    the exact sine, as JAX's ``_snake_bwd`` differentiates the exact form
    even after the polynomial forward."""
    launched = []

    def launch(x, alpha, inv_beta, k, fast_sin):
        launched.append(fast_sin)
        return sk.snake_antialias_reference(x, alpha, inv_beta, k, fast_sin)

    monkeypatch.setattr(sk, "_launch", launch)
    rng = np.random.default_rng(12)
    x0 = torch.from_numpy(rng.standard_normal((2, 8, 40)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((2, 40, 8)).astype(np.float32)).to(dtype)

    def run(via_function):
        x = x0.clone().requires_grad_(True)
        log_alpha = torch.nn.Parameter(torch.from_numpy(0.3 * rng.standard_normal(8)
                                                        .astype(np.float32)))
        log_beta = torch.nn.Parameter(log_alpha.detach() * 0.5)
        xt = x.transpose(1, 2)  # BigVGAN's (B, T, C) view of (B, C, T)
        al = sk.per_channel(torch.exp(log_alpha).to(dtype), xt)
        ib = sk.per_channel((1.0 / (torch.exp(log_beta) + 1e-9)).to(dtype), xt)
        if via_function:
            y = sk.SnakeKernelFunction.apply(xt, al, ib, 12, fast)
        else:
            y = sk.snake_antialias_reference(xt, al, ib, 12, False)
        y.backward(dy)
        return [v.grad for v in (x, log_alpha, log_beta)]

    rng = np.random.default_rng(13)
    want = run(False)
    rng = np.random.default_rng(13)
    got = run(True)
    assert launched == [fast]  # the forward only
    for g, w in zip(got, want):
        assert g is not None and torch.equal(g, w)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0
