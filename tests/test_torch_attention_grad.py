"""The attention backward: the plain version beside the K1 backward
(`attention_bwd_reference`, from the saved f32 log-sum-exp) against
autograd of the plain forward and against `jax.vjp` of the JAX package's
einsum attention (dex_tts_tpu/models/dit.py:356-362), the branch its
flash route falls back to off the TPU, also with dQ summed in the bf16
kernel's order and with the f32 kernels' 3xTF32 arithmetic emulated as
they tile it. The kernels themselves run on the card only
(`chip_smoke.py`); here their wrapper must refuse CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu_torch.ops import attention as att  # noqa: E402
from tests.torch_port_util import matmul_tf32, t  # noqa: E402

SHAPES = [(2, 1, 2, 16), (2, 7, 2, 16), (3, 33, 2, 16), (1, 65, 1, 32)]


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((shape[0], shape[1], 3) + shape[2:]).astype(np.float32)
    do = rng.standard_normal(shape).astype(np.float32)
    return qkv, do


def jax_einsum_attention(q, k, v, dt, precision=None):
    """dex_tts_tpu/models/dit.py:356-362."""
    hd = q.shape[-1]
    scores = jnp.einsum("bthd,bshd->bhts", q, k, preferred_element_type=jnp.float32,
                        precision=precision) * (hd**-0.5)
    weights = jax.nn.softmax(scores, axis=-1).astype(dt)
    return jnp.einsum("bhts,bshd->bthd", weights, v, preferred_element_type=jnp.float32,
                      precision=precision).astype(dt)


def _plain_bwd(qkv, do, dtype):
    q, k, v = (t(qkv[:, :, i]).to(dtype) for i in range(3))
    scale = q.shape[-1] ** -0.5
    out, lse = att.flash_attention(q, k, v, scale, with_lse=True)  # CPU: the plain forward
    return out, att.attention_bwd_reference(q, k, v, out, lse, t(do).to(dtype), scale)


def _bound(want, rel):
    """rel × max|g| per tensor, floored at rel × max|dv| / 10: at T = 1 dq
    and dk are 0 in exact arithmetic, and what is left is the rounding of
    D − dP, terms of dv's size."""
    floor = 0.1 * np.abs(want[2]).max()
    return [rel * max(np.abs(w).max(), floor) for w in want]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd(shape):
    qkv, do = _inputs(shape, seed=shape[1])
    _, got = _plain_bwd(qkv, do, torch.float32)
    leaf = t(qkv).requires_grad_(True)
    scale = shape[-1] ** -0.5
    att.attention_reference(leaf[:, :, 0], leaf[:, :, 1], leaf[:, :, 2], scale).backward(t(do))
    want = [leaf.grad[:, :, i].numpy() for i in range(3)]
    for g, w, b in zip(got, want, _bound(want, 1e-5)):
        np.testing.assert_allclose(g.numpy(), w, atol=b, rtol=0)


# f32: sums in another order only; bf16: P, dS and the outputs rounded to
# bf16 on both sides, at different points (the JAX einsum backward rounds
# dP, not dS, and forms D from P·dP rather than dO·O): 2e-2 × max|g|, the
# bound the card's kernels are held to
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(shape, dtype, rel):
    qkv, do = _inputs(shape, seed=100 + shape[1])
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(qkv[:, :, i]).astype(jdt) for i in range(3))
    out_j, vjp = jax.vjp(lambda q, k, v: jax_einsum_attention(q, k, v, jdt), jq, jk, jv)
    want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do).astype(jdt))]
    out, got = _plain_bwd(qkv, do, getattr(torch, dtype))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(out_j, np.float32),
                               atol=rel * np.abs(np.asarray(out_j, np.float32)).max())
    for g, w, b in zip(got, want, _bound(want, rel)):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(), w, atol=b, rtol=0)


def test_lse_and_delta():
    qkv, do = _inputs((2, 9, 2, 16), seed=3)
    q, k, v = (t(qkv[:, :, i]) for i in range(3))
    out, lse = att.flash_attention(q, k, v, 0.25, with_lse=True)
    scores = torch.einsum("bthd,bshd->bhts", q, k) * 0.25
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1))
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 9)
    delta = att.attention_delta(out, t(do))
    torch.testing.assert_close(delta, (out * t(do)).sum(-1).transpose(1, 2))


def test_qkv_entry_differentiates_on_cpu():
    """The DiT's entry: on the CPU autograd runs through the plain forward
    and gives the same gradient as the plain backward."""
    qkv, do = _inputs((2, 11, 2, 16), seed=4)
    leaf = t(qkv).requires_grad_(True)
    out = att.flash_attention_qkv(leaf, 0.25)
    out.backward(t(do))
    q, k, v = (t(qkv[:, :, i]) for i in range(3))
    o, lse = att.flash_attention(q, k, v, 0.25, with_lse=True)
    want = att.attention_bwd_reference(q, k, v, o, lse, t(do), 0.25)
    for i in range(3):
        torch.testing.assert_close(leaf.grad[:, :, i], want[i], atol=1e-5, rtol=1e-5)


def _blockwise_dq(q, k, v, out, lse, do, scale, block=128):
    """dQ as the bf16 kernel sums it: dS rounded to q's dtype, one f32
    partial dS·K per 128-key block added in turn into an f32 accumulator,
    then scaled and rounded once."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.einsum("bthd,bshd->bhts", qf, kf) * scale - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = (p * (dp - att.attention_delta(out, do)[..., None])).to(q.dtype).float()
    acc = torch.zeros(qf.shape)
    for s0 in range(0, q.shape[1], block):
        acc += torch.einsum("bhts,bshd->bthd", ds[..., s0:s0 + block], kf[:, s0:s0 + block])
    return (acc * scale).to(q.dtype)


# several 128-key blocks, the last one ragged; the bound is the bf16 one
# of test_plain_backward_matches_jax_vjp (the kernel's dQ atomics add the
# blocks in an order that changes from run to run: any order of these f32
# sums stays inside it)
@pytest.mark.parametrize("shape", [(2, 130, 2, 16), (1, 300, 1, 32), (2, 257, 1, 16)])
def test_blockwise_dq_matches_jax_vjp(shape):
    qkv, do = _inputs(shape, seed=200 + shape[1])
    jq, jk, jv = (jnp.asarray(qkv[:, :, i]).astype(jnp.bfloat16) for i in range(3))
    _, vjp = jax.vjp(lambda q, k, v: jax_einsum_attention(q, k, v, jnp.bfloat16), jq, jk, jv)
    want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do).astype(jnp.bfloat16))]
    q, k, v = (t(qkv[:, :, i]).to(torch.bfloat16) for i in range(3))
    tdo = t(do).to(torch.bfloat16)
    scale = shape[-1] ** -0.5
    out, lse = att.flash_attention(q, k, v, scale, with_lse=True)
    dq = _blockwise_dq(q, k, v, out, lse, tdo, scale)
    _, dk, dv = att.attention_bwd_reference(q, k, v, out, lse, tdo, scale)
    for g, w, b in zip((dq, dk, dv), want, _bound(want, 2e-2)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=b, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_refuse_cpu_tensors(dtype):
    qkv, do = _inputs((1, 4, 1, 128), seed=5)
    q, k, v = (t(qkv[:, :, i]).to(dtype) for i in range(3))
    out, lse = att.flash_attention(q, k, v, 0.1, with_lse=True)
    delta = att.attention_delta(out, t(do).to(dtype))
    grads = torch.empty_like(t(qkv).to(dtype))
    before = att.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        att.flash_attention_bwd(q, k, v, t(do).to(dtype), lse, delta, grads[:, :, 0],
                                grads[:, :, 1], grads[:, :, 2], 0.1)
    assert att.flash_attention_bwd.launches == before


LOG2E = 1.4426950408889634


def emulate_flash_bwd_f32(q, k, v, do, lse, delta, scale, products):
    """The arithmetic of csrc/flash_attention.cu's f32 backward on (B, T,
    H, hd) f32 tensors, tiled as its kernels tile it, every product by
    `matmul_tf32`: dQ over 32-key tiles (flash_bwd_dq_f32), dK and dV per
    128-key block over 16-query tiles (flash_bwd_dkv_f32), the rows past T
    of a last tile zero as the pre-pass writes them. P = exp2(S·scale·log2 e
    − lse·log2 e) from the saved lse, keys ≥ T (dQ) and queries ≥ T (dK/dV)
    masked to 0; P and dS stay f32; the scale is applied to the f32 sums.
    → (dq, dk, dv), (B, T, H, hd)."""
    t_len = q.shape[1]
    qh, kh, vh, doh = (a.transpose(1, 2) for a in (q, k, v, do))  # (B, H, T, hd)
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lse2 = lse * LOG2E

    def padded(x, n):  # rows up to a multiple of n, zeros past T
        return torch.nn.functional.pad(x, (0, 0, 0, -(-t_len // n) * n - t_len))

    kp, vp = padded(kh, 32), padded(vh, 32)
    dq = torch.zeros_like(qh)
    for k0 in range(0, kp.shape[2], 32):
        kb, vb = kp[:, :, k0:k0 + 32], vp[:, :, k0:k0 + 32]
        p = torch.exp2(matmul_tf32(qh, kb.transpose(-1, -2), products) * scale_log2
                       - lse2[..., None])
        p[..., torch.arange(k0, k0 + 32) >= t_len] = 0
        dp = matmul_tf32(doh, vb.transpose(-1, -2), products)
        dq = dq + matmul_tf32(p * (dp - delta[..., None]), kb, products)
    qp, dop = padded(qh, 16), padded(doh, 16)
    lse2p, deltap = (torch.nn.functional.pad(a, (0, qp.shape[2] - t_len)) for a in (lse2, delta))
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for k0 in range(0, t_len, 128):
        kb, vb = kh[:, :, k0:k0 + 128], vh[:, :, k0:k0 + 128]
        for q0 in range(0, qp.shape[2], 16):
            qt, dot = qp[:, :, q0:q0 + 16], dop[:, :, q0:q0 + 16]
            pt = torch.exp2(matmul_tf32(kb, qt.transpose(-1, -2), products) * scale_log2
                            - lse2p[:, :, None, q0:q0 + 16])
            pt[..., torch.arange(q0, q0 + 16) >= t_len] = 0
            dpt = matmul_tf32(vb, dot.transpose(-1, -2), products)
            dst = pt * (dpt - deltap[:, :, None, q0:q0 + 16])
            dv[:, :, k0:k0 + 128] += matmul_tf32(pt, dot, products)
            dk[:, :, k0:k0 + 128] += matmul_tf32(dst, qt, products)
    return tuple(a.transpose(1, 2) for a in (dq * scale, dk * scale, dv))


@pytest.mark.parametrize("T", [1, 63, 200])
def test_3xtf32_backward_emulation_matches_jax_vjp(T):
    """The f32 backward kernels' 3xTF32 arithmetic stays within the chip
    gate, 1e-4 × max(max|g|, max|dv| / 10) per gradient, of `jax.vjp` of
    the JAX einsum at HIGHEST precision; one TF32 product per product errs
    at least 10× more (by the gate's measure), which is why the kernels
    split their operands."""
    rng = np.random.default_rng(300 + T)
    qkv = rng.standard_normal((2, T, 3, 2, 128)).astype(np.float32)
    do = rng.standard_normal((2, T, 2, 128)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(qkv[:, :, i]) for i in range(3))
    _, vjp = jax.vjp(lambda q, k, v: jax_einsum_attention(
        q, k, v, jnp.float32, precision=jax.lax.Precision.HIGHEST), jq, jk, jv)
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    q, k, v = (t(qkv[:, :, i]) for i in range(3))
    scale = 128**-0.5
    out, lse = att.flash_attention(q, k, v, scale, with_lse=True)  # CPU: the plain forward
    delta = att.attention_delta(out, t(do))
    bounds = _bound(want, 1e-4)
    worst = {}
    for products in (3, 1):
        got = emulate_flash_bwd_f32(q, k, v, t(do), lse, delta, scale, products)
        worst[products] = max(np.abs(g.numpy() - w).max() / b
                              for g, w, b in zip(got, want, bounds))
    assert worst[3] <= 1.0, worst
    assert worst[1] >= 10 * worst[3] and worst[1] > 0, worst
