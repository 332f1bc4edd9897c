"""Port vs JAX package: the DiT attention (plain version of the Hopper
kernel, MHSA routing, mode selection). The kernel itself is held against
the plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.models import dit as jdit  # noqa: E402
from dex_tts_tpu_torch.models import dit as pdit  # noqa: E402
from dex_tts_tpu_torch.ops.attention import (  # noqa: E402
    attention_reference,
    flash_attention,
    tensor_map_layout,
)
from tests.torch_port_util import t  # noqa: E402


def jax_einsum_attention(q, k, v, dt=jnp.float32, precision=None):
    """The JAX MHSA einsum branch (dit.py:356-362) on (B, T, H, hd)."""
    hd = q.shape[-1]
    scores = jnp.einsum("bthd,bshd->bhts", q, k, preferred_element_type=jnp.float32,
                        precision=precision) * (hd**-0.5)
    weights = jax.nn.softmax(scores, axis=-1).astype(dt)
    return jnp.einsum("bhts,bshd->bthd", weights, v, preferred_element_type=jnp.float32,
                      precision=precision).astype(dt)


@pytest.mark.parametrize("T", [7, 64, 777])
def test_attention_reference_matches_jax_einsum(T):
    rng = np.random.default_rng(T)
    qkv = rng.standard_normal((2, T, 3, 2, 128)).astype(np.float32)
    q, k, v = (qkv[:, :, i] for i in range(3))
    want = np.asarray(jax_einsum_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = attention_reference(t(q), t(k), t(v), 128**-0.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_flash_attention_cpu_takes_plain_version_on_strided_views():
    rng = np.random.default_rng(1)
    qkv = t(rng.standard_normal((2, 50, 3, 2, 128)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = flash_attention.launches
    got = flash_attention(q, k, v, 128**-0.5)
    assert flash_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, attention_reference(q, k, v, 128**-0.5), rtol=0, atol=0)
    assert got.is_contiguous() and got.shape == (2, 50, 2, 128)


def test_mhsa_auto_matches_jax_at_flash_token_counts():
    cfg_kw = dict(hidden_size=256, num_heads=2, attention="auto")
    n_tok = 800  # ≥ auto_flash_min_tokens: both sides resolve to flash_bf16
    jcfg = jdit.DiTConfig(**cfg_kw)
    assert jdit.resolve_attention_mode(jcfg, n_tok) == "flash_bf16"
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, n_tok, 256)).astype(np.float32)
    mod = jdit.MHSA(jcfg)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))

    port = pdit.MHSA(pdit.DiTConfig(**cfg_kw))
    port.load_state_dict({
        "qkv.weight": t(np.asarray(params["qkv"]["kernel"]).T),
        "qkv.bias": t(np.asarray(params["qkv"]["bias"])),
        "proj.weight": t(np.asarray(params["proj"]["kernel"]).T),
        "proj.bias": t(np.asarray(params["proj"]["bias"])),
    })
    before = flash_attention.launches
    with torch.no_grad():
        got = port(t(x)).numpy()
    assert flash_attention.launches == before
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "mode", ["auto", "einsum", "flash", "flash_bf16", "splash", "splash_bf16"]
)
def test_resolve_attention_mode_matches_jax(mode):
    for min_tok in (768, 64):
        kw = dict(attention=mode, auto_flash_min_tokens=min_tok)
        for n in (1, 63, 64, 767, 768, 2047, 2048, 3840):
            for train in (False, True):
                assert pdit.resolve_attention_mode(pdit.DiTConfig(**kw), n, train) == (
                    jdit.resolve_attention_mode(jdit.DiTConfig(**kw), n, train)
                )


def test_kernel_input_checks_reject_what_the_kernel_cannot_take():
    from dex_tts_tpu_torch.ops.attention import _check

    qkv = torch.zeros(2, 40, 3, 2, 128)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _check(q, k, v)  # the DiT's strided views pass
    _check(*(a.to(torch.bfloat16) for a in (q, k, v)))
    with pytest.raises(TypeError):
        _check(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        _check(q.to(torch.bfloat16), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        _check(*(a[..., :64] for a in (q, k, v)))
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(2, 40, 2, 256)[..., ::2]
        _check(wide, wide, wide)
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.zeros(2, 40 * 2 * 128 + 1)[:, 1:].reshape(2, 40, 2, 128)
        _check(odd, odd, odd)
    with pytest.raises(ValueError, match="alike"):
        _check(q, k[:, :39], v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 63, 777, 880])
def test_tensor_map_layout_addresses_qkv_views(T, dtype):
    """The tensor maps' dims (hd, H, T, B) and byte strides (H, T, B) of
    the DiT's qkv[:, :, i] views, and of a contiguous (B, T, H, hd) dO,
    address every element where the tensor holds it."""
    b, h, hd = 2, 2, 128
    qkv = torch.zeros((b, T, 3, h, hd), dtype=dtype)
    e = qkv.element_size()
    rng = np.random.default_rng(T)
    idx = [tuple(int(rng.integers(n)) for n in (b, T, h, hd)) for _ in range(32)]
    idx += [(b - 1, T - 1, h - 1, hd - 1), (0, 0, 0, 0)]
    for i in range(3):
        view = qkv[:, :, i]
        dims, strides = tensor_map_layout(view)
        assert dims == (hd, h, T, b)
        assert all(s % 16 == 0 for s in strides)  # TMA's rule for global strides
        assert strides == (hd * e, 3 * h * hd * e, T * 3 * h * hd * e)
        for bi, ti, hi, di in idx:
            got = view.data_ptr() + di * e + hi * strides[0] + ti * strides[1] + bi * strides[2]
            flat = (((bi * T + ti) * 3 + i) * h + hi) * hd + di
            assert got == qkv.data_ptr() + flat * e
        # the f32 kernels take the same strides back in elements (batch, time, head)
        assert tuple(s // e for s in reversed(strides)) == view.stride()[:3]
    do = torch.zeros((b, T, h, hd), dtype=dtype)
    dims, strides = tensor_map_layout(do)
    assert dims == (hd, h, T, b) and strides == (hd * e, h * hd * e, T * h * hd * e)


# The JAX package's attention dtype for each (mode, compute dtype, on the
# accelerator): there `dt = jnp.bfloat16 if mode == "splash_bf16" else
# jnp.float32` (dex_tts_tpu/models/dit.py:375) and the same for flash
# (:421), whatever the compute dtype; elsewhere the einsum fallback in the
# compute dtype (:350-362).
JAX_ATTENTION_DTYPE = {
    ("flash", "float32", True): "float32",
    ("flash", "bfloat16", True): "float32",
    ("splash", "float32", True): "float32",
    ("splash", "bfloat16", True): "float32",
    ("flash_bf16", "float32", True): "bfloat16",
    ("flash_bf16", "bfloat16", True): "bfloat16",
    ("splash_bf16", "float32", True): "bfloat16",
    ("splash_bf16", "bfloat16", True): "bfloat16",
    ("flash", "float32", False): "float32",
    ("flash", "bfloat16", False): "bfloat16",
    ("splash", "float32", False): "float32",
    ("splash", "bfloat16", False): "bfloat16",
    ("flash_bf16", "float32", False): "float32",
    ("flash_bf16", "bfloat16", False): "bfloat16",
    ("splash_bf16", "float32", False): "float32",
    ("splash_bf16", "bfloat16", False): "bfloat16",
}


@pytest.mark.parametrize("mode, compute, on_cuda", sorted(JAX_ATTENTION_DTYPE))
def test_attention_kernel_dtype_matches_jax_choice(mode, compute, on_cuda):
    got = pdit.attention_kernel_dtype(mode, pdit.DTYPES[compute], on_cuda)
    assert got == pdit.DTYPES[JAX_ATTENTION_DTYPE[mode, compute, on_cuda]]


LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def tf32_rna(x):
    """cvt.rna.tf32.f32 by bit arithmetic: the 13 low mantissa bits rounded
    off, to nearest with ties away from zero (sign and magnitude are apart
    in the bits, so adding half of the dropped unit rounds |x| up)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_tf32(a, b, products):
    """a @ b as the kernel's m16n8k8 TF32 products accumulate it in f32:
    one product of the TF32-rounded operands, or three of their big and
    small parts (small·big, big·small, then big·big)."""
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    if products == 1:
        return a_big @ b_big
    a_small, b_small = tf32_rna(a - a_big), tf32_rna(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def emulate_flash_fwd_f32(q, k, v, scale, products, block=64):
    """The arithmetic of csrc/flash_attention.cu's flash_fwd_f32 on (B, T,
    H, hd) f32 tensors: 64-key blocks, S and P·V by `matmul_tf32`, the
    online softmax in f32 with exp2 and scale·log2 e folded into the
    scores, P not rounded. → (o (B, T, H, hd), lse (B, H, T), natural log)."""
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full(qh.shape[:-1] + (1,), -torch.inf)
    s_sum = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for k0 in range(0, qh.shape[2], block):
        kb, vb = kh[:, :, k0:k0 + block], vh[:, :, k0:k0 + block]
        s = matmul_tf32(qh, kb.transpose(-1, -2), products) * scale_log2
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        s_sum = s_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + matmul_tf32(p, vb, products)
        m = m_new
    lse = (m + torch.log2(s_sum)) * LN2
    return (acc / s_sum).transpose(1, 2), lse[..., 0]


@pytest.mark.parametrize("T", [1, 63, 200])
def test_3xtf32_emulation_matches_jax_einsum(T):
    """The f32 kernel's 3xTF32 arithmetic stays within 1e-5 of the JAX
    einsum at HIGHEST precision (o and lse); one TF32 product per product
    errs at least 10× more, which is why the kernel splits its operands
    (chip_smoke.py holds the kernel's o to atol 1e-4)."""
    rng = np.random.default_rng(100 + T)
    qkv = rng.standard_normal((2, T, 3, 2, 128)).astype(np.float32)
    q, k, v = (qkv[:, :, i] for i in range(3))
    want = np.asarray(jax_einsum_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                           precision=jax.lax.Precision.HIGHEST))
    scores = jnp.einsum("bthd,bshd->bhts", q, k, precision=jax.lax.Precision.HIGHEST) * 128**-0.5
    want_lse = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    errs = {}
    for products in (3, 1):
        o, lse = emulate_flash_fwd_f32(t(q), t(k), t(v), 128**-0.5, products)
        errs[products] = np.abs(o.numpy() - want).max()
        if products == 3:
            assert np.abs(lse.numpy() - want_lse).max() <= 1e-5
    assert errs[3] <= 1e-5, errs
    assert errs[1] >= 10 * errs[3] and errs[1] > 0, errs
