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


def jax_einsum_attention(q, k, v, dt=jnp.float32):
    """The JAX MHSA einsum branch (dit.py:356-362) on (B, T, H, hd)."""
    hd = q.shape[-1]
    scores = jnp.einsum("bthd,bshd->bhts", q, k, preferred_element_type=jnp.float32) * (hd**-0.5)
    weights = jax.nn.softmax(scores, axis=-1).astype(dt)
    return jnp.einsum("bhts,bshd->bthd", weights, v, preferred_element_type=jnp.float32).astype(dt)


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
