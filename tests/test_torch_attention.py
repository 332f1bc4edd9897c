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
from dex_tts_tpu_torch.ops.attention import attention_reference, flash_attention  # noqa: E402
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
