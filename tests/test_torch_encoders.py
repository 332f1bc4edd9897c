"""Port vs JAX package: text encoder (with style), the LF0 / TV / TIV
style encoders and the TIV skip statistics, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.models.ref_encoder import stack_skip_stats as jax_stack  # noqa: E402
from dex_tts_tpu.ops import sequence_mask as jax_sequence_mask  # noqa: E402
from dex_tts_tpu_torch.models.ref_encoder import stack_skip_stats  # noqa: E402
from dex_tts_tpu_torch.ops.masks import generate_path, sequence_mask  # noqa: E402
from dex_tts_tpu_torch.convert import dex_tts_flax_to_torch, load_numpy_state  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from tests.torch_port_util import build_pair, jax_model, style_inputs, t, tiny_cfg  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return build_pair(tiny_cfg())


def _apply(model, variables, fn, *args):
    return jax.jit(lambda v, *a: model.apply(v, *a, method=fn))(variables, *args)


def _masks(lengths, t_max):
    m = (np.arange(t_max)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    return m[:, :, None], m[:, None, :]  # JAX (B, T, 1), port (B, 1, T)


# (use_softmax, use_decay): the shipped form, then the decayed and the
# normalised (non-softmax) parallel forms
RETENTION_FORMS = [(True, False), (True, True), (False, False), (False, True)]


@pytest.mark.parametrize("use_softmax,use_decay", RETENTION_FORMS)
def test_text_encoder_with_style(pair, use_softmax, use_decay):
    _, variables, _ = pair
    # the parameter tree does not depend on the retention form
    cfg = tiny_cfg(use_softmax=use_softmax, use_decay=use_decay)
    model = jax_model(cfg)
    port = build_tts(cfg)
    load_numpy_state(port, dex_tts_flax_to_torch(variables, cfg))
    rng = np.random.default_rng(0)
    x = rng.integers(1, 149, (2, 13)).astype(np.int32)
    lens = np.asarray([13, 7], np.int32)
    sty = rng.standard_normal((2, 16)).astype(np.float32)
    mu, logw, x_mask = _apply(
        model, variables, lambda m, x, l, s: m.encoder(x, l, sty=s),
        jnp.asarray(x), jnp.asarray(lens), jnp.asarray(sty),
    )
    with torch.no_grad():
        p_mu, p_logw, p_mask = port.encoder(t(x, torch.long), t(lens, torch.long), sty=t(sty))
    np.testing.assert_array_equal(p_mask.numpy().transpose(0, 2, 1), np.asarray(x_mask))
    np.testing.assert_allclose(p_mu.numpy().transpose(0, 2, 1), np.asarray(mu), atol=ATOL)
    np.testing.assert_allclose(p_logw.numpy().transpose(0, 2, 1), np.asarray(logw), atol=ATOL)


def test_lf0_encoder(pair):
    model, variables, port = pair
    style = style_inputs(np.random.default_rng(1), 2, 17, lengths=[17, 9])
    jm, pm = _masks(style["lf0_lengths"], 17)
    enc, dec = _apply(model, variables, lambda m, l, k: m.lf0_encoder(l, k),
                      jnp.asarray(style["lf0"]), jnp.asarray(jm))
    with torch.no_grad():
        p_enc, p_dec = port.lf0_encoder(t(style["lf0"]), t(pm))
    np.testing.assert_allclose(p_enc.numpy().transpose(0, 2, 1), np.asarray(enc), atol=ATOL)
    np.testing.assert_allclose(p_dec.numpy().transpose(0, 2, 1), np.asarray(dec), atol=ATOL)


def test_tv_encoder_with_vq(pair):
    model, variables, port = pair
    style = style_inputs(np.random.default_rng(2), 2, 19, lengths=[19, 12])
    jm, pm = _masks(style["sty_lengths"], 19)
    sty_t = style["sty"].transpose(0, 2, 1)
    z, dec, vq_loss = _apply(model, variables, lambda m, s, k: m.tv_encoder(s, k),
                             jnp.asarray(sty_t), jnp.asarray(jm))
    with torch.no_grad():
        p_z, p_dec, p_vq_loss = port.tv_encoder(t(style["sty"]), t(pm))
        codes = port.tv_encoder.vq.embedding
        flat = p_z.transpose(1, 2).reshape(-1, codes.shape[1])
        dist = torch.cdist(flat, codes).sort(dim=-1).values
    # the nearest code leads the runner-up by far more than f32 rounding
    # of the distances (~1e-5 here), so both sides pick the same codes
    assert (dist[:, 1] - dist[:, 0]).min() > 1e-3
    np.testing.assert_allclose(p_z.numpy().transpose(0, 2, 1), np.asarray(z), atol=ATOL)
    np.testing.assert_allclose(p_dec.numpy().transpose(0, 2, 1), np.asarray(dec), atol=ATOL)
    np.testing.assert_allclose(p_vq_loss.item(), float(vq_loss), rtol=1e-5)


def test_tiv_encoder_and_skip_stats(pair):
    model, variables, port = pair
    style = style_inputs(np.random.default_rng(3), 2, 15, lengths=[15, 10])
    jm, pm = _masks(style["ref_lengths"], 15)
    ref_t = style["ref"].transpose(0, 2, 1)
    out, skips = _apply(model, variables, lambda m, r, k: m.tiv_encoder(r, k),
                        jnp.asarray(ref_t), jnp.asarray(jm))
    means, stds = jax_stack(skips)
    with torch.no_grad():
        p_out, p_skips = port.tiv_encoder(t(style["ref"]), t(pm))
        p_means, p_stds = stack_skip_stats(p_skips)
    np.testing.assert_allclose(p_out.numpy().transpose(0, 2, 1), np.asarray(out), atol=ATOL)
    for a, b in zip(p_skips, skips):
        np.testing.assert_allclose(a.numpy().transpose(0, 2, 1), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(p_means.numpy(), np.asarray(means), atol=ATOL)
    np.testing.assert_allclose(p_stds.numpy(), np.asarray(stds), atol=ATOL)


def test_masks_and_path_match_jax():
    from dex_tts_tpu.ops import generate_path as jax_generate_path

    rng = np.random.default_rng(4)
    lens = np.asarray([5, 1, 9], np.int32)
    np.testing.assert_array_equal(
        sequence_mask(t(lens), 9).numpy(), np.asarray(jax_sequence_mask(jnp.asarray(lens), 9))
    )
    dur = np.ceil(rng.uniform(0, 4, (3, 6))).astype(np.float32)
    mask = rng.uniform(size=(3, 6, 20)) > 0.2
    want = jax_generate_path(jnp.asarray(dur), jnp.asarray(mask, jnp.float32))
    got = generate_path(t(dur), t(mask.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
