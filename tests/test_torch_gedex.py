"""Port vs JAX package: multi-speaker GeDEX synthesis (speaker embedding
concatenated into the text encoder and stacked as a third denoiser
channel), 2 heun steps with shared initial noise, 3 dpmpp2m steps and 4
steps with the DiT cache, the Synthesizer with
speaker ids and no vocoder, and the training loss with its gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.models.edm import SamplerConfig as JaxSamplerConfig  # noqa: E402
from dex_tts_tpu.pipeline import Synthesizer as JaxSynthesizer  # noqa: E402
from dex_tts_tpu_torch.models.edm import SamplerConfig  # noqa: E402
from dex_tts_tpu_torch.pipeline import Synthesizer  # noqa: E402
from tests.torch_port_util import (  # noqa: E402
    assert_grads_match,
    build_pair,
    loss_and_grads,
    planted_batch,
    t,
    tiny_cfg,
)

CFG = tiny_cfg(use_style=False, n_spks=4, spk_emb_dim=8)
SAMPLER = dict(num_steps=3, solver="heun")


@pytest.fixture(scope="module")
def pair():
    return build_pair(CFG, seed=1)


def test_gedex_synthesize_matches_jax(pair):
    model, variables, port = pair
    rng = np.random.default_rng(1)
    b, tx, y_max = 2, 9, 64
    x = rng.integers(1, 149, (b, tx)).astype(np.int32)
    x_lengths = np.asarray([tx, 6], np.int32)
    spk = np.asarray([1, 3], np.int32)
    noise = rng.standard_normal((b, CFG.n_feats, y_max)).astype(np.float32)

    @jax.jit
    def run(variables, x, x_lengths, spk, noise):
        return model.apply(
            variables, jax.random.PRNGKey(0), x, x_lengths, y_max_length=y_max,
            sampler=JaxSamplerConfig(**SAMPLER), temperature=1.5, spk=spk,
            latents_noise=noise, method=type(model).synthesize,
        )

    want = [np.asarray(a) for a in run(variables, *(jnp.asarray(a) for a in
                                                    (x, x_lengths, spk, noise)))]
    with torch.no_grad():
        got = port.synthesize(
            t(x, torch.long), t(x_lengths, torch.long), y_max_length=y_max,
            sampler=SamplerConfig(**SAMPLER), temperature=1.5, spk=t(spk, torch.long),
            latents_noise=t(noise),
        )
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got[1], want[1], atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("sampler", [dict(num_steps=3, solver="dpmpp2m"),
                                     dict(num_steps=4, dit_cache_interval=2)])
def test_gedex_synthesize_samplers_match_jax(pair, sampler):
    """dpmpp2m (3 steps) and the DiT cache (4 steps, k = 2), speakers
    included, at the bound of the heun comparison above."""
    model, variables, port = pair
    rng = np.random.default_rng(0)
    b, tx, y_max = 2, 9, 64
    x = rng.integers(1, 30, (b, tx)).astype(np.int32)
    x_lengths = np.asarray([tx, 6], np.int32)
    x[1, 6:] = 0
    spk = np.asarray([2, 0], np.int32)
    noise = rng.standard_normal((b, CFG.n_feats, y_max)).astype(np.float32)

    @jax.jit
    def run(variables, x, x_lengths, spk, noise):
        return model.apply(
            variables, jax.random.PRNGKey(0), x, x_lengths, y_max_length=y_max,
            sampler=JaxSamplerConfig(**sampler), temperature=1.5, spk=spk,
            latents_noise=noise, method=type(model).synthesize,
        )

    want = [np.asarray(a) for a in run(variables, *(jnp.asarray(a) for a in
                                                    (x, x_lengths, spk, noise)))]
    with torch.no_grad():
        got = port.synthesize(
            t(x, torch.long), t(x_lengths, torch.long), y_max_length=y_max,
            sampler=SamplerConfig(**sampler), temperature=1.5, spk=t(spk, torch.long),
            latents_noise=t(noise),
        )
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[3], want[3])  # y_lengths
    np.testing.assert_array_equal(got[2], want[2])  # attn
    np.testing.assert_allclose(got[1], want[1], atol=2e-3, rtol=1e-2)  # dec


def test_gedex_synthesizer_with_speaker_ids(pair):
    model, variables, port = pair
    texts = ["Good morning.", "See you at noon, then.", "Thanks.", "Bye now.", "Yes."]
    spk_ids = [0, 1, 2, 3, 1]
    jsyn = JaxSynthesizer(model, variables, sampler=JaxSamplerConfig(num_steps=2))
    want = jsyn.tts(texts, spk_ids=spk_ids)
    (x_len, y_len, _, _), = jsyn._synth_cache

    syn = Synthesizer(port, sampler=SamplerConfig(num_steps=2), device="cpu")
    inputs, b = syn.prepare_batch(texts, spk_ids=spk_ids)
    assert b == 5 and inputs["x"].shape == (8, x_len)  # 5 pads to 8
    assert inputs["spk"].tolist() == spk_ids + [1, 1, 1]
    assert syn.frame_bucket(inputs) == y_len
    got = syn.tts(texts, spk_ids=spk_ids)
    assert [r["n_frames"] for r in got] == [r["n_frames"] for r in want]
    for r in got:
        assert "wav" not in r and r["mel"].shape == (CFG.n_feats, r["n_frames"])
        assert np.isfinite(r["mel"]).all()


def test_gedex_compute_loss_and_gradients_match_jax(pair):
    """compute_loss (train=False, JAX's draws replayed, a mel planted along
    a known alignment): each term within rtol 1e-5, each parameter's
    gradient within 2e-4 × (max|g_jax| + 1e-3 × the largest gradient)."""
    model, variables, port = pair
    inputs, draws, key, _ = planted_batch(port, CFG, b=3, spk=[2, 0, 3], seed=4)
    want, want_grads, got = loss_and_grads(model, variables, port, CFG, inputs, draws, key, 16)
    assert sorted(got) == sorted(want) == ["diff_loss", "dur_loss", "prior_loss"]
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=1e-5, err_msg=k)
    assert assert_grads_match(port, want_grads, 2e-4) == len(list(port.parameters()))
    assert port.spk_emb.weight.grad.abs().sum() > 0
