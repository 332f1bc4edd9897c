"""Port vs JAX package, whole slice: tiny DeX `synthesize` (2 euler steps,
3 dpmpp2m steps, 4 steps with the DiT cache; shared initial noise, DiT
through the flash route), HiFi-GAN, DeX → BigVGAN, and the Synthesizer's
buckets, audio, constructor options and per-call sampler options."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.models.edm import SamplerConfig as JaxSamplerConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import HiFiGANConfig as JaxHiFiGANConfig  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANGenerator as JaxBigVGAN  # noqa: E402
from dex_tts_tpu.models.vocoder import HiFiGANGenerator as JaxHiFiGAN  # noqa: E402
from dex_tts_tpu.ops import fix_len_compatibility  # noqa: E402
from dex_tts_tpu.pipeline import Synthesizer as JaxSynthesizer  # noqa: E402
from dex_tts_tpu_torch.convert import hifigan_flax_to_torch, load_numpy_state  # noqa: E402
from dex_tts_tpu_torch.models.dit import resolve_attention_mode, token_count  # noqa: E402
from dex_tts_tpu_torch.models.edm import SamplerConfig  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig, HiFiGANGenerator  # noqa: E402
from dex_tts_tpu_torch.pipeline import Synthesizer  # noqa: E402
from tests.torch_port_util import bigvgan_pair, build_pair, perturb, style_inputs, t, tiny_cfg  # noqa: E402

N_STEPS = 2
TEMP = 1.5
# flash from 64 tokens, so the tiny DiT runs the flash route
CFG = tiny_cfg(dit=dict(attention="auto", auto_flash_min_tokens=64))
# narrow, but with the default hop of 256 samples per frame
SAMPLERS = {"dpmpp2m_3": dict(num_steps=3, solver="dpmpp2m"),
            "dit_cache_4_2": dict(num_steps=4, dit_cache_interval=2)}
TEXTS = ["Printing, in the only sense.", "It differs.", "From most arts."]
TINY_VOC = dict(num_mels=12, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                resblock_dilation_sizes=((1, 3), (1, 3)))


@pytest.fixture(scope="module")
def pair():
    return build_pair(CFG)


def test_synthesize_matches_jax(pair):
    model, variables, port = pair
    rng = np.random.default_rng(0)
    b, tx, tr = 2, 9, 11
    x = rng.integers(1, 30, (b, tx)).astype(np.int32)
    x_lengths = np.asarray([tx, 6], np.int32)
    x[1, 6:] = 0
    style = style_inputs(rng, b, tr, lengths=[tr, 8])
    jstyle = {k: jnp.asarray(v) for k, v in style.items()}

    logw, x_mask = jax.jit(partial(model.apply, method=type(model).predict_durations))(
        variables, jnp.asarray(x), jnp.asarray(x_lengths), **jstyle
    )
    frames = int(np.ceil(np.exp(np.asarray(logw)) * np.asarray(x_mask)).sum(1).max())
    y_max = max(fix_len_compatibility(frames), 128)
    mid_tokens = token_count(CFG.dit_config(), y_max // 2)
    assert resolve_attention_mode(CFG.dit_config(), mid_tokens) == "flash_bf16"
    noise = rng.standard_normal((b, CFG.n_feats, y_max)).astype(np.float32)

    @jax.jit
    def run(variables, x, x_lengths, noise, style):
        return model.apply(
            variables, jax.random.PRNGKey(0), x, x_lengths, y_max_length=y_max,
            sampler=JaxSamplerConfig(num_steps=N_STEPS), temperature=TEMP,
            latents_noise=noise, method=type(model).synthesize, **style,
        )

    want = [np.asarray(a) for a in run(variables, jnp.asarray(x),
                                       jnp.asarray(x_lengths), jnp.asarray(noise), jstyle)]
    with torch.no_grad():
        got = port.synthesize(
            t(x, torch.long), t(x_lengths, torch.long), y_max_length=y_max,
            sampler=SamplerConfig(num_steps=N_STEPS), temperature=TEMP,
            latents_noise=t(noise), **{k: t(v) for k, v in style.items()},
        )
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[3], want[3])  # y_lengths
    np.testing.assert_array_equal(got[2], want[2])  # attn
    np.testing.assert_allclose(got[0], want[0], atol=5e-4, rtol=1e-3)  # enc
    np.testing.assert_allclose(got[1], want[1], atol=2e-3, rtol=1e-2)  # dec


def _hifigan_pair(seed=3, dtype="float32"):
    jcfg = JaxHiFiGANConfig(**TINY_VOC, dtype=dtype)
    params = JaxHiFiGAN(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 12, 8)))
    params = perturb(jax.tree_util.tree_map(np.asarray, dict(params)), seed)["params"]
    port = HiFiGANGenerator(HiFiGANConfig(**TINY_VOC, dtype=dtype)).eval()
    load_numpy_state(port, hifigan_flax_to_torch(params, jcfg))
    return jcfg, params, port


# bf16: the conv stack rounds to bf16 (half-step 2^-9 relative) on both
# sides in different places through ~12 convs before the f32 conv_post:
# a few percent of the waveform's scale at worst
@pytest.mark.parametrize("dtype,tol", [("float32", None), ("bfloat16", 3e-2)])
def test_hifigan_matches_jax(dtype, tol):
    jcfg, params, port = _hifigan_pair(dtype=dtype)
    mel = np.random.default_rng(4).standard_normal((2, 12, 21)).astype(np.float32)
    want = np.asarray(jax.jit(JaxHiFiGAN(jcfg).apply)({"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(t(mel)).numpy()
    assert got.shape == (2, 21 * 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 if tol is None else tol * np.abs(want).max())


def test_dex_to_bigvgan_chain_matches_jax(pair):
    """The mel agrees as in the HiFi-GAN chain (atol 2e-3, rtol 1e-2); the
    waveform within 1e-3 of its peak: f32 sums in another order through
    the DeX and the f32 BigVGAN (the vocoder alone agrees to 1e-4)."""
    model, variables, port = pair
    jcfg, voc_params, voc = bigvgan_pair()
    rng = np.random.default_rng(0)
    b, tx, tr = 2, 9, 11
    x = rng.integers(1, 30, (b, tx)).astype(np.int32)
    x_lengths = np.asarray([tx, 6], np.int32)
    x[1, 6:] = 0
    style = style_inputs(rng, b, tr, lengths=[tr, 8])
    jstyle = {k: jnp.asarray(v) for k, v in style.items()}
    logw, x_mask = jax.jit(partial(model.apply, method=type(model).predict_durations))(
        variables, jnp.asarray(x), jnp.asarray(x_lengths), **jstyle
    )
    frames = int(np.ceil(np.exp(np.asarray(logw)) * np.asarray(x_mask)).sum(1).max())
    y_max = fix_len_compatibility(max(frames, 16))
    noise = rng.standard_normal((b, CFG.n_feats, y_max)).astype(np.float32)

    @jax.jit
    def run(variables, voc_params, x, x_lengths, noise, style):
        _, mel, _, y_lengths = model.apply(
            variables, jax.random.PRNGKey(0), x, x_lengths, y_max_length=y_max,
            sampler=JaxSamplerConfig(num_steps=N_STEPS), temperature=TEMP,
            latents_noise=noise, method=type(model).synthesize, **style,
        )
        return mel, JaxBigVGAN(jcfg).apply({"params": voc_params}, mel), y_lengths

    want_mel, want_wav, want_len = (np.asarray(a) for a in run(
        variables, voc_params, jnp.asarray(x), jnp.asarray(x_lengths), jnp.asarray(noise), jstyle))
    with torch.no_grad():
        _, mel, _, y_lengths = port.synthesize(
            t(x, torch.long), t(x_lengths, torch.long), y_max_length=y_max,
            sampler=SamplerConfig(num_steps=N_STEPS), temperature=TEMP,
            latents_noise=t(noise), **{k: t(v) for k, v in style.items()},
        )
        wav = voc(mel).numpy()
    np.testing.assert_array_equal(y_lengths.numpy(), want_len)
    np.testing.assert_allclose(mel.numpy(), want_mel, atol=2e-3, rtol=1e-2)
    assert wav.shape == want_wav.shape == (b, y_max * 8)
    np.testing.assert_allclose(wav, want_wav, atol=1e-3 * np.abs(want_wav).max())


def test_synthesizer_buckets_match_jax(pair):
    model, variables, port = pair
    jcfg, voc_params, voc = _hifigan_pair()
    texts = ["Printing, in the only sense.", "It differs.", "From most arts."]
    rng = np.random.default_rng(5)
    feats = [(rng.standard_normal((12, n)).astype(np.float32) * 0.5,
              rng.standard_normal(n).astype(np.float32)) for n in (30, 41, 25)]

    jsyn = JaxSynthesizer(model, variables, JaxHiFiGAN(jcfg), voc_params,
                          sampler=JaxSamplerConfig(num_steps=N_STEPS))
    want = jsyn.tts(texts, ref_feats=feats, temperature=TEMP)
    (x_len, y_len, _, _), = jsyn._synth_cache

    syn = Synthesizer(port, voc, sampler=SamplerConfig(num_steps=N_STEPS), device="cpu")
    inputs, b = syn.prepare_batch(texts, ref_feats=feats)
    assert b == 3 and inputs["x"].shape == (4, x_len)  # 3 pads to 4
    assert syn.frame_bucket(inputs) == y_len
    got = syn.tts(texts, ref_feats=feats, temperature=TEMP)
    assert [r["n_frames"] for r in got] == [r["n_frames"] for r in want]
    for r in got:
        assert r["wav"].shape == (r["n_frames"] * 256,)
        assert r["mel"].shape == (12, r["n_frames"])
        assert np.isfinite(r["wav"]).all() and np.isfinite(r["mel"]).all()


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_synthesize_samplers_match_jax(pair, sampler):
    """dpmpp2m (3 steps) and the DiT cache (4 steps, k = 2) at the bound
    of the euler comparison above."""
    model, variables, port = pair
    rng = np.random.default_rng(0)
    b, tx, tr, y_max = 2, 9, 11, 128
    x = rng.integers(1, 30, (b, tx)).astype(np.int32)
    x_lengths = np.asarray([tx, 6], np.int32)
    x[1, 6:] = 0
    style = style_inputs(rng, b, tr, lengths=[tr, 8])
    noise = rng.standard_normal((b, CFG.n_feats, y_max)).astype(np.float32)

    @jax.jit
    def run(variables, x, x_lengths, noise, style):
        return model.apply(
            variables, jax.random.PRNGKey(0), x, x_lengths, y_max_length=y_max,
            sampler=JaxSamplerConfig(**SAMPLERS[sampler]), temperature=1.5,
            latents_noise=noise, method=type(model).synthesize, **style,
        )

    want = [np.asarray(a) for a in run(variables, jnp.asarray(x), jnp.asarray(x_lengths),
                                       jnp.asarray(noise),
                                       {k: jnp.asarray(v) for k, v in style.items()})]
    with torch.no_grad():
        got = port.synthesize(
            t(x, torch.long), t(x_lengths, torch.long), y_max_length=y_max,
            sampler=SamplerConfig(**SAMPLERS[sampler]), temperature=1.5,
            latents_noise=t(noise), **{k: t(v) for k, v in style.items()},
        )
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[3], want[3])  # y_lengths
    np.testing.assert_array_equal(got[2], want[2])  # attn
    np.testing.assert_allclose(got[1], want[1], atol=2e-3, rtol=1e-2)  # dec


def test_prepare_text_without_blanks_matches_jax(pair):
    model, variables, port = pair
    for add_blank in (False, True):
        jsyn = JaxSynthesizer(model, variables, add_blank=add_blank)
        syn = Synthesizer(port, add_blank=add_blank, device="cpu")
        for text in TEXTS:
            want = jsyn.prepare_text(text)
            np.testing.assert_array_equal(syn.prepare_text(text), want)
        assert (len(syn.prepare_text(TEXTS[1])) > len(JaxSynthesizer(
            model, variables, add_blank=False).prepare_text(TEXTS[1]))) == add_blank


@pytest.fixture(scope="module")
def unpadded(pair):
    """JAX's and the port's Synthesizer with pad_batches=False and other
    quanta, one vocode=False call each on 3 sentences (JAX runs the 2-step
    sampler through one jitted graph: its cache key holds the buckets)."""
    model, variables, port = pair
    jcfg, voc_params, voc = _hifigan_pair()
    rng = np.random.default_rng(5)
    feats = [(rng.standard_normal((CFG.n_feats, n)).astype(np.float32) * 0.5,
              rng.standard_normal(n).astype(np.float32)) for n in (30, 41, 25)]
    kw = dict(pad_batches=False, x_quantum=16, y_quantum=32)
    jsyn = JaxSynthesizer(model, variables, JaxHiFiGAN(jcfg), voc_params,
                          sampler=JaxSamplerConfig(num_steps=2), **kw)
    want = jsyn.tts(TEXTS, ref_feats=feats, vocode=False)
    (x_len, y_len, with_voc, _), = jsyn._synth_cache
    syn = Synthesizer(port, voc, sampler=SamplerConfig(num_steps=2), device="cpu", **kw)
    return dict(syn=syn, feats=feats, want=want, x_len=x_len, y_len=y_len, with_voc=with_voc,
                got=syn.tts(TEXTS, ref_feats=feats, vocode=False))


def test_unpadded_batch_and_frame_bucket_match_jax(unpadded):
    u = unpadded
    inputs, b = u["syn"].prepare_batch(TEXTS, ref_feats=u["feats"])
    assert b == 3 and inputs["x"].shape == (3, u["x_len"])  # no padding to 4
    assert u["x_len"] % 16 == 0 and inputs["ref"].shape[-1] % 32 == 0
    assert u["syn"].frame_bucket(inputs) == u["y_len"]


def test_vocode_false_matches_jax(unpadded):
    u = unpadded
    assert not u["with_voc"]
    assert [sorted(r) for r in u["got"]] == [sorted(r) for r in u["want"]] == [
        ["mel", "n_frames"]] * 3
    assert [r["n_frames"] for r in u["got"]] == [r["n_frames"] for r in u["want"]]
    for r in u["got"]:
        assert r["mel"].shape == (CFG.n_feats, r["n_frames"]) and np.isfinite(r["mel"]).all()


@pytest.mark.parametrize("options", [
    dict(n_timesteps=3, solver="dpmpp2m"),
    dict(dit_cache_interval=2, n_timesteps=4),
    dict(n_timesteps=2, solver="euler", dit_cache_interval=1),  # the synthesizer's own
])
def test_per_call_sampler_options_match_jax_and_are_not_sticky(pair, options, monkeypatch):
    """The sampler of each call is JAX's for the same options (JAX's is
    read where `tts` hands it on), and the next call without options
    runs the synthesizer's own again."""
    model, variables, port = pair
    base = dict(num_steps=2)
    jsyn = JaxSynthesizer(model, variables, sampler=JaxSamplerConfig(**base))
    handed_on = []
    monkeypatch.setattr(jsyn, "_tts_batch", lambda *a: handed_on.append(a[-1]))
    jsyn.tts(TEXTS, **options)
    syn = Synthesizer(port, sampler=SamplerConfig(**base), device="cpu")
    seen = []
    real = port.synthesize
    monkeypatch.setattr(port, "synthesize",
                        lambda *a, sampler, **k: seen.append(sampler) or real(*a, sampler=sampler,
                                                                             **k))
    feats = [(np.ones((CFG.n_feats, 20), np.float32), np.zeros(20, np.float32))] * 3
    first = syn.tts(TEXTS, ref_feats=feats, **options)
    syn.tts(TEXTS, ref_feats=feats)
    assert dataclasses.asdict(seen[0]) == dataclasses.asdict(handed_on[0])
    assert seen[1] is syn.sampler and syn.sampler == SamplerConfig(**base)
    # the call ran the sampler it was given
    with torch.no_grad():
        inputs, _ = syn.prepare_batch(TEXTS, ref_feats=feats)
        cond = {k: v for k, v in inputs.items() if k not in ("x", "x_lengths")}
        mel = real(inputs["x"], inputs["x_lengths"], y_max_length=syn.frame_bucket(inputs),
                   sampler=seen[0], temperature=1.5,
                   generator=torch.Generator().manual_seed(0), **cond)[1]
    np.testing.assert_array_equal(first[0]["mel"], mel[0, :, : first[0]["n_frames"]].numpy())
