"""Port vs JAX package: the BigVGAN generator (models/vocoder/bigvgan.py)
with weights carried over by the port's own converter, at a tiny size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.export import bigvgan_flax_to_torch as jax_export  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANGenerator as JaxBigVGAN  # noqa: E402
from dex_tts_tpu_torch.config import build_vocoder, load_preset  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, BigVGANGenerator, bigvgan  # noqa: E402
from dex_tts_tpu_torch.ops import snake as sk  # noqa: E402
from tests.torch_port_util import BIGVGAN_TINY as TINY  # noqa: E402
from tests.torch_port_util import bigvgan_pair, t  # noqa: E402

HOP = 8

# f32: the same convolutions and snakes, summed in another order. bf16:
# both sides round the conv stack to bf16, in different places (the JAX
# package's off-TPU snake computes in bf16, the port's in f32 from bf16
# storage with the polynomial sin²): up to 2% of the waveform's peak.
CASES = {
    "resblock1-snakebeta-logscale-packed-subpixel": (
        dict(conv_impl="packed", upsample_impl="subpixel"), None),
    "resblock2-snake-linear-taps8": (
        dict(resblock="2", activation="snake", snake_logscale=False, snake_taps=8), None),
    "bf16": (dict(dtype="bfloat16"), 2e-2),
    "bf16-then-f32-stages": (dict(stage_dtypes=("bfloat16", "float32")), 2e-2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bigvgan_matches_jax(case):
    overrides, rel_tol = CASES[case]
    jcfg, params, port = bigvgan_pair(**overrides)
    mel = np.random.default_rng(4).standard_normal((2, 12, 21)).astype(np.float32)
    want = np.asarray(jax.jit(JaxBigVGAN(jcfg).apply)({"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(t(mel)).numpy()
    assert got.shape == (2, 21 * HOP) and got.dtype == np.float32
    atol = 1e-4 if rel_tol is None else rel_tol * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol)


def test_snakes_shape_the_output(monkeypatch):
    """The comparison above would catch a missing snake: with every
    snake replaced by its input the f32 output moves far outside 1e-4."""
    _, _, port = bigvgan_pair()
    mel = t(np.random.default_rng(4).standard_normal((2, 12, 21)).astype(np.float32))
    with torch.no_grad():
        want = port(mel)
        monkeypatch.setattr(bigvgan, "snake_antialias", lambda x, *a, **kw: x)
        identity = port(mel)
    assert (identity - want).abs().max().item() > 100 * 1e-4


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_state_dict_keys_match_jax_export(resblock):
    jcfg, params, port = bigvgan_pair(resblock=resblock, activation="snake")
    assert set(port.state_dict()) == set(jax_export(params, jcfg, weight_norm=False))


def test_snake_call_count_per_generator_call(monkeypatch):
    """One snake call per activation: 2·3 per AMP block of type 1, three
    blocks per stage, plus activation_post (109 at the released config),
    each on a (B, T, C) view with T contiguous."""
    cfg = load_preset("vctk_bench_bigvgan").vocoder
    n = len(cfg.upsample_rates) * sum(2 * len(d) for d in cfg.resblock_dilation_sizes) + 1
    assert n == 109
    _, _, port = bigvgan_pair()
    calls = []

    def counted(x, *a, **kw):
        calls.append(x.stride(1))
        return sk.snake_antialias(x, *a, **kw)

    monkeypatch.setattr(bigvgan, "snake_antialias", counted)
    with torch.no_grad():
        port(torch.zeros(1, 12, 5))
    assert len(calls) == len(TINY["upsample_rates"]) * 2 * 2 * 3 + 1
    assert set(calls) == {1}


def test_preset_and_factory():
    preset = load_preset("vctk_bench_bigvgan")
    voc = preset.vocoder
    assert isinstance(voc, BigVGANConfig)
    assert (voc.dtype, voc.snake_impl, voc.upsample_initial_channel) == ("bfloat16", "auto", 1536)
    assert voc.upsample_rates == (4, 4, 2, 2, 2, 2) and voc.num_mels == 80
    assert preset.model == load_preset("vctk_bench").model
    gen = build_vocoder(BigVGANConfig(**TINY), device="cpu")
    assert isinstance(gen, BigVGANGenerator) and not gen.training


def test_rejects_unknown_lowering_and_stage_dtypes():
    with pytest.raises(ValueError, match="conv_impl"):
        BigVGANGenerator(BigVGANConfig(**TINY, conv_impl="im2col"))
    with pytest.raises(ValueError, match="stage_dtypes"):
        BigVGANGenerator(BigVGANConfig(**TINY, stage_dtypes=("float32",)))
