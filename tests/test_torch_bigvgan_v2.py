"""The 44.1 kHz pipeline of the port: BigVGAN-v2's head (no ``tanh``, no
``conv_post`` bias) against the benchmark's plain reference
(benchmark/reference/bigvgan_v2.py) and v1's defaults against the JAX
package; the Synthesizer's audio parameters (`pipeline.AudioConfig`):
the reference front end at 44.1 kHz and 128 bands, the checks of an
audio that does not fit, the ``tts`` span's rate, the pause of
`tts_long`, the WAVs `synthesize` writes; the preset
``dex_vctk_bigvgan_v2_44k`` and its YAML; the export and load of a
generator without ``conv_post.bias``. Float32 on the CPU, tiny widths."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from benchmark.reference.bigvgan_v2 import BigVGANv2  # noqa: E402
from chip_smoke import V2_44K_RELEASE_CONFIG, speech_like, write_int16_wav  # noqa: E402
from dex_tts_tpu.models.vocoder import BigVGANGenerator as JaxBigVGAN  # noqa: E402
from dex_tts_tpu_torch import export, synthesize  # noqa: E402
from dex_tts_tpu_torch.audio.wav import read_wav, trim_silence  # noqa: E402
from dex_tts_tpu_torch.config import (  # noqa: E402
    PRESETS,
    build_vocoder,
    load_preset,
    preset_from_config,
)
from dex_tts_tpu_torch.convert import load_numpy_state  # noqa: E402
from dex_tts_tpu_torch.eval.evaluation import load_vocoder, read_vocoder_arch  # noqa: E402
from dex_tts_tpu_torch.models.edm import SamplerConfig  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, BigVGANGenerator  # noqa: E402
from dex_tts_tpu_torch.pipeline import AudioConfig, Synthesizer  # noqa: E402
from dex_tts_tpu_torch.utils import profiling  # noqa: E402
from dex_tts_tpu_torch.utils.config import Config, yaml_load  # noqa: E402
from tests.torch_port_util import BIGVGAN_TINY, bigvgan_pair, t, tiny_cfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "dex_tts_tpu_torch", "configs", "dex_vctk_bigvgan_v2_44k.yaml")
AUDIO_44K = AudioConfig(sample_rate=44100, hop_length=512, n_fft=2048, win_length=2048,
                        n_mels=128, f_min=0.0, f_max=None)
# BigVGAN-v2's 512x upsampling at tiny widths (one channel at the last stage)
V2_TINY = dict(num_mels=128, upsample_rates=(8, 4, 2, 2, 2, 2),
               upsample_kernel_sizes=(16, 8, 4, 4, 4, 4), upsample_initial_channel=64,
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
               use_tanh_at_final=False, use_bias_at_final=False)


def _reference_config(cfg: BigVGANConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _loud(gen, seed=2, post_scale=30.0):
    """Every parameter moved by seeded noise and ``conv_post`` scaled, so
    that the snakes shape the output and the head's clamp acts."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
        gen.conv_post.weight.mul_(post_scale)
    return gen


@pytest.mark.parametrize("tanh,bias", [(False, False), (True, False), (False, True),
                                       (True, True)])
def test_head_matches_the_plain_reference(tanh, bias):
    cfg = BigVGANConfig(**BIGVGAN_TINY, use_tanh_at_final=tanh, use_bias_at_final=bias)
    port = _loud(BigVGANGenerator(cfg).eval())
    ref = BigVGANv2(_reference_config(cfg)).eval()
    ref.load_state_dict(port.state_dict(), strict=True)
    assert ("conv_post.bias" in port.state_dict()) == bias
    mel = torch.randn(2, 12, 21, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got, want = port(mel), ref(mel)
    assert got.shape == want.shape == (2, 21 * 8)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    at_clamp = float((got.abs() == 1.0).float().mean())
    assert 0.0 < at_clamp < 0.5 if not tanh else at_clamp == 0.0
    if not tanh:  # a tanh head reads far off: the comparison sees the head
        with torch.no_grad():
            other = BigVGANv2({**_reference_config(cfg), "use_tanh_at_final": True}).eval()
            other.load_state_dict(port.state_dict())
            assert (other(mel) - want).abs().max() > 0.1


def test_v1_defaults_are_the_jax_generator():
    assert BigVGANConfig() == BigVGANConfig(use_tanh_at_final=True, use_bias_at_final=True)
    jcfg, params, port = bigvgan_pair()
    explicit = BigVGANGenerator(BigVGANConfig(**BIGVGAN_TINY, use_tanh_at_final=True,
                                              use_bias_at_final=True)).eval()
    explicit.load_state_dict(port.state_dict(), strict=True)
    mel = np.random.default_rng(4).standard_normal((2, 12, 21)).astype(np.float32)
    want = np.asarray(jax.jit(JaxBigVGAN(jcfg).apply)({"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        got = explicit(t(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _synth(audio=AUDIO_44K, vocoder_cfg=V2_TINY):
    torch.manual_seed(0)
    voc = build_vocoder(BigVGANConfig(**vocoder_cfg), device="cpu")
    return Synthesizer(build_tts(tiny_cfg(n_feats=128)), voc,
                       sampler=SamplerConfig(num_steps=2), device="cpu", audio=audio)


@pytest.mark.parametrize("sr", [44100, 16000])
def test_reference_wav_at_the_configs_rate_and_bands(tmp_path, sr):
    """A reference WAV through `prepare_reference` at 44.1 kHz: 128-band
    log-mel and lf0 with as many frames as hop 512 gives the trimmed
    recording at 44.1 kHz (a 16 kHz one resampled first)."""
    path = str(tmp_path / "ref.wav")
    write_int16_wav(path, speech_like(np.random.default_rng(3), sr), sr)
    syn = _synth()
    assert syn.hop == 512 and syn.mel_extractor.mel_basis.shape == (128, 1025)
    mel, lf0 = syn.prepare_reference(path)
    x, _ = read_wav(path)
    n = round(len(trim_silence(x, top_db=30.0)) * 44100 / sr)
    assert mel.shape[0] == 128 and lf0.shape == (mel.shape[1],)
    assert abs(mel.shape[1] - (1 + n // 512)) <= 1, (mel.shape, n)
    assert np.isfinite(mel).all() and np.count_nonzero(lf0) > mel.shape[1] // 2
    # the 22.05 kHz default: 80 bands at the same frame rate (22050 / 256 = 44100 / 512)
    mel22, _ = Synthesizer(build_tts(tiny_cfg(n_feats=80)), device="cpu").prepare_reference(path)
    assert mel22.shape[0] == 80 and abs(mel22.shape[1] - mel.shape[1]) <= 1


@pytest.mark.parametrize("mismatch", ["bands", "hop"])
def test_an_audio_that_does_not_fit_raises(tmp_path, mismatch):
    """A front end of other bands than the model's refuses a reference
    WAV; an audio whose hop is not the vocoder's upsampling refuses the
    Synthesizer."""
    if mismatch == "hop":
        with pytest.raises(ValueError, match="upsamples x512"):
            _synth(audio=AudioConfig())
        return
    path = str(tmp_path / "ref.wav")
    write_int16_wav(path, speech_like(np.random.default_rng(3), 16000), 16000)
    syn = _synth(audio=dataclasses.replace(AUDIO_44K, n_mels=80))
    with pytest.raises(ValueError, match="80 mel bands, the model takes 128"):
        syn.prepare_reference(path)


@pytest.mark.parametrize("audio", ["44k", "none"])
def test_the_tts_span_records_the_waveforms_rate(audio):
    """The ``tts`` span's ``sample_rate`` is the audio's where the vocoder
    upsamples by the audio's hop, and absent where it does not (the
    22.05 kHz defaults behind a 512x vocoder)."""
    syn = _synth(audio=AUDIO_44K if audio == "44k" else None)
    feats = [(np.zeros((128, 64), np.float32), np.zeros(64, np.float32))]
    with profiling.tracing():
        syn.tts(["Hello there."], ref_feats=feats, max_frames=64)
    attrs = profiling.calls()[-1].root.attrs
    assert attrs.get("sample_rate") == (44100 if audio == "44k" else None)


def test_tts_long_pauses_at_the_configs_rate():
    syn = object.__new__(Synthesizer)
    syn.audio = AUDIO_44K
    syn.device = torch.device("cpu")
    syn.tts = lambda texts, **kw: [{"mel": np.zeros((2, 3), np.float32), "n_frames": 3,
                                    "wav": np.ones(3 * 512, np.float32)} for _ in texts]
    out = syn.tts_long("First one. Second one! Third?", pause_ms=200.0)
    gap = int(44100 * 0.2)
    assert out["wav"].shape == (3 * 3 * 512 + 2 * gap,)
    assert not out["wav"][3 * 512: 3 * 512 + gap].any() and out["wav"][3 * 512 + gap] == 1.0


def test_preset_and_yaml(tmp_path):
    preset = load_preset("dex_vctk_bigvgan_v2_44k")
    assert preset.audio() == AUDIO_44K
    voc = preset.vocoder
    assert (voc.num_mels, voc.upsample_rates, voc.upsample_kernel_sizes,
            voc.upsample_initial_channel, voc.use_tanh_at_final, voc.use_bias_at_final) == (
        128, (8, 4, 2, 2, 2, 2), (16, 8, 4, 4, 4, 4), 1536, False, False)
    vctk = load_preset("vctk").model
    assert preset.model == dataclasses.replace(vctk, n_feats=128, compute_dtype="bfloat16")
    assert preset.model.dit_config().grid_h == 32  # 6144 DiT tokens at 768 frames
    with open(YAML) as f:
        assert yaml_load(f.read()) == yaml.safe_load(open(YAML))
    from_yaml = preset_from_config(Config(YAML))
    assert from_yaml.cmu_path == "resources/cmu_dictionary"
    assert dataclasses.replace(from_yaml, cmu_path=preset.cmu_path,
                               vocoder=preset.vocoder) == preset
    # the YAML's vocoder as the loader settles it from the release's config.json
    with open(tmp_path / "config.json", "w") as f:
        json.dump(V2_44K_RELEASE_CONFIG, f)
    arch = read_vocoder_arch(str(tmp_path), bigvgan=True)
    assert dataclasses.replace(from_yaml.vocoder, **arch) == preset.vocoder


def test_synthesize_writes_at_the_configs_rate(tmp_path, monkeypatch):
    """`synthesize` on a tiny 44.1 kHz preset (random weights): a sentence
    from a reference WAV and a paragraph with --long, 44,100 Hz WAVs of
    512 samples a frame and 0.1 s pauses at 44.1 kHz."""
    preset = dataclasses.replace(load_preset("dex_vctk_bigvgan_v2_44k"),
                                 model=tiny_cfg(n_feats=128), vocoder=BigVGANConfig(**V2_TINY),
                                 vocoder_path=str(tmp_path / "none"))
    monkeypatch.setitem(PRESETS, "tiny_44k", lambda: preset)
    ref = str(tmp_path / "ref.wav")
    write_int16_wav(ref, speech_like(np.random.default_rng(3), 16000), 16000)
    common = ["--preset", "tiny_44k", "--weight_path", str(tmp_path), "--random_init",
              "--n_timesteps", "2", "--device", "cpu", "--out_dir", str(tmp_path / "out"),
              "--ref_name", ref]
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        [(path, out)] = synthesize.main(common + ["--input_text", "Hello there."])
    wav, sr = read_wav(path)
    assert sr == 44100 and wav.shape == out["wav"].shape == (out["n_frames"] * 512,)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        [(path, out)] = synthesize.main(common + ["--input_text", "One here. And two.", "--long",
                                                  "--pause_ms", "100"])
    wav, sr = read_wav(path)
    assert sr == 44100 and wav.shape == (out["n_frames"] * 512 + int(44100 * 0.1),)


def test_export_and_load_without_the_head_bias(tmp_path):
    """A BigVGAN-v2 generator (no ``conv_post.bias``) exported in the
    reference layout loads back strictly, as the preset names it and as
    a v1 preset with a config.json beside the file that names the v2
    keys; the v1 head refuses it."""
    cfg = BigVGANConfig(**BIGVGAN_TINY, use_tanh_at_final=False, use_bias_at_final=False)
    gen = _loud(BigVGANGenerator(cfg).eval())
    src = tmp_path / "trained"
    src.mkdir()
    torch.save(gen.state_dict(), src / "gen_last.pth")
    preset = dataclasses.replace(load_preset("dex_vctk_bigvgan_v2_44k"), vocoder=cfg,
                                 vocoder_path=str(src))
    out = str(tmp_path / "exported" / "g_05000000")
    os.makedirs(os.path.dirname(out))
    state = export.export_vocoder(preset, out)
    assert "conv_post.bias" not in state and "conv_post.weight_g" in state
    mel = torch.randn(1, 12, 16, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = gen(mel)
    loaded = load_vocoder(dataclasses.replace(preset, vocoder_path=os.path.dirname(out),
                                              vocoder_dtype="float32"), device="cpu")
    with open(os.path.join(os.path.dirname(out), "config.json"), "w") as f:
        json.dump({**BIGVGAN_TINY, "use_tanh_at_final": False, "use_bias_at_final": False}, f)
    v1 = dataclasses.replace(preset, vocoder=BigVGANConfig(), vocoder_path=os.path.dirname(out),
                             vocoder_dtype="float32")
    by_config_json = load_vocoder(v1, device="cpu")
    with torch.no_grad():
        for voc in (loaded, by_config_json):
            assert voc.conv_post.bias is None
            torch.testing.assert_close(voc(mel), want, atol=1e-5, rtol=0)
    os.remove(os.path.join(os.path.dirname(out), "config.json"))
    with pytest.raises(RuntimeError, match="conv_post.bias"):
        load_vocoder(dataclasses.replace(v1, vocoder=BigVGANConfig(**BIGVGAN_TINY)),
                     device="cpu")
    load_numpy_state(BigVGANGenerator(cfg), {k: v.numpy() for k, v in gen.state_dict().items()})
