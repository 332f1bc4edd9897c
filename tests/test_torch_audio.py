"""Port vs JAX package: the reference-wav front end (audio/,
`Synthesizer.prepare_reference` and `tts(ref_wavs=...)`). The numpy/scipy
modules are copies and must agree exactly; the STFT and log-mel run in
PyTorch."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import REF_SR, write_reference_wavs  # noqa: E402
from dex_tts_tpu.audio import mel as jmel  # noqa: E402
from dex_tts_tpu.audio import pitch as jpitch  # noqa: E402
from dex_tts_tpu.audio import stft as jstft  # noqa: E402
from dex_tts_tpu.audio import wav as jwav  # noqa: E402
from dex_tts_tpu.pipeline import Synthesizer as JaxSynthesizer  # noqa: E402
from dex_tts_tpu_torch.audio import mel, pitch, stft, wav  # noqa: E402
from dex_tts_tpu_torch.config import build_vocoder  # noqa: E402
from dex_tts_tpu_torch.models.edm import SamplerConfig  # noqa: E402
from dex_tts_tpu_torch.models.tts import build_tts  # noqa: E402
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig  # noqa: E402
from dex_tts_tpu_torch.pipeline import Synthesizer  # noqa: E402
from tests.torch_port_util import BIGVGAN_TINY, tiny_cfg  # noqa: E402


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    return write_reference_wavs(str(tmp_path_factory.mktemp("refs")), 1)[0]


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (22050, 1024, 80, 0.0, 8000.0), (16000, 512, 40, 50.0, None), (24000, 2048, 100, 0.0, 12000.0),
])
def test_mel_filterbank_equals_jax(sr, n_fft, n_mels, fmin, fmax):
    np.testing.assert_array_equal(mel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                                  jmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax))


def test_wav_io_equals_jax(tmp_path, ref_wav):
    assert wav.read_wav(ref_wav)[1] == jwav.read_wav(ref_wav)[1] == REF_SR
    np.testing.assert_array_equal(wav.read_wav(ref_wav)[0], jwav.read_wav(ref_wav)[0])
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 999).astype(np.float32)
    wav.write_wav(str(tmp_path / "port.wav"), x)
    jwav.write_wav(str(tmp_path / "jax.wav"), x)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_trim_resample_normalize_equal_jax(ref_wav):
    x, sr = wav.read_wav(ref_wav)
    trimmed = wav.trim_silence(x, top_db=30.0)
    np.testing.assert_array_equal(trimmed, jwav.trim_silence(x, top_db=30.0))
    assert 0 < len(trimmed) < len(x)  # the silent margins go
    res = wav.resample(trimmed, sr, 22050)
    np.testing.assert_array_equal(res, jwav.resample(trimmed, sr, 22050))
    np.testing.assert_array_equal(wav.peak_normalize(res), jwav.peak_normalize(res))


def test_lf0_equals_jax(ref_wav):
    x, sr = wav.read_wav(ref_wav)
    x = wav.resample(x, sr, 22050)
    lf0 = pitch.extract_lf0(x, 22050, 256)
    np.testing.assert_array_equal(lf0, jpitch.extract_lf0(x, 22050, 256))
    assert (lf0 > 0).mean() > 0.5  # the harmonic glide is voiced
    np.testing.assert_array_equal(pitch.normalize_lf0(lf0), jpitch.normalize_lf0(lf0))


def test_stft_and_mel_spectrogram_match_jax():
    """float32 FFTs of two libraries: atol 1e-4 on the log-mel (values of
    order 1-10), 1e-4 relative on the magnitude."""
    rng = np.random.default_rng(1)
    y = (rng.uniform(-0.5, 0.5, (2, 6000)) * np.linspace(0, 1, 6000)).astype(np.float32)
    np.testing.assert_array_equal(stft.hann_window(1024), jstft.hann_window(1024))
    mag = stft.stft_magnitude(torch.from_numpy(y), 1024, 256, 800).numpy()
    jmag = np.asarray(jstft.stft_magnitude(jnp.asarray(y), 1024, 256, 800))
    np.testing.assert_allclose(mag, jmag, rtol=1e-4, atol=1e-4 * np.abs(jmag).max())
    log_mel, energy = stft.MelSpectrogram()(torch.from_numpy(y))
    jlog_mel, jenergy = jstft.MelSpectrogram()(jnp.asarray(y))
    assert log_mel.shape == (2, 80, 6000 // 256 + 1)
    np.testing.assert_allclose(log_mel.numpy(), np.asarray(jlog_mel), atol=1e-4)
    np.testing.assert_allclose(energy.numpy(), np.asarray(jenergy), rtol=1e-4)


def test_prepare_reference_matches_jax(ref_wav):
    """A 16 kHz recording through trim, resample, peak-normalize, log-mel
    and lf0: the lf0 equal, the log-mel within 1e-4."""
    syn = Synthesizer(build_tts(tiny_cfg()), device="cpu")
    mel_p, lf0_p = syn.prepare_reference(ref_wav)
    mel_j, lf0_j = JaxSynthesizer(None, None).prepare_reference(ref_wav)
    assert mel_p.shape == mel_j.shape and mel_p.shape[0] == 80 and mel_p.shape[1] > 200
    assert lf0_p.shape == (mel_p.shape[1],)
    np.testing.assert_array_equal(lf0_p, lf0_j)
    np.testing.assert_allclose(mel_p, mel_j, atol=1e-4)


def test_tts_from_reference_wavs(tmp_path):
    """`tts(ref_wavs=...)` is `tts(ref_feats=[prepare_reference(p), ...])`,
    through an 80-band DeX and BigVGAN (hop 8 here)."""
    torch.manual_seed(0)
    syn = Synthesizer(build_tts(tiny_cfg(n_feats=80)),
                      build_vocoder(BigVGANConfig(**{**BIGVGAN_TINY, "num_mels": 80}), device="cpu"),
                      sampler=SamplerConfig(num_steps=2), device="cpu")
    assert syn.hop == 8
    paths = write_reference_wavs(str(tmp_path), 2)
    texts = ["Printing, in the only sense.", "It differs."]
    got = syn.tts(texts, ref_wavs=paths, temperature=1.5)
    want = syn.tts(texts, ref_feats=[syn.prepare_reference(p) for p in paths], temperature=1.5)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g["n_frames"] == w["n_frames"]
        assert g["wav"].shape == (g["n_frames"] * 8,) and np.isfinite(g["wav"]).all()
        np.testing.assert_array_equal(g["wav"], w["wav"])
        np.testing.assert_array_equal(g["mel"], w["mel"])
