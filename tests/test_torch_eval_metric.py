"""Port vs JAX package: the objective metrics (`eval/metric.py`). The
distances are numpy copies and must agree exactly (DTW to 1e-12 on random
inputs, everything else equal); the random-init wav2vec2 ASR gives the
JAX package's transcript; the speaker backends fail as the JAX package's
do."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dex_tts_tpu.eval import metric as jmetric  # noqa: E402
from dex_tts_tpu_torch.eval import metric  # noqa: E402


@pytest.mark.parametrize("ta,tb,d", [(1, 1, 13), (1, 7, 13), (9, 1, 3), (37, 52, 13), (300, 270, 13)])
def test_dtw_equals_jax(ta, tb, d):
    rng = np.random.default_rng(ta * 1000 + tb)
    a, b = rng.standard_normal((ta, d)), rng.standard_normal((tb, d))
    got = metric._dtw_mean_distance(a, b)
    assert abs(got - jmetric._dtw_mean_distance(a, b)) <= 1e-12 * max(1.0, abs(got))
    assert metric._dtw_mean_distance(a, a) == 0.0


@pytest.mark.parametrize("n_mels,ta,tb", [(80, 120, 97), (12, 31, 40), (80, 1, 5), (80, 0, 5)])
def test_mcd_and_cepstra_equal_jax(n_mels, ta, tb):
    rng = np.random.default_rng(n_mels + ta)
    ref = rng.standard_normal((n_mels, ta)).astype(np.float32) - 5.0
    syn = rng.standard_normal((n_mels, tb)).astype(np.float32) - 5.0
    np.testing.assert_array_equal(metric.mel_to_cepstra(ref), jmetric.mel_to_cepstra(ref))
    got, want = metric.mel_cepstral_distortion(ref, syn), jmetric.mel_cepstral_distortion(ref, syn)
    if ta == 0:
        assert np.isnan(got) and np.isnan(want)
    else:
        assert got == want and got > 0
        assert metric.mel_mae(ref, syn) == jmetric.mel_mae(ref, syn)


@pytest.mark.parametrize("ref,hyp", [
    ("The quick brown fox.", "the quick brown fox"),
    ("It's a dog's life!", "its a dogs life"),
    ("", ""),
    ("", "extra words"),
    ("Hello, world", ""),
    ("One two three four five", "one too three for five six"),
    ("  Spaces   and\tTABS  ", "spaces and tabs"),
    ("Numbers 42 and 7", "numbers forty two and 7"),
])
def test_wer_cer_normalize_equal_jax(ref, hyp):
    assert metric.normalize_transcript(ref) == jmetric.normalize_transcript(ref)
    assert metric.wer(ref, hyp) == jmetric.wer(ref, hyp)
    assert metric.cer(ref, hyp) == jmetric.cer(ref, hyp)


def test_edit_distance_equals_jax_on_random_strings():
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = list(rng.choice(list("abcd"), int(rng.integers(0, 12))))
        b = list(rng.choice(list("abcd"), int(rng.integers(0, 12))))
        assert metric._edit_distance(a, b) == jmetric._edit_distance(a, b)


@pytest.mark.parametrize("values", [[], [0.5], [1.0, 2.0], list(np.linspace(-3, 7, 11))])
def test_mean_and_stderr_equal_jax(values):
    got, want = metric.mean_and_stderr(values), jmetric.mean_and_stderr(values)
    assert np.array_equal(np.asarray(got), np.asarray(want), equal_nan=True)


@pytest.mark.parametrize("backend,weights,error,match", [
    ("builtin", None, ValueError, "weights path"),
    ("ge2e", None, ValueError, "unknown speaker backend"),
    ("resemblyzer", None, ImportError, "forced"),
    ("random-init", "x.pt", ValueError, "ignores weights"),
])
def test_speaker_scorer_errors_match_jax(backend, weights, error, match):
    with pytest.raises(error, match=match) as want:
        jmetric.SpeakerScorer(backend=backend, weights=weights)
    with pytest.raises(error, match=match) as got:
        metric.SpeakerScorer(backend=backend, weights=weights, device="cpu")
    assert str(got.value) == str(want.value)


def test_speaker_scorer_auto_without_weights_is_unavailable():
    for scorer in (jmetric.SpeakerScorer(), metric.SpeakerScorer(device="cpu")):
        assert scorer.available is False
        assert scorer.cosine(np.zeros(100, np.float32), np.zeros(100, np.float32)) is None
    assert metric.SpeakerScorer(backend="random-init", device="cpu").builtin.random_init


def test_asr_without_transformers_is_unavailable(monkeypatch):
    """No transformers (as on the card's machine): the scorer reports
    unavailable and transcribes nothing; it never reaches for a download."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setitem(sys.modules, "transformers", None)
    for name in ("facebook/wav2vec2-large-960h-lv60-self", "random-init"):
        scorer = metric.ASRScorer(name, device="cpu")
        assert scorer.available is False
        assert scorer.transcribe(np.zeros(2205, np.float32)) is None


def test_asr_random_init_transcript_equals_jax():
    pytest.importorskip("transformers")
    port, jax_scorer = metric.ASRScorer("random-init", device="cpu"), jmetric.ASRScorer("random-init")
    assert port.available and jax_scorer.available
    rng = np.random.default_rng(1)
    for sr, n in ((22050, 22050), (16000, 12000)):
        wav = (0.1 * rng.standard_normal(n)).astype(np.float32)
        hyp = port.transcribe(wav, sample_rate=sr)
        assert isinstance(hyp, str) and hyp == jax_scorer.transcribe(wav, sample_rate=sr)
        assert np.isfinite(metric.cer("THE QUICK BROWN FOX", hyp))


def test_metric_module_imports_no_transformers():
    """transformers stays inside the ASR class: a module-level import can
    pull flax/jax into the process."""
    import subprocess

    code = ("import sys, dex_tts_tpu_torch.eval.metric, dex_tts_tpu_torch.eval.speaker; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('transformers', 'jax', 'flax')))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
