"""Port vs JAX package: the GE2E d-vector speaker encoder
(`eval/speaker.py`). The numpy preprocessing and `init_params` are copies
and must agree exactly; from the same params the torch network
(`nn.LSTM` + `nn.Linear`) equals JAX's `embed_frames` within rtol 2e-4 /
atol 2e-5 (the bound of JAX's own torch-twin test), and so does
`embed_utterance` on 16 kHz and 22.05 kHz input, on a short utterance and
through the VAD trim."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dex_tts_tpu.eval import speaker as jspeaker  # noqa: E402
from dex_tts_tpu_torch.eval import speaker  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def encoders():
    return speaker.BuiltinVoiceEncoder(device="cpu"), jspeaker.BuiltinVoiceEncoder()


def _speech_pause_speech(rng, sr=16000):
    loud = 0.1 * rng.standard_normal(sr)
    pause = 1e-4 * rng.standard_normal(10 * speaker._VAD_WINDOW)
    return np.concatenate([loud, pause, loud]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_equal_jax(seed):
    got, want = speaker.init_params(seed), jspeaker.init_params(seed)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("b,t", [(4, 160), (1, 37), (3, 160)])
def test_embed_frames_equals_jax(b, t):
    params = speaker.init_params(seed=b)
    enc = speaker.BuiltinVoiceEncoder(device="cpu")
    enc.net.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    frames = np.abs(np.random.default_rng(t).standard_normal((b, t, speaker.N_MELS))).astype(
        np.float32) * 1e-3
    want = np.asarray(jspeaker.embed_frames({k: jnp.asarray(v) for k, v in params.items()},
                                            jnp.asarray(frames)))
    got = enc.embed_frames(frames)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("case", ["22k_3s", "16k_3s", "16k_quiet", "short_0.1s", "vad_pause",
                                  "long_7s"])
def test_embed_utterance_equals_jax(encoders, case):
    rng = np.random.default_rng(len(case))
    sr = 22050 if case.startswith(("22k", "long")) else 16000
    if case == "vad_pause":
        wav = _speech_pause_speech(rng)
        assert len(speaker.trim_long_silences(wav)) < len(wav)  # the trim cuts the pause
    else:
        seconds = {"short_0.1s": 0.1, "long_7s": 7.0}.get(case, 3.0)
        scale = 1e-3 if case == "16k_quiet" else 0.1
        wav = (scale * rng.standard_normal(int(seconds * sr))).astype(np.float32)
    port, jax_enc = encoders
    got = port.embed_utterance(wav, source_sr=sr)
    want = jax_enc.embed_utterance(wav, source_sr=sr)
    assert got.shape == (speaker.EMBED,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_preprocessing_equals_jax():
    rng = np.random.default_rng(11)
    for wav, sr in ((_speech_pause_speech(rng), 16000),
                    ((0.05 * rng.standard_normal(30000)).astype(np.float32), 22050),
                    (np.zeros(100, np.float32), 16000), (np.zeros(0, np.float32), 16000)):
        np.testing.assert_array_equal(speaker.preprocess_wav(wav, sr),
                                      jspeaker.preprocess_wav(wav, sr))
        np.testing.assert_array_equal(speaker.wav_to_mel_frames(wav),
                                      jspeaker.wav_to_mel_frames(wav))
        np.testing.assert_array_equal(speaker.trim_long_silences(wav),
                                      jspeaker.trim_long_silences(wav))
        for kw in ({}, {"increase_only": True}, {"decrease_only": True}):
            np.testing.assert_array_equal(speaker.normalize_volume(wav, **kw),
                                          jspeaker.normalize_volume(wav, **kw))
    for n in (0, 10, 160, 161, 240, 400, 999):
        assert speaker.compute_partial_slices(n) == jspeaker.compute_partial_slices(n)


def test_loader_equals_jax(tmp_path):
    full = speaker.init_params(seed=3)
    wrapped = {"model_state": {f"module.{k}": torch.from_numpy(v) for k, v in full.items()},
               "similarity_weight": torch.ones(1)}
    for source in (dict(full), wrapped):
        got, want = speaker.load_torch_state_dict(source), jspeaker.load_torch_state_dict(source)
        assert sorted(got) == sorted(want) == sorted(full)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    path = tmp_path / "pretrained.pt"
    torch.save(wrapped, path)
    enc = speaker.BuiltinVoiceEncoder(weights=str(path), device="cpu")
    assert not enc.random_init
    assert torch.equal(enc.net.lstm.weight_ih_l0, torch.from_numpy(full["lstm.weight_ih_l0"]))
    extra = dict(full, **{"lstm.weight_ih_l3": full["lstm.weight_ih_l1"]})
    missing = {k: v for k, v in full.items() if k != "linear.bias"}
    for bad, match in ((extra, "unexpected.*weight_ih_l3"), (missing, "missing.*linear.bias")):
        with pytest.raises(ValueError, match=match) as want:
            jspeaker.load_torch_state_dict(bad)
        with pytest.raises(ValueError, match=match) as got:
            speaker.load_torch_state_dict(bad)
        assert str(got.value) == str(want.value)


def test_encoder_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        speaker.BuiltinVoiceEncoder()
    state = torch.random.get_rng_state()
    enc = speaker.BuiltinVoiceEncoder(device="cpu")
    assert enc.device.type == "cpu" and enc.random_init
    assert torch.equal(torch.random.get_rng_state(), state)  # no draws from the global generator
