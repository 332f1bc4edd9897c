"""Self-contained GE2E d-vector speaker encoder (Resemblyzer-compatible), in
PyTorch (port of dex_tts_tpu/eval/speaker.py).

reference: DEX-TTS/src/metric.py:15-22,69-95: the reference's objective
eval scores speaker similarity with resemblyzer's ``VoiceEncoder``
(3-layer LSTM-256 → Linear(256) → ReLU → per-utterance L2 norm over
40-channel 16 kHz mel frames, the GE2E d-vector network). The network here
is that module stack (`nn.LSTM` + `nn.Linear`), loaded strictly from
resemblyzer's ``pretrained.pt`` state dict, on an explicit device (CUDA by
default).

The host preprocessing is numpy, copied from the JAX package: polyphase
resample to 16 kHz, a numpy power-mel front end matching
``librosa.feature.melspectrogram(n_fft=400, hop=160, n_mels=40)``, volume
normalisation, and an energy VAD approximating resemblyzer's webrtcvad
silence trimming (webrtcvad itself when importable).

Random-init construction (``BuiltinVoiceEncoder(weights=None)``) exists
only to run the full code path offline: its cosines are meaningless; never
report them (the contract of ``metric.ASRScorer("random-init")``).
`init_params` draws the same numbers as the JAX package's from a seed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dex_tts_tpu_torch.audio.mel import mel_filterbank
from dex_tts_tpu_torch.audio.wav import resample
from dex_tts_tpu_torch.utils.device import resolve_device

SAMPLE_RATE = 16000
N_FFT = 400          # 25 ms window (resemblyzer mel_window_length)
HOP = 160            # 10 ms step (mel_window_step)
N_MELS = 40
PARTIAL_FRAMES = 160  # 1.6 s partial utterances (partials_n_frames)
HIDDEN = 256
EMBED = 256
N_LAYERS = 3
TARGET_DBFS = -30.0   # audio_norm_target_dBFS

_VAD_WINDOW = 480          # 30 ms (vad_window_length)
_VAD_SMOOTH = 8            # vad_moving_average_width
_VAD_MAX_SILENCE = 6       # vad_max_silence_length (windows)


# ---------------------------------------------------------------------------
# preprocessing (host-side numpy)
# ---------------------------------------------------------------------------

def wav_to_mel_frames(wav: np.ndarray) -> np.ndarray:
    """(T,) 16 kHz float wav → (n_frames, 40) power-mel frames.

    Matches ``librosa.feature.melspectrogram(y, 16000, n_fft=400,
    hop_length=160, n_mels=40).T`` (center=True reflect pad, periodic
    hann, power=2, slaney filterbank): resemblyzer/audio.py's
    wav_to_mel_spectrogram. No log compression: the GE2E net consumes
    raw power mels."""
    wav = np.asarray(wav, np.float32)
    pad = N_FFT // 2
    if len(wav) < 1:
        wav = np.zeros(1, np.float32)
    # np.pad reflect needs len > pad; zero pad for shorter input
    mode = "reflect" if len(wav) > pad else "constant"
    y = np.pad(wav, pad, mode=mode)
    n_frames = 1 + (len(y) - N_FFT) // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = y[idx] * np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2  # (n_frames, 201)
    return (spec @ _mel_basis().T).astype(np.float32)


_MEL_CACHE: np.ndarray | None = None


def _mel_basis() -> np.ndarray:
    global _MEL_CACHE
    if _MEL_CACHE is None:
        _MEL_CACHE = mel_filterbank(SAMPLE_RATE, N_FFT, N_MELS).astype(np.float32)
    return _MEL_CACHE


def normalize_volume(wav: np.ndarray, target_dbfs: float = TARGET_DBFS,
                     increase_only: bool = False,
                     decrease_only: bool = False) -> np.ndarray:
    """Scale to a target mean-power dBFS (resemblyzer/audio.py:49-58)."""
    power = float(np.mean(np.square(wav)))
    if power <= 0.0:
        return wav
    dbfs_change = target_dbfs - 10.0 * np.log10(power)
    if (dbfs_change < 0 and increase_only) or (
            dbfs_change > 0 and decrease_only):
        return wav
    return (wav * (10.0 ** (dbfs_change / 20.0))).astype(np.float32)


def trim_long_silences(wav: np.ndarray) -> np.ndarray:
    """Remove long silent stretches (resemblyzer/audio.py:61-102).

    Uses webrtcvad when importable (the reference's detector); otherwise
    an energy VAD on the same 30 ms grid: voiced = window RMS above -45
    dBFS (the signal is already normalized to -30), smoothed with the same
    width-8 asymmetric moving average and dilated with the same
    (max_silence+1)-wide structuring element."""
    n_windows = len(wav) // _VAD_WINDOW
    if n_windows < _VAD_SMOOTH:
        return wav
    wav_t = wav[: n_windows * _VAD_WINDOW]
    try:
        import webrtcvad

        vad = webrtcvad.Vad(3)
        pcm = (np.clip(wav_t, -1, 1) * 32767).astype(np.int16).tobytes()
        flags = np.array([
            vad.is_speech(
                pcm[i * _VAD_WINDOW * 2:(i + 1) * _VAD_WINDOW * 2],
                sample_rate=SAMPLE_RATE,
            )
            for i in range(n_windows)
        ], np.float32)
    except Exception:  # no webrtcvad: the energy VAD
        rms = np.sqrt(
            np.mean(wav_t.reshape(n_windows, _VAD_WINDOW) ** 2, axis=1)
        )
        flags = (rms > 10.0 ** (-45.0 / 20.0)).astype(np.float32)
    # width-8 moving average then binarize: resemblyzer's asymmetric
    # window [i-3, i+4] (zero-pad (w-1)//2 left, w//2 right)
    padded = np.concatenate([
        np.zeros((_VAD_SMOOTH - 1) // 2, np.float32), flags,
        np.zeros(_VAD_SMOOTH // 2, np.float32),
    ])
    csum = np.cumsum(padded, dtype=np.float64)
    csum[_VAD_SMOOTH:] = csum[_VAD_SMOOTH:] - csum[:-_VAD_SMOOTH]
    mask = (csum[_VAD_SMOOTH - 1:] / _VAD_SMOOTH) > 0.5
    if not mask.any():
        return wav
    # binary_dilation with a (max_silence+1)-wide structuring element:
    # width 7 centered ⇒ ±3 windows kept around speech
    width = _VAD_MAX_SILENCE + 1
    dil = np.zeros_like(mask)
    for off in range(-((width - 1) // 2), width // 2 + 1):
        lo, hi = max(0, off), min(n_windows, n_windows + off)
        dil[lo:hi] |= mask[max(0, -off): n_windows - max(0, off)]
    # resemblyzer discards the sub-window tail entirely
    return wav_t[np.repeat(dil, _VAD_WINDOW)]


def preprocess_wav(wav: np.ndarray, source_sr: int) -> np.ndarray:
    """resemblyzer.preprocess_wav equivalent: resample to 16 kHz,
    normalize to -30 dBFS (increase only), trim long silences."""
    wav = resample(np.asarray(wav, np.float32), source_sr, SAMPLE_RATE)
    wav = normalize_volume(wav, TARGET_DBFS, increase_only=True)
    return trim_long_silences(wav)


def compute_partial_slices(n_frames: int,
                           overlap: float = 0.5) -> list[slice]:
    """1.6 s (160-frame) partial windows at 50% overlap; the trailing
    partial is kept by sliding it back flush with the end (so coverage
    is exact)."""
    if n_frames <= PARTIAL_FRAMES:
        return [slice(0, n_frames)]
    step = max(1, int(round(PARTIAL_FRAMES * (1.0 - overlap))))
    starts = list(range(0, n_frames - PARTIAL_FRAMES + 1, step))
    if starts[-1] + PARTIAL_FRAMES < n_frames:
        starts.append(n_frames - PARTIAL_FRAMES)
    return [slice(s, s + PARTIAL_FRAMES) for s in starts]


# ---------------------------------------------------------------------------
# the GE2E network
# ---------------------------------------------------------------------------

def init_params(seed: int = 0) -> dict[str, np.ndarray]:
    """Random params in torch ``state_dict`` layout (uniform ±1/√H, the
    torch.nn.LSTM/Linear default), the JAX package's draws.

    The first layer's input weights are drawn 300× wider: power mels of
    -30 dBFS audio are ~1e-3, and at the torch default scale they vanish
    through the gates; every utterance would then embed to the same
    bias-driven point and the random-init path could not detect an
    input-ignoring bug."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(HIDDEN)

    def u(*shape):
        return rng.uniform(-k, k, shape).astype(np.float32)

    params: dict[str, np.ndarray] = {}
    for layer in range(N_LAYERS):
        in_dim = N_MELS if layer == 0 else HIDDEN
        params[f"lstm.weight_ih_l{layer}"] = u(4 * HIDDEN, in_dim)
        if layer == 0:
            params["lstm.weight_ih_l0"] = (
                300.0 * params["lstm.weight_ih_l0"]
            ).astype(np.float32)
        params[f"lstm.weight_hh_l{layer}"] = u(4 * HIDDEN, HIDDEN)
        params[f"lstm.bias_ih_l{layer}"] = u(4 * HIDDEN)
        params[f"lstm.bias_hh_l{layer}"] = u(4 * HIDDEN)
    params["linear.weight"] = u(EMBED, HIDDEN)
    params["linear.bias"] = u(EMBED)
    return params


def load_torch_state_dict(source) -> dict[str, np.ndarray]:
    """Load resemblyzer's ``pretrained.pt`` (or any state dict of the
    same network) into the torch-layout param dict this module uses.

    Accepts a path or an in-memory mapping; unwraps the ``model_state``
    envelope resemblyzer ships and strips ``module.`` DataParallel
    prefixes; raises ValueError naming missing and unexpected keys."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        source = torch.load(source, map_location="cpu")
    if "model_state" in source:  # resemblyzer checkpoint envelope
        source = source["model_state"]
    out: dict[str, np.ndarray] = {}
    for key, val in source.items():
        key = key.removeprefix("module.")
        if key.startswith(("lstm.", "linear.")):
            out[key] = np.asarray(
                val.detach().cpu().numpy()
                if hasattr(val, "detach") else val,
                np.float32,
            )
    expected = set(init_params())
    if set(out) != expected:
        missing = sorted(expected - set(out))
        unexpected = sorted(set(out) - expected)
        raise ValueError(
            f"speaker-encoder state dict mismatch: missing {missing}, "
            f"unexpected {unexpected}"
        )
    return out


class VoiceEncoderNet(nn.Module):
    """resemblyzer's VoiceEncoder stack: (B, T, 40) mel frames → (B, 256)
    unit-norm d-vectors (last layer's final hidden state → Linear → ReLU →
    row-wise L2 normalization)."""

    def __init__(self, device=None):
        super().__init__()
        self.lstm = nn.LSTM(N_MELS, HIDDEN, N_LAYERS, batch_first=True, device=device)
        self.linear = nn.Linear(HIDDEN, EMBED, device=device)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        _, (hidden, _) = self.lstm(frames)
        raw = F.relu(self.linear(hidden[-1]))
        return raw / torch.clamp(torch.linalg.norm(raw, dim=-1, keepdim=True), min=1e-8)


class BuiltinVoiceEncoder:
    """GE2E d-vector encoder without the resemblyzer package, on ``device``
    (CUDA by default).

    ``weights`` is a path to resemblyzer's ``pretrained.pt`` (real
    metric) or None for random init from ``seed`` (plumbing only; see the
    module docstring)."""

    def __init__(self, weights: str | None = None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.random_init = weights is None
        raw = init_params(seed) if weights is None else load_torch_state_dict(weights)
        # no init draws: the weights come from `raw` (global RNG untouched)
        self.net = torch.nn.utils.skip_init(VoiceEncoderNet, device=self.device)
        self.net.load_state_dict({k: torch.from_numpy(v) for k, v in raw.items()}, strict=True)
        self.net.eval()

    def embed_frames(self, frames: np.ndarray) -> np.ndarray:
        """(B, T, 40) mel frames → (B, 256) unit-norm d-vectors."""
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(self.device)
            return self.net(x).cpu().numpy()

    def embed_utterance(self, wav: np.ndarray,
                        source_sr: int = SAMPLE_RATE,
                        preprocess: bool = True) -> np.ndarray:
        """Raw wav → (256,) unit-norm utterance embedding (mean of
        partial embeddings, renormalized: VoiceEncoder.embed_utterance).

        Preprocessing (resample/normalize/trim) always runs so 16 kHz
        input takes the same path as any other rate; pass
        preprocess=False only for already-preprocessed wavs."""
        if preprocess:
            wav = preprocess_wav(wav, source_sr)
        mels = wav_to_mel_frames(wav)
        if len(mels) < PARTIAL_FRAMES:
            mels = np.pad(mels, ((0, PARTIAL_FRAMES - len(mels)), (0, 0)))
        parts = np.stack([mels[s] for s in compute_partial_slices(len(mels))])
        mean = self.embed_frames(parts).mean(axis=0)
        return mean / max(float(np.linalg.norm(mean)), 1e-8)
