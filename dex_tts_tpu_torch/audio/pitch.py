"""F0 (pitch) extraction for the lf0 style path (a copy of
dex_tts_tpu/audio/pitch.py: numpy only).

The reference uses pyworld DIO + stonemask at a hop-aligned frame period
(reference: DEX-TTS/preprocess/preprocessor/preprocessor.py:113-127,
synthesize.py:52-58). pyworld is not in the runtime image, so the default
here is a self-contained normalized-autocorrelation tracker (NCCF-style:
per-frame peak of the normalized autocorrelation within the plausible pitch
band, with a voicing threshold). If pyworld *is* importable it is used
instead for bit-level parity with reference features.
"""

from __future__ import annotations

import numpy as np

try:  # parity seam: prefer pyworld when present
    import pyworld  # type: ignore

    HAS_PYWORLD = True
except ImportError:  # pragma: no cover - image has no pyworld
    pyworld = None
    HAS_PYWORLD = False


def extract_f0(
    wav: np.ndarray,
    sample_rate: int = 22050,
    hop_length: int = 256,
    f0_min: float = 71.0,
    f0_max: float = 800.0,
    voicing_threshold: float = 0.3,
) -> np.ndarray:
    """Per-frame F0 in Hz, 0 for unvoiced. Frame count = len(wav)//hop + 1
    (matches the mel frame grid)."""
    if HAS_PYWORLD:  # pragma: no cover
        frame_period = hop_length / sample_rate * 1000.0
        f0, t = pyworld.dio(
            wav.astype(np.float64), sample_rate, frame_period=frame_period
        )
        f0 = pyworld.stonemask(wav.astype(np.float64), f0, t, sample_rate)
        return f0.astype(np.float32)
    return _autocorr_f0(
        wav, sample_rate, hop_length, f0_min, f0_max, voicing_threshold
    )


def _autocorr_f0(wav, sample_rate, hop_length, f0_min, f0_max, threshold):
    lag_min = int(sample_rate / f0_max)
    lag_max = int(sample_rate / f0_min)
    frame_length = 2 * lag_max
    n_frames = len(wav) // hop_length + 1

    pad = frame_length
    padded = np.pad(wav.astype(np.float64), (pad // 2, pad))
    f0 = np.zeros(n_frames, np.float32)

    centers = np.arange(n_frames) * hop_length + pad // 2
    idx = centers[:, None] + np.arange(frame_length)[None, :] - frame_length // 2
    idx = np.clip(idx, 0, len(padded) - 1)
    frames = padded[idx]  # (n_frames, frame_length)
    frames = frames - frames.mean(axis=1, keepdims=True)

    # normalized autocorrelation via FFT
    nfft = 1 << int(np.ceil(np.log2(2 * frame_length)))
    spec = np.fft.rfft(frames, nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, : lag_max + 1]
    ac0 = np.maximum(ac[:, :1], 1e-10)
    nac = ac / ac0

    band = nac[:, lag_min : lag_max + 1]
    best = np.argmax(band, axis=1)
    peak = band[np.arange(n_frames), best]
    lag = best + lag_min

    # parabolic interpolation around the peak for sub-sample lag
    valid = (lag > lag_min) & (lag < lag_max)
    l = lag.astype(np.float64)
    a = nac[np.arange(n_frames), np.clip(lag - 1, 0, lag_max)]
    b = nac[np.arange(n_frames), lag]
    c = nac[np.arange(n_frames), np.clip(lag + 1, 0, lag_max)]
    denom = a - 2 * b + c
    shift = np.where(
        valid & (np.abs(denom) > 1e-12), 0.5 * (a - c) / np.where(denom == 0, 1, denom), 0.0
    )
    l = l + np.clip(shift, -1, 1)

    voiced = peak > threshold
    # energy gate: silent frames are unvoiced
    energy = np.sqrt((frames**2).mean(axis=1))
    voiced &= energy > max(1e-4, 0.02 * energy.max())
    f0[voiced] = (sample_rate / l[voiced]).astype(np.float32)
    f0[(f0 < f0_min) | (f0 > f0_max)] = 0.0
    return f0


def extract_lf0(wav: np.ndarray, sample_rate: int = 22050, hop_length: int = 256) -> np.ndarray:
    """log-F0 on voiced frames, 0 elsewhere — the feature stored by the
    offline preprocessor (reference: preprocessor.py:113-127)."""
    f0 = extract_f0(wav, sample_rate, hop_length)
    lf0 = np.zeros_like(f0)
    voiced = f0 > 0
    lf0[voiced] = np.log(f0[voiced])
    return lf0


def normalize_lf0(lf0: np.ndarray) -> np.ndarray:
    """Per-utterance z-norm over voiced frames
    (reference: DEX-TTS/src/dataset.py:57-70)."""
    lf0 = lf0.astype(np.float32).copy()
    voiced = lf0 != 0
    if voiced.any():
        mean = lf0[voiced].mean()
        std = lf0[voiced].std()
        if std == 0:
            lf0 -= mean
        else:
            lf0 = (lf0 - mean) / (std + 1e-8)
        lf0[~voiced] = 0.0
    return lf0
