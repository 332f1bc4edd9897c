"""Slaney-style mel filterbank, self-contained (a copy of
dex_tts_tpu/audio/mel.py: numpy only).

Numerically equivalent to ``librosa.filters.mel(sr, n_fft, n_mels, fmin,
fmax)`` with default ``htk=False, norm='slaney'`` — the filterbank the
reference builds at DEX-TTS/audio/stft.py:144-149. librosa is not in the
runtime image, so the Slaney formulas are implemented directly.
"""

from __future__ import annotations

import numpy as np

# Slaney mel scale constants: linear below 1 kHz, log above.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs
    )
    return freqs


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank (n_mels, 1 + n_fft//2), Slaney-normalized."""
    if fmax is None:
        fmax = sample_rate / 2.0

    fft_freqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney: scale each filter to constant energy per channel.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
