"""Waveform IO and host-side preprocessing utilities (a copy of
dex_tts_tpu/audio/wav.py: numpy and scipy only).

Replaces the reference's librosa/soundfile usage
(reference: DEX-TTS/synthesize.py:40-62, preprocess/preprocessor/*.py) with
scipy-based equivalents: wav read/write, polyphase resampling, dB-threshold
silence trimming, peak normalization.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a wav file → (float32 mono signal in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, int(sr)


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 22050) -> None:
    """Write float signal as 22.05 kHz int16 (clamped), the reference's
    output format (reference: DEX-TTS/synthesize.py:104-112)."""
    scaled = np.asarray(wav, np.float32) * 32768.0
    # clip in the int16 domain: an exact +1.0 sample would hit 32768 and
    # wrap to -32768 under a bare astype
    wavfile.write(
        path, sample_rate, np.clip(scaled, -32768, 32767).astype(np.int16)
    )


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    g = np.gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def trim_silence(
    wav: np.ndarray,
    top_db: float = 30.0,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> np.ndarray:
    """Trim leading/trailing frames more than top_db below the peak RMS —
    librosa.effects.trim equivalent (reference: DEX-TTS/synthesize.py:47)."""
    if len(wav) < frame_length:
        return wav
    n_frames = 1 + (len(wav) - frame_length) // hop_length
    idx = (
        np.arange(n_frames)[:, None] * hop_length
        + np.arange(frame_length)[None, :]
    )
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=1))
    ref = rms.max()
    if ref <= 0:
        return wav
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return wav
    start = keep[0] * hop_length
    end = min(len(wav), keep[-1] * hop_length + frame_length)
    return wav[start:end]


def peak_normalize(wav: np.ndarray, peak: float = 1.0) -> np.ndarray:
    m = np.abs(wav).max()
    return wav if m == 0 else (wav / m * peak).astype(np.float32)
