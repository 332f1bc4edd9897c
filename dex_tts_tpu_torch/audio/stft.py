"""STFT magnitude and log-mel features in PyTorch (port of
dex_tts_tpu/audio/stft.py; `istft` and `griffin_lim` are not ported).

Capability equivalent of the reference's conv-basis STFT
(reference: DEX-TTS/audio/stft.py:16-178, audio/audio_processing.py:85-87),
computed as framed ``torch.fft.rfft`` on the device of the signal. Numerics
match the JAX package: reflect padding of n_fft//2 on both sides, periodic
Hann window of win_length zero-centered inside n_fft, magnitude spectrum,
Slaney mel filterbank, log-compression ``log(clamp(x, 1e-5))``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dex_tts_tpu_torch.audio.mel import mel_filterbank


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic ("fftbins") Hann window, as scipy.signal.get_window('hann',
    n, fftbins=True)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    win = hann_window(win_length)
    if win_length < n_fft:
        pad = n_fft - win_length
        left = pad // 2
        win = np.pad(win, (left, pad - left))
    return win


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, T) → (B, n_frames, n_fft) frames after a centered reflect pad
    (T must exceed n_fft // 2)."""
    pad = n_fft // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    return y.unfold(1, n_fft, hop_length)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """Magnitude STFT of (B, T) audio → (B, 1 + n_fft//2, n_frames)."""
    window = torch.from_numpy(_padded_window(n_fft, win_length)).to(y.device)
    frames = frame_signal(y, n_fft, hop_length) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).abs().transpose(1, 2)


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0, clip_val: float = 1e-5):
    """reference: DEX-TTS/audio/audio_processing.py:85-87."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0):
    return torch.exp(x) / C


class MelSpectrogram:
    """Log-mel feature extractor on the device of its input. Equivalent
    capability to the reference's TacotronSTFT.mel_spectrogram
    (reference: DEX-TTS/audio/stft.py:130-178): returns (log-mel
    (B, n_mels, T'), energy (B, T'))."""

    def __init__(
        self,
        n_fft: int = 1024,
        hop_length: int = 256,
        win_length: int = 1024,
        n_mels: int = 80,
        sample_rate: int = 22050,
        fmin: float = 0.0,
        fmax: float = 8000.0,
    ):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.mel_basis = torch.from_numpy(
            mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
        )

    def __call__(self, y: torch.Tensor):
        mag = stft_magnitude(y, self.n_fft, self.hop_length, self.win_length)
        mel = torch.einsum("mf,bft->bmt", self.mel_basis.to(y.device), mag)
        return dynamic_range_compression(mel), torch.linalg.norm(mag, dim=1)
