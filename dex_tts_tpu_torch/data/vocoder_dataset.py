"""Waveform segments for vocoder GAN training (a copy of
dex_tts_tpu/data/vocoder_dataset.py on the port's `audio.wav`).

Upstream HiFi-GAN's MelDataset behaviour (random fixed-length crops,
zero-padded short files) without the host-side mel: the trainer feeds raw
waveform segments and computes both mels on the device inside the step
(`train.vocoder`). The crops come from ``np.random.default_rng(seed)``
with the JAX package's draws, so both give the same crops for one seed.

Sources: a list of wav paths, a directory (recursive ``*.wav``), or a TTS
filelist (``path|text|spk``; mel ``.npy`` paths are rewritten to the
preprocessor's trimmed-wav layout).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from dex_tts_tpu_torch.audio.wav import read_wav, resample


def wav_paths_from_source(source: str) -> list[str]:
    """Directory → recursive glob; filelist → first-column paths (mel
    ``.npy`` entries rewritten to the sibling trimmed-wav layout)."""
    if os.path.isdir(source):
        return sorted(glob.glob(os.path.join(source, "**", "*.wav"), recursive=True))
    paths = []
    with open(source) as f:
        for line in f:
            p = line.strip().split("|")[0]
            if not p:
                continue
            if p.endswith(".npy"):
                # .../mel/{spk}/{spk}-mel-{base}.npy → .../wav/{spk}/{base}.wav
                d, name = os.path.split(p)
                spk = os.path.basename(d)
                root = os.path.dirname(os.path.dirname(d))
                base = name.replace(f"{spk}-mel-", "").replace(".npy", "")
                p = os.path.join(root, "wav", spk, base + ".wav")
            paths.append(p)
    return paths


class WavSegmentDataset:
    """Random ``segment``-sample crops, resampled to ``sample_rate``.
    Decoded audio is cached up to ``cache_bytes`` (beyond that, files are
    read again per sample, so a large corpus cannot exhaust host memory).
    Short files are zero-padded (upstream HiFi-GAN)."""

    def __init__(self, paths: list[str], segment: int = 8192, sample_rate: int = 22050,
                 seed: int = 0, cache_bytes: int = 2 << 30):
        if not paths:
            raise ValueError("no wav files found")
        missing = [p for p in paths if not os.path.isfile(p)]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)}/{len(paths)} wav paths do not exist (first: {missing[0]}):"
                " check the filelist or layout now rather than thousands of steps into"
                " training"
            )
        self.paths = list(paths)
        self.segment = segment
        self.sample_rate = sample_rate
        self.rng = np.random.default_rng(seed)
        self.cache_bytes = cache_bytes
        self._cache: dict[int, np.ndarray] = {}
        self._cached_bytes = 0

    def __len__(self):
        return len(self.paths)

    def _load(self, i: int) -> np.ndarray:
        if i in self._cache:
            return self._cache[i]
        wav, sr = read_wav(self.paths[i])
        if sr != self.sample_rate:
            wav = resample(wav, sr, self.sample_rate)
        wav = wav.astype(np.float32)
        if self._cached_bytes + wav.nbytes <= self.cache_bytes:
            self._cache[i] = wav
            self._cached_bytes += wav.nbytes
        return wav

    def sample_segment(self, i: int) -> np.ndarray:
        wav = self._load(i)
        if len(wav) <= self.segment:
            out = np.zeros((self.segment,), np.float32)
            out[: len(wav)] = wav
            return out
        start = int(self.rng.integers(0, len(wav) - self.segment + 1))
        return wav[start: start + self.segment]

    def batches(self, batch_size: int, steps: int):
        """Yield ``steps`` batches {"wav": (B, S) float32} of random crops
        from random files (with replacement)."""
        for _ in range(steps):
            idx = self.rng.integers(0, len(self.paths), size=batch_size)
            yield {"wav": np.stack([self.sample_segment(int(i)) for i in idx])}
