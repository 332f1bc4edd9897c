"""SpecAugment-style feature augmentation for style inputs (DEX only);
a copy of dex_tts_tpu/data/augmentation.py.

Behavioral equivalent of reference: DEX-TTS/model/augmentation.py:9-73 —
per-item time masking ('T'), frequency masking ('F'), or circular time
shift ('S'); 'N' = off. Runs host-side on numpy (data pipeline), matching
where the reference applies it (src/dataset.py:125-127).
"""

from __future__ import annotations

import numpy as np


def time_mask(feat: np.ndarray, rng: np.random.Generator, time_mask_para: int):
    """Zero a random time span (1-D or 2-D feature, time last)."""
    t = int(rng.uniform(0, time_mask_para))
    length = feat.shape[-1]
    if length <= t or t == 0:
        return feat
    t0 = int(rng.integers(0, length - t))
    out = feat.copy()
    out[..., t0 : t0 + t] = 0.0
    return out


def freq_mask(feat: np.ndarray, rng: np.random.Generator, freq_mask_para: int):
    """Zero a random frequency band (2-D feature, freq first)."""
    if feat.ndim < 2:
        return feat
    f = int(rng.uniform(0, freq_mask_para))
    n_freq = feat.shape[0]
    if n_freq <= f or f == 0:
        return feat
    f0 = int(rng.integers(0, n_freq - f))
    out = feat.copy()
    out[f0 : f0 + f, :] = 0.0
    return out


def time_shift(feat: np.ndarray, rng: np.random.Generator):
    """Circular shift along time."""
    length = feat.shape[-1]
    shift = int(rng.integers(0, length))
    return np.roll(feat, shift, axis=-1)


def augment_feature(
    feat: np.ndarray,
    rng: np.random.Generator,
    aug_type: str = "N",
    time_mask_para: int = 27,
    freq_mask_para: int = 50,
) -> np.ndarray:
    if aug_type == "T":
        return time_mask(feat, rng, time_mask_para)
    if aug_type == "F":
        return freq_mask(feat, rng, freq_mask_para)
    if aug_type == "S":
        return time_shift(feat, rng)
    return feat
