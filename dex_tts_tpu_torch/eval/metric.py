"""Objective metrics (port of dex_tts_tpu/eval/metric.py; only `mel_mae`
so far, the metric that periodic train-time synthesis prints)."""

from __future__ import annotations

import numpy as np


def mel_mae(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute error between two (n_mels, T) log-mels, cropped to the
    shorter length."""
    t = min(a.shape[-1], b.shape[-1])
    return float(np.mean(np.abs(a[..., :t] - b[..., :t])))
