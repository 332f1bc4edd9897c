"""Mask / alignment-path utilities (port of dex_tts_tpu/ops/masks.py).

reference: DEX-TTS/model/utils.py:6-39.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dex_tts_tpu_torch.parallel import collectives


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths → (B, max_length) bool mask."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def fix_len_compatibility(length: int, num_downsamplings_in_unet: int = 2) -> int:
    """Round ``length`` up to a multiple of 2**num_downsamplings."""
    factor = 2 ** num_downsamplings_in_unet
    return int(-(-length // factor) * factor)


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations → binary monotonic alignment path.

    duration: (B, Tx) non-negative (float ok), mask: (B, Tx, Ty). Row x
    covers frames [cum[x-1], cum[x]).
    """
    t_y = mask.shape[2]
    cum = torch.cumsum(duration, dim=1)
    pos = torch.arange(t_y, device=cum.device, dtype=cum.dtype)
    upper = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    lower = F.pad(upper, (0, 0, 1, 0))[:, :-1]
    return (upper - lower) * mask


def duration_loss(logw, logw_, lengths):
    """MSE between predicted and MAS log-durations, normalised by
    Σlengths (over every data-parallel rank's rows).
    reference: DEX-TTS/model/utils.py:42-44."""
    return ((logw - logw_) ** 2).sum() / collectives.global_sum(lengths.sum())
