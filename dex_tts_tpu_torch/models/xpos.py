"""xPos (extrapolatable position embedding) rotary helper (port of
dex_tts_tpu/models/xpos.py).

reference: DEX-TTS/model/xpos_relative_position.py:36-91, a standalone
rotary embedding with exponential length scaling that the reference
imports nowhere in the model path. Applying xPos to q and to k (with
``downscale``) keeps q·k a function of the offset between positions.
"""

from __future__ import annotations

import numpy as np
import torch


def fixed_pos_embedding(scale: torch.Tensor, offset: int = 0):
    """(T, D/2) scale grid → (sin, cos) tables at positions offset..offset+T."""
    t, half = scale.shape
    inv_freq = torch.from_numpy(1.0 / (10000 ** (np.arange(half) / half))).float()
    pos = torch.arange(offset, offset + t, dtype=torch.float32)
    sinusoid = torch.einsum("i,j->ij", pos, inv_freq).to(scale.device)
    return torch.sin(sinusoid), torch.cos(sinusoid)


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(…, 2k) → interleaved (-x_odd, x_even)."""
    return torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).reshape(x.shape)


def duplicate_interleave(m: torch.Tensor) -> torch.Tensor:
    """(T, D/2) → (T, D) with each column repeated twice, interleaved."""
    return torch.repeat_interleave(m, 2, dim=-1)


def apply_rotary_pos_emb(x, sin, cos, scale=1.0):
    sin = duplicate_interleave(sin * scale)
    cos = duplicate_interleave(cos * scale)
    return x * cos + rotate_every_two(x) * sin


class XPos:
    """reference: DEX-TTS/model/xpos_relative_position.py:36-82."""

    def __init__(self, head_dim: int, scale_base: int = 512):
        self.head_dim = head_dim
        self.scale_base = scale_base
        self.scale = (np.arange(0, head_dim, 2) + 0.4 * head_dim) / (1.4 * head_dim)

    def __call__(self, x: torch.Tensor, offset: int = 0, downscale: bool = False):
        """x: (B, T, head_dim)."""
        length = x.shape[1]
        min_pos = -(length + offset) // 2
        max_pos = length + offset + min_pos
        power = torch.arange(min_pos, max_pos, 1, dtype=torch.float32, device=x.device)
        power = power / self.scale_base
        scale = torch.as_tensor(self.scale, dtype=torch.float32, device=x.device)
        scale = scale[None, :] ** power[:, None]
        sin, cos = fixed_pos_embedding(scale, offset=0)
        sin, cos, scale = sin[-length:], cos[-length:], scale[-length:]
        if downscale:
            scale = 1.0 / scale
        return apply_rotary_pos_emb(x, sin, cos, scale)
