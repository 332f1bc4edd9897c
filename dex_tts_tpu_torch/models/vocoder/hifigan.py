"""HiFi-GAN generator (mel → waveform), inference (port of
dex_tts_tpu/models/vocoder/hifigan.py).

reference: DEX-TTS/hifigan/models.py:112-174 with hifigan/config.json:
conv_pre(80→512, k7) → 4× [leaky(0.1) → ConvTranspose1d ×(8,8,2,2)], each
followed by the mean of 3 multi-dilation ResBlocks (k 3/7/11, d 1/3/5) →
leaky(0.01) → conv_post → tanh. Weight norm is folded into plain convs
(the reference calls remove_weight_norm() before inference). Parameter
names match the reference generator's state_dict.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from dex_tts_tpu_torch.models.dit import DTYPES
from dex_tts_tpu_torch.models.layers import run_in
from dex_tts_tpu_torch.utils import profiling

LRELU_SLOPE = 0.1


@dataclass(frozen=True)
class HiFiGANConfig:
    """Same fields and defaults as the JAX package's HiFiGANConfig.
    ``upsample_impl`` only chose a TPU lowering of the transposed conv:
    every value maps to ConvTranspose1d here."""

    num_mels: int = 80
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    dtype: str = "float32"
    upsample_impl: str = "conv_transpose"


def _same_pad(kernel: int, dilation: int = 1) -> int:
    return (kernel * dilation - dilation) // 2


def _normal_init(conv):
    # reference init of ups / resblock convs / conv_post: normal(0, 0.01)
    nn.init.normal_(conv.weight, 0.0, 0.01)
    return conv


class ResBlock(nn.Module):
    """3× [leaky → dilated conv → leaky → plain conv → +x].
    reference: DEX-TTS/hifigan/models.py:20-108 (ResBlock1)."""

    def __init__(self, channels: int, kernel_size: int, dilations: tuple):
        super().__init__()
        self.convs1 = nn.ModuleList(
            _normal_init(nn.Conv1d(channels, channels, kernel_size, dilation=d,
                                   padding=_same_pad(kernel_size, d)))
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            _normal_init(nn.Conv1d(channels, channels, kernel_size,
                                   padding=_same_pad(kernel_size)))
            for _ in dilations
        )

    def forward(self, x, dtype):
        for c1, c2 in zip(self.convs1, self.convs2):
            h = run_in(c1, F.leaky_relu(x, LRELU_SLOPE), dtype)
            h = run_in(c2, F.leaky_relu(h, LRELU_SLOPE), dtype)
            x = x + h
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(_normal_init(
                nn.ConvTranspose1d(c0 // (2**i), ch, k, u, padding=(k - u) // 2)
            ))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, tuple(rd)))
        self.conv_post = _normal_init(nn.Conv1d(ch, 1, 7, padding=3))

    def forward(self, mel):
        """mel: (B, num_mels, T) log-mel → waveform (B, T·hop) in [-1, 1]."""
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        n_k = len(cfg.resblock_kernel_sizes)
        x = run_in(self.conv_pre, mel, dt)
        for i, up in enumerate(self.ups):
            if profiling.TRACING:
                profiling.count_casts(dt, up.weight, up.bias)
            x = F.conv_transpose1d(
                F.leaky_relu(x, LRELU_SLOPE), up.weight.to(dt), up.bias.to(dt),
                up.stride, up.padding,
            )
            acc = None
            for j in range(n_k):
                out = self.resblocks[i * n_k + j](x, dt)
                acc = out if acc is None else acc + out
            x = acc / n_k
        x = self.conv_post(F.leaky_relu(x.float()))
        return torch.tanh(x)[:, 0]
