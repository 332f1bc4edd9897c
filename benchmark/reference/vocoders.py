"""Plain HiFi-GAN V1 and BigVGAN generators in float32, inference.

HiFi-GAN: jik876/hifi-gan models.py (Generator, ResBlock1) with weight
norm folded, as DEX-TTS/hifigan/models.py runs it after
remove_weight_norm(). BigVGAN: NVIDIA/BigVGAN models.py (AMPBlock1) and
alias_free_torch/{filter,resample,act}.py: each activation is a 2×
Kaiser-sinc upsample (a transposed convolution), snake or snakebeta with
the exact sine, and a Kaiser-sinc low-pass decimating by 2, with the
original's replicate padding. Parameter names are the reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _pad(kernel: int, dilation: int = 1) -> int:
    return (kernel * dilation - dilation) // 2


def _tuple(v):
    return tuple(_tuple(x) for x in v) if isinstance(v, (list, tuple)) else v


class ResBlock1(nn.Module):
    def __init__(self, ch, k, dilations, act=None):
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(ch, ch, k, dilation=d, padding=_pad(k, d))
                                    for d in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(ch, ch, k, padding=_pad(k)) for _ in dilations)
        if act is not None:
            self.activations = nn.ModuleList(act(ch) for _ in range(2 * len(dilations)))

    def forward(self, x):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            if hasattr(self, "activations"):
                h = c2(self.activations[2 * i + 1](c1(self.activations[2 * i](x))))
            else:
                h = c2(F.leaky_relu(c1(F.leaky_relu(x, 0.1)), 0.1))
            x = x + h
        return x


class HiFiGAN(nn.Module):
    def __init__(self, c):
        super().__init__()
        c0 = c["upsample_initial_channel"]
        self.n_k = len(c["resblock_kernel_sizes"])
        self.conv_pre = nn.Conv1d(c["num_mels"], c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
            ch = c0 // 2 ** (i + 1)
            self.ups.append(nn.ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2))
            for rk, rd in zip(c["resblock_kernel_sizes"], _tuple(c["resblock_dilation_sizes"])):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel):
        x = self.conv_pre(mel)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, 0.1))
            x = sum(self.resblocks[i * self.n_k + j](x) for j in range(self.n_k)) / self.n_k
        return torch.tanh(self.conv_post(F.leaky_relu(x)))[:, 0]


def kaiser_sinc(cutoff: float, half_width: float, k: int) -> np.ndarray:
    """alias_free_torch/filter.py kaiser_sinc_filter1d, as float64."""
    half = k // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    beta = (0.1102 * (a - 8.7) if a > 50 else
            0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21) if a >= 21 else 0.0)
    t = np.arange(-half, half) + 0.5 if k % 2 == 0 else np.arange(k) - half
    f = 2 * cutoff * np.kaiser(k, beta) * np.sinc(2 * cutoff * t)
    return f / f.sum()


class _SnakeParams(nn.Module):
    def __init__(self, ch: int, beta: bool):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(ch))
        self.beta = nn.Parameter(torch.zeros(ch)) if beta else None


class Activation1d(nn.Module):
    """up 2× → x + sin²(αx)/β → down 2× over (B, C, T)."""

    def __init__(self, ch: int, variant: str, logscale: bool, taps: int):
        super().__init__()
        self.act = _SnakeParams(ch, variant == "snakebeta")
        self.logscale, self.k = logscale, taps
        filt = kaiser_sinc(0.25, 0.3, taps)
        self.register_buffer("filter", torch.tensor(filt, dtype=torch.float32), persistent=False)

    def forward(self, x):
        c, k = x.shape[1], self.k
        w = self.filter.to(x.device)[None, None].expand(c, 1, -1)
        pad = k // 2 - 1
        pad_left = pad * 2 + (k - 2) // 2
        pad_right = pad * 2 + (k - 2 + 1) // 2
        u = 2 * F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), w, stride=2, groups=c)
        u = u[..., pad_left:-pad_right]
        alpha = self.act.alpha
        beta = alpha if self.act.beta is None else self.act.beta
        if self.logscale:
            alpha, beta = torch.exp(alpha), torch.exp(beta)
        s = u + torch.sin(u * alpha[:, None]) ** 2 / (beta[:, None] + 1e-9)
        s = F.pad(s, (k // 2 - 1, k // 2), mode="replicate")  # k even
        return F.conv1d(s, w, stride=2, groups=c)


class BigVGAN(nn.Module):
    def __init__(self, c):
        super().__init__()
        c0 = c["upsample_initial_channel"]
        self.n_k = len(c["resblock_kernel_sizes"])

        def act(ch):
            return Activation1d(ch, c["activation"], c["snake_logscale"], c["snake_taps"])

        self.conv_pre = nn.Conv1d(c["num_mels"], c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
            ch = c0 // 2 ** (i + 1)
            up = nn.ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2)
            self.ups.append(nn.ModuleList([up]))
            for rk, rd in zip(c["resblock_kernel_sizes"], _tuple(c["resblock_dilation_sizes"])):
                self.resblocks.append(ResBlock1(ch, rk, rd, act))
        self.activation_post = act(ch)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel):
        x = self.conv_pre(mel)
        for i, (up,) in enumerate(self.ups):
            x = up(x)
            x = sum(self.resblocks[i * self.n_k + j](x) for j in range(self.n_k)) / self.n_k
        return torch.tanh(self.conv_post(self.activation_post(x)))[:, 0]

