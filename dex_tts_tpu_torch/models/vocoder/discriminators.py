"""GAN critics and adversarial losses for vocoder training (port of
dex_tts_tpu/models/vocoder/discriminators.py).

reference: DEX-TTS/bigvgan/models.py:221-400. The multi-period critic
(MPD: the waveform folded by period, a Conv2d stack) and the
multi-resolution critic (MRD: magnitude STFTs at several resolutions, a
Conv2d stack), the least-squares GAN losses and the feature-matching
loss. As in the JAX package the convs are plain (no weight norm) and
start from flax's default init: truncated-normal LeCun kernels, zero
biases. Modules are named as the flax ones (``p{period}.conv_{i}``,
``r{i}.conv_{i}``, ``conv_post``), so `convert.discriminators_flax_to_torch`
maps them one to one. Layout is PyTorch's NCHW: H is time (the waveform
folded by period, or the STFT frames), W the period or frequency bins;
feature maps are NCHW where flax's are NHWC.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from dex_tts_tpu_torch.audio.stft import stft_magnitude_uncentered

LRELU_SLOPE = 0.1
# the standard deviation of a standard normal truncated to [-2, 2]: flax's
# truncated_normal initializer divides by it to keep the variance
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class DiscriminatorConfig:
    mpd_periods: tuple = (2, 3, 5, 7, 11)
    mrd_resolutions: tuple = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
    channel_mult: float = 1.0


def _conv(c_in: int, c_out: int, kernel, stride=(1, 1), padding=(0, 0)) -> nn.Conv2d:
    """nn.Conv2d with flax's default nn.Conv init: kernel ~ truncated
    normal with variance 1/fan_in (lecun_normal), bias 0."""
    conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding)
    std = math.sqrt(1.0 / (c_in * kernel[0] * kernel[1])) / _TRUNC_STD
    nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std)
    nn.init.zeros_(conv.bias)
    return conv


class PeriodDiscriminator(nn.Module):
    """reference: DEX-TTS/bigvgan/models.py:221-255."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channel_mult: float = 1.0):
        super().__init__()
        self.period = period
        k, pad = kernel_size, kernel_size // 2
        widths = [int(w * channel_mult) for w in (32, 128, 512, 1024)]
        c_in = 1
        for i, w in enumerate(widths):
            self.add_module(f"conv_{i}", _conv(c_in, w, (k, 1), (stride, 1), (pad, 0)))
            c_in = w
        self.conv_4 = _conv(c_in, int(1024 * channel_mult), (k, 1), padding=(2, 0))
        self.conv_post = _conv(int(1024 * channel_mult), 1, (3, 1), padding=(1, 0))

    def forward(self, x):
        """x: (B, T) waveform → (logits (B, N), feature maps)."""
        b, t = x.shape
        pad = (-t) % self.period
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
            t += pad
        h = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for i in range(5):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


class ResolutionDiscriminator(nn.Module):
    """reference: DEX-TTS/bigvgan/models.py:283-333."""

    SPECS = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
             ((3, 9), (1, 2), (1, 4)), ((3, 3), (1, 1), (1, 1)))

    def __init__(self, resolution: tuple, channel_mult: float = 1.0):
        super().__init__()
        self.resolution = tuple(resolution)  # (n_fft, hop, win)
        ch = int(32 * channel_mult)
        for i, (k, s, p) in enumerate(self.SPECS):
            self.add_module(f"conv_{i}", _conv(1 if i == 0 else ch, ch, k, s, p))
        self.conv_post = _conv(ch, 1, (3, 3), padding=(1, 1))

    def forward(self, x):
        """x: (B, T) waveform → (logits (B, N), feature maps)."""
        n_fft, hop, win = self.resolution
        pad = (n_fft - hop) // 2
        xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
        mag = stft_magnitude_uncentered(xp, n_fft, hop, win)  # (B, F, T')
        h = mag.transpose(1, 2)[:, None]  # (B, 1, T', F)
        fmap = []
        for i in range(len(self.SPECS)):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(x.shape[0], -1), fmap


class _MultiDiscriminator(nn.Module):
    def forward(self, y, y_hat):
        """Real ``y`` and generated ``y_hat`` (B, T) through every
        sub-critic → (real logits, fake logits, real feature maps, fake
        feature maps), one entry per sub-critic."""
        reals, fakes, fmap_r, fmap_g = [], [], [], []
        for d in self.children():
            r, fr = d(y)
            g, fg = d(y_hat)
            reals.append(r)
            fakes.append(g)
            fmap_r.append(fr)
            fmap_g.append(fg)
        return reals, fakes, fmap_r, fmap_g


class MultiPeriodDiscriminator(_MultiDiscriminator):
    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig()):
        super().__init__()
        for p in cfg.mpd_periods:
            self.add_module(f"p{p}", PeriodDiscriminator(p, channel_mult=cfg.channel_mult))


class MultiResolutionDiscriminator(_MultiDiscriminator):
    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig()):
        super().__init__()
        for i, res in enumerate(cfg.mrd_resolutions):
            self.add_module(f"r{i}", ResolutionDiscriminator(res, channel_mult=cfg.channel_mult))


def feature_loss(fmap_r, fmap_g):
    """reference: DEX-TTS/bigvgan/models.py:368-374."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(real_outputs, fake_outputs):
    """LSGAN critic objective → (loss, real terms, fake terms).
    reference: DEX-TTS/bigvgan/models.py:377-389."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outputs, fake_outputs):
        r = torch.mean((1.0 - dr) ** 2)
        g = torch.mean(dg ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(fake_outputs):
    """LSGAN generator objective → (loss, per-critic terms).
    reference: DEX-TTS/bigvgan/models.py:392-400."""
    loss = 0.0
    gen_losses = []
    for dg in fake_outputs:
        term = torch.mean((1.0 - dg) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses
