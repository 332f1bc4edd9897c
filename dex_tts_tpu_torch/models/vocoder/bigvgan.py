"""BigVGAN generator (mel → waveform), inference (port of
dex_tts_tpu/models/vocoder/bigvgan.py).

reference: DEX-TTS/bigvgan/models.py:35-218, bigvgan/activations.py:9-119,
bigvgan/alias_free_torch/{filter,resample,act}.py. The HiFi-GAN skeleton
with anti-aliased periodic activations: every AMP-block activation is
2× Kaiser-sinc upsample → snake / snakebeta → 2× Kaiser-sinc downsample,
one call of `ops.snake.snake_antialias` (the Hopper kernel on the card).
Defaults match the released bigvgan_22khz_80band config;
``use_tanh_at_final`` / ``use_bias_at_final`` false give the BigVGAN-v2
head (e.g. bigvgan_v2_44khz_128band_512x): ``conv_post`` without a bias
and a clamp to [-1, 1] in place of ``tanh``.

The generator keeps PyTorch's (B, C, T) layout; each snake gets a
(B, T, C) transposed view, which the kernel reads through its strides.
Weight norm is folded into plain convs; parameter names match the
reference generator's state_dict (`ups.{i}.0`, `resblocks.{m}.convs1.{d}`,
`resblocks.{m}.activations.{j}.act.alpha`, `activation_post.act.beta`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from dex_tts_tpu_torch.models.dit import DTYPES
from dex_tts_tpu_torch.models.layers import run_in
from dex_tts_tpu_torch.models.vocoder.hifigan import stage_span
from dex_tts_tpu_torch.ops.snake import depthwise, kaiser_sinc_filter, snake_antialias
from dex_tts_tpu_torch.utils import profiling

CONV_IMPLS = ("auto", "plain", "packed")
UPSAMPLE_IMPLS = ("conv_transpose", "subpixel")


@dataclass(frozen=True)
class BigVGANConfig:
    """Same fields and defaults as the JAX package's BigVGANConfig.
    ``snake_impl``/``snake_pallas`` chose TPU lowerings of one function:
    every value runs the snake kernel on the card, and only decides, as
    in the JAX package, whether bf16 uses the polynomial sin².
    ``conv_impl`` ("packed") and ``upsample_impl`` ("subpixel") chose TPU
    lowerings of the same convolutions with the same parameters: every
    value maps to nn.Conv1d / nn.ConvTranspose1d here.
    ``use_tanh_at_final`` and ``use_bias_at_final`` (BigVGAN-v2's
    config.json keys; the port's own, v1's behaviour by default): the
    head's ``tanh`` (else a clamp to [-1, 1]) and ``conv_post``'s bias."""

    num_mels: int = 80
    upsample_rates: tuple = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: tuple = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock: str = "1"
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    dtype: str = "float32"
    snake_pallas: bool = False
    snake_impl: str = "auto"
    snake_taps: int = 12
    stage_dtypes: tuple | None = None
    upsample_impl: str = "conv_transpose"
    conv_impl: str = "auto"
    use_tanh_at_final: bool = True
    use_bias_at_final: bool = True


def upsample2x_antialias(x, ratio: int = 2, kernel_size: int | None = None):
    """(B, T, C) → (B, ratio·T, C): zero-stuff, then Kaiser-sinc
    interpolate (reference: bigvgan/alias_free_torch/resample.py:10-33)."""
    k = kernel_size if kernel_size is not None else int(6 * ratio // 2) * 2
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    filt = kaiser_sinc_filter(0.5 / ratio, 0.6 / ratio, k) * ratio
    t = x.shape[1]
    xp = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")  # (B, C, T')
    stuffed = x.new_zeros((xp.shape[0], xp.shape[1], xp.shape[2] * ratio))
    stuffed[..., ::ratio] = xp
    out = depthwise(F.pad(stuffed, (k - 1, k - 1)), [float(v) for v in filt[::-1]])
    return out[..., pad_left : pad_left + ratio * t].transpose(1, 2)


def downsample2x_antialias(x, ratio: int = 2, kernel_size: int | None = None):
    """(B, T, C) → (B, T/ratio, C): Kaiser-sinc low-pass + decimate
    (reference: bigvgan/alias_free_torch/resample.py:36-48)."""
    k = kernel_size if kernel_size is not None else int(6 * ratio // 2) * 2
    pad_left = k // 2 - int(k % 2 == 0)
    pad_right = k // 2
    filt = kaiser_sinc_filter(0.5 / ratio, 0.6 / ratio, k)
    xp = F.pad(x.transpose(1, 2), (pad_left, pad_right), mode="replicate")
    return depthwise(xp, [float(v) for v in filt], stride=ratio).transpose(1, 2)


def _reference_init(conv):
    # ups, AMP-block convs and conv_post: normal(0, 0.01) as in the
    # reference (bigvgan/models.py:19-22); zero bias as flax's default
    nn.init.normal_(conv.weight, 0.0, 0.01)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


def _same_pad(kernel: int, dilation: int = 1) -> int:
    return (kernel * dilation - dilation) // 2


class _SnakeParams(nn.Module):
    """The reference's Snake / SnakeBeta parameters (``alpha``, and
    ``beta`` for snakebeta), zeros in logscale, else ones."""

    def __init__(self, channels: int, variant: str, logscale: bool):
        super().__init__()
        init = torch.zeros if logscale else torch.ones
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels)) if variant == "snakebeta" else None


class SnakeActivation1d(nn.Module):
    """2× anti-aliased snake/snakebeta over (B, C, T): up → x +
    (1/β)·sin²(αx) → down. reference: bigvgan/alias_free_torch/act.py +
    activations.py:9-119."""

    def __init__(self, channels: int, variant: str = "snakebeta", logscale: bool = True,
                 use_pallas: bool = False, taps: int = 12, impl: str | None = None):
        super().__init__()
        self.act = _SnakeParams(channels, variant, logscale)
        self.logscale = logscale
        self.use_pallas = use_pallas
        self.taps = taps
        self.impl = impl

    def forward(self, x):
        alpha = self.act.alpha
        beta = alpha if self.act.beta is None else self.act.beta
        if self.logscale:
            alpha, beta = torch.exp(alpha), torch.exp(beta)
        # (C,)-sized: cast to the activation dtype, as the JAX package does
        if profiling.TRACING and not self.logscale:
            profiling.count_casts(x.dtype, alpha)
        alpha = alpha.to(x.dtype)
        inv_beta = (1.0 / (beta + 1e-9)).to(x.dtype)
        y = snake_antialias(x.transpose(1, 2), alpha, inv_beta, use_pallas=self.use_pallas,
                            kernel_size=self.taps, impl=self.impl)
        return y.transpose(1, 2)


class AMPBlock1(nn.Module):
    """3× [act → dilated conv → act → conv → +x].
    reference: DEX-TTS/bigvgan/models.py:35-94."""

    def __init__(self, channels, kernel_size, dilations, dtype, **act):
        super().__init__()
        self.dtype = DTYPES[dtype]
        self.convs1 = nn.ModuleList(
            _reference_init(nn.Conv1d(channels, channels, kernel_size, dilation=d,
                                      padding=_same_pad(kernel_size, d)))
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            _reference_init(nn.Conv1d(channels, channels, kernel_size,
                                      padding=_same_pad(kernel_size)))
            for _ in dilations
        )
        self.activations = nn.ModuleList(
            SnakeActivation1d(channels, **act) for _ in range(2 * len(dilations))
        )

    def forward(self, x):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            h = run_in(c1, self.activations[2 * i](x), self.dtype)
            h = run_in(c2, self.activations[2 * i + 1](h), self.dtype)
            x = x + h
        return x


class AMPBlock2(nn.Module):
    """2× [act → dilated conv → +x].
    reference: DEX-TTS/bigvgan/models.py:97-137."""

    def __init__(self, channels, kernel_size, dilations, dtype, **act):
        super().__init__()
        self.dtype = DTYPES[dtype]
        self.convs = nn.ModuleList(
            _reference_init(nn.Conv1d(channels, channels, kernel_size, dilation=d,
                                      padding=_same_pad(kernel_size, d)))
            for d in dilations[:2]
        )
        self.activations = nn.ModuleList(
            SnakeActivation1d(channels, **act) for _ in self.convs
        )

    def forward(self, x):
        for act, conv in zip(self.activations, self.convs):
            x = x + run_in(conv, act(x), self.dtype)
        return x


class BigVGANGenerator(nn.Module):
    """reference: DEX-TTS/bigvgan/models.py:138-218."""

    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        if cfg.conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {cfg.conv_impl!r} not in {CONV_IMPLS}")
        if cfg.upsample_impl not in UPSAMPLE_IMPLS:
            raise ValueError(f"upsample_impl {cfg.upsample_impl!r} not in {UPSAMPLE_IMPLS}")
        self.cfg = cfg
        self.stage_dtypes = cfg.stage_dtypes or (cfg.dtype,) * len(cfg.upsample_rates)
        if len(self.stage_dtypes) != len(cfg.upsample_rates):
            raise ValueError(f"stage_dtypes {self.stage_dtypes} must have one entry per"
                             f" upsample stage {cfg.upsample_rates}")
        c0 = cfg.upsample_initial_channel
        act = dict(variant=cfg.activation, logscale=cfg.snake_logscale,
                   use_pallas=cfg.snake_pallas, taps=cfg.snake_taps,
                   impl="pallas" if cfg.snake_pallas else cfg.snake_impl)
        block_cls = AMPBlock1 if cfg.resblock == "1" else AMPBlock2
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(nn.ModuleList([_reference_init(
                nn.ConvTranspose1d(c0 // (2**i), ch, k, u, padding=(k - u) // 2)
            )]))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(block_cls(ch, rk, tuple(rd), self.stage_dtypes[i], **act))
        self.activation_post = SnakeActivation1d(ch, **act)
        self.conv_post = _reference_init(nn.Conv1d(ch, 1, 7, padding=3,
                                                   bias=cfg.use_bias_at_final))

    def forward(self, mel):
        """mel: (B, num_mels, T) → waveform (B, T·Πrates) in [-1, 1], f32.
        Each upsample stage is a ``vocoder.stage`` span (`stage_span`);
        the first holds ``conv_pre``, the last the head."""
        n_k = len(self.cfg.resblock_kernel_sizes)
        last = len(self.ups) - 1
        x = mel
        for i, (up,) in enumerate(self.ups):
            dt = DTYPES[self.stage_dtypes[i]]
            with stage_span(self, i, mel):
                if i == 0:
                    x = run_in(self.conv_pre, mel, dt)
                if profiling.TRACING:
                    profiling.count_casts(dt, up.weight, up.bias)
                x = F.conv_transpose1d(x.to(dt), up.weight.to(dt), up.bias.to(dt),
                                       up.stride, up.padding)
                acc = None
                for j in range(n_k):
                    out = self.resblocks[i * n_k + j](x)
                    acc = out if acc is None else acc + out
                x = acc / n_k
                if i == last:
                    x = run_in(self.conv_post, self.activation_post(x), dt).float()
                    x = torch.tanh(x) if self.cfg.use_tanh_at_final else x.clamp(-1.0, 1.0)
        return x[:, 0]
