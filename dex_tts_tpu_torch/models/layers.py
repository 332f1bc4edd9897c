"""Shared building blocks (port of dex_tts_tpu/models/layers.py).

Layout follows the reference torch modules: sequences are (B, C, T),
images (B, C, H, W), masks (B, 1, T) multiplicative floats. Parameter
names match the reference state_dict. Parameters stay float32; where the
JAX package computes in a lower "compute dtype", `run_in` casts the
weights at the call, as flax's ``dtype=`` does.

Train mode is a ``train`` argument, as in the JAX package, never
``nn.Module.training``. Dropout, DropPath and the DiT's token mask draw
from an explicit generator, installed for a step with `dropout_generator`
(the JAX package's "dropout" rng); nothing reads the global RNG.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dex_tts_tpu_torch.parallel import collectives
from dex_tts_tpu_torch.parallel.tp import TensorParallelLinear


def run_in(mod: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Apply a Linear/Conv/ConvTranspose2d module with input, weight and
    bias cast to ``dtype`` (a no-op cast when they already are)."""
    if isinstance(mod, TensorParallelLinear):
        return mod(x, dtype)
    w = mod.weight.to(dtype)
    b = None if mod.bias is None else mod.bias.to(dtype)
    x = x.to(dtype)
    if isinstance(mod, nn.Linear):
        return F.linear(x, w, b)
    if isinstance(mod, nn.ConvTranspose2d):
        return F.conv_transpose2d(
            x, w, b, mod.stride, mod.padding, mod.output_padding, mod.groups,
            mod.dilation,
        )
    return mod._conv_forward(x, w, b)


_GENERATORS: list = []


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator):
    """Train-mode dropout, DropPath and token masks inside this block draw
    from ``generator`` (on the tensors' device)."""
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"train-mode dropout needs a torch.Generator, got {generator!r}")
    _GENERATORS.append(generator)
    try:
        yield generator
    finally:
        _GENERATORS.pop()


def train_uniform(shape, like: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) draws for a train-mode random mask, from the
    generator of the enclosing `dropout_generator` block; the leading axis
    is the batch's (`collectives.rand`)."""
    if not _GENERATORS:
        raise RuntimeError("train-mode dropout needs a generator: wrap the call in "
                           "layers.dropout_generator(generator)")
    return collectives.rand(shape, generator=_GENERATORS[-1], device=like.device)


def dropout(x, p: float, train: bool):
    """flax ``nn.Dropout``: keep each element with probability 1 - p and
    scale it by 1 / (1 - p); the identity outside train mode."""
    if not train or p == 0.0:
        return x
    keep = 1.0 - p
    return torch.where(train_uniform(x.shape, x) < keep, x / keep, torch.zeros_like(x))


def drop_path(x, p: float, train: bool):
    """Stochastic depth on the batch dim (timm drop_path).
    reference: DEX-TTS/model/retention.py:383-394."""
    if not train or p == 0.0:
        return x
    keep = 1.0 - p
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return torch.where(train_uniform(shape, x) < keep, x / keep, torch.zeros_like(x))


def batch_norm(bn: nn.BatchNorm1d, x, train: bool):
    """BatchNorm over (B, C, T) with flax's semantics. Eval: the running
    statistics. Train: batch statistics over (B, T) in f32 (variance
    E[x²] − E[x]², clipped at 0), and the running statistics updated in
    place as 0.99·running + 0.01·batch, with the biased variance (flax
    momentum 0.99 = torch momentum 0.01). Data-parallel: the sums of x and
    x² over every rank's rows, all-reduced with autograd, so every rank
    normalises by and records the global batch's statistics."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, bn.eps)
    xf = x.float()
    world = collectives.dp_world()
    if world > 1:
        sums = collectives.global_sum(torch.stack([xf.sum((0, 2)), (xf**2).sum((0, 2))]))
        mean, ex2 = sums / (xf.shape[0] * xf.shape[2] * world)
    else:
        mean, ex2 = xf.mean((0, 2)), (xf**2).mean((0, 2))
    var = torch.clamp(ex2 - mean**2, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(0.99).add_(mean.detach(), alpha=1 - 0.99)
        bn.running_var.mul_(0.99).add_(var.detach(), alpha=1 - 0.99)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((x - mean[None, :, None]) * mul[None, :, None] + bn.bias[None, :, None]).to(x.dtype)


def mish(x):
    """reference: DEX-TTS/model/diffusion.py:11-13."""
    return x * torch.tanh(F.softplus(x))


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, T), eps inside the sqrt.
    reference: DEX-TTS/model/text_encoder.py:11-29."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = ((x - mean) ** 2).mean(1, keepdim=True)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        return x * self.gamma[None, :, None] + self.beta[None, :, None]


class RMSNorm(nn.Module):
    """RMS norm over the last axis, statistics in f32.
    reference: DEX-TTS/model/retention.py:49-68."""

    def __init__(self, dim: int, eps: float = 1e-6, elementwise_affine=True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim)) if elementwise_affine else None

    def forward(self, x):
        xf = x.float()
        normed = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps))
        normed = normed.to(x.dtype)
        return normed * self.weight if self.weight is not None else normed


class AdaptiveLayerNorm(nn.Module):
    """Style-conditioned layer norm over the last axis of (B, T, C); scale
    and bias are linear maps of a global style vector (identity at init).
    reference: DEX-TTS/model/base.py:161-194."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.W_scale = nn.Linear(dim, dim)
        self.W_bias = nn.Linear(dim, dim)
        nn.init.zeros_(self.W_scale.weight)
        nn.init.ones_(self.W_scale.bias)
        nn.init.zeros_(self.W_bias.weight)
        nn.init.zeros_(self.W_bias.bias)

    def forward(self, x, sty):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.W_scale(sty)[:, None, :] + self.W_bias(sty)[:, None, :]


class ConvReluNorm(nn.Module):
    """Conv prenet: n_layers of [conv k → LN → relu → dropout], residual
    1x1 projection (zero at init). reference: DEX-TTS/model/text_encoder.py:32-63."""

    def __init__(self, channels: int, kernel_size: int = 5, n_layers: int = 3,
                 p_dropout: float = 0.5):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_layers = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=kernel_size // 2)
            for _ in range(n_layers)
        )
        self.norm_layers = nn.ModuleList(
            ChannelLayerNorm(channels) for _ in range(n_layers)
        )
        self.proj = nn.Conv1d(channels, channels, 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, mask, train: bool = False):
        org = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = dropout(torch.relu(norm(conv(x * mask))), self.p_dropout, train)
        return (org + self.proj(x)) * mask


class DurationPredictor(nn.Module):
    """Two [conv → relu → LN → dropout] blocks + 1x1 projection, all
    masked. reference: DEX-TTS/model/text_encoder.py:66-92 (out=1) and
    ref_encoder.py:8-34 (Projection, out=c_h)."""

    def __init__(self, c_in: int, c_h: int, out: int = 1, kernel_size: int = 3,
                 p_dropout: float = 0.1):
        super().__init__()
        self.p_dropout = p_dropout
        pad = kernel_size // 2
        self.conv_1 = nn.Conv1d(c_in, c_h, kernel_size, padding=pad)
        self.norm_1 = ChannelLayerNorm(c_h)
        self.conv_2 = nn.Conv1d(c_h, c_h, kernel_size, padding=pad)
        self.norm_2 = ChannelLayerNorm(c_h)
        self.proj = nn.Conv1d(c_h, out, 1)

    def forward(self, x, mask, train: bool = False):
        x = dropout(self.norm_1(torch.relu(self.conv_1(x * mask))), self.p_dropout, train)
        x = dropout(self.norm_2(torch.relu(self.conv_2(x * mask))), self.p_dropout, train)
        return self.proj(x * mask) * mask


class BasicConv(nn.Module):
    """Conv1d k3 without bias (+BatchNorm | LayerNorm) (+ReLU); the
    reference order is conv → BN → relu but conv → relu → LN. BatchNorm
    follows `batch_norm`. reference: DEX-TTS/model/base.py:34-65."""

    def __init__(self, c_in: int, c_out: int, relu: bool = True, norm=None):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, 3, padding=1, bias=False)
        self.relu = relu
        self.bn = nn.BatchNorm1d(c_out, eps=1e-5, momentum=0.01) if norm == "bn" else None
        self.ln = nn.LayerNorm(c_out, eps=1e-5) if norm == "ln" else None

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        if self.bn is not None:
            x = batch_norm(self.bn, x, train)
        if self.relu:
            x = torch.relu(x)
        if self.ln is not None:
            x = self.ln(x.transpose(1, 2)).transpose(1, 2)
        return x


def instance_norm_stats_1d(x, eps: float = 1e-5):
    """Per-(item, channel) mean/std over time of (B, C, T) → (B, C, 1),
    unbiased variance. reference: DEX-TTS/model/base.py:67-88."""
    mean = x.mean(-1, keepdim=True)
    n = x.shape[-1]
    var = ((x - mean) ** 2).sum(-1, keepdim=True) / max(n - 1, 1)
    return mean, torch.sqrt(var + eps)


def instance_norm_1d(x, eps: float = 1e-5):
    mean, std = instance_norm_stats_1d(x, eps)
    return (x - mean) / std


def instance_norm_stats_2d(x, eps: float = 1e-5):
    """(B, C, H, W) → mean/std (B, C, 1, 1) over H, W, unbiased variance.
    reference: DEX-TTS/model/base.py:90-114."""
    b, c = x.shape[:2]
    flat = x.reshape(b, c, -1)
    mean = flat.mean(-1)
    var = ((flat - mean[:, :, None]) ** 2).sum(-1) / max(flat.shape[-1] - 1, 1)
    return mean[:, :, None, None], torch.sqrt(var + eps)[:, :, None, None]


def sinusoidal_pos_emb(t, dim: int, scale: float = 1000.0):
    """Diffusion-time embedding, Grad-TTS convention (sin | cos).
    reference: DEX-TTS/model/diffusion.py:108-120."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1)
    )
    args = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimestepEmbedder(nn.Module):
    """DiT timestep embedding: sinusoid (cos | sin) → MLP(SiLU).
    reference: DEX-TTS/model/dit.py:219-256."""

    def __init__(self, hidden: int, freq: int = 256):
        super().__init__()
        self.freq = freq
        self.mlp = nn.Sequential(
            nn.Linear(freq, hidden), nn.SiLU(), nn.Linear(hidden, hidden)
        )

    def forward(self, t):
        half = self.freq // 2
        freqs = torch.exp(
            -math.log(10000.0)
            * torch.arange(half, dtype=torch.float32, device=t.device) / half
        )
        args = t[:, None].float() * freqs[None, :]
        return self.mlp(torch.cat([torch.cos(args), torch.sin(args)], dim=-1))
