"""Retention-network text encoder core, parallel form (port of
dex_tts_tpu/models/retention.py).

With the shipped configs (use_softmax=True, use_decay=False) retention is
softmax attention over rotary-shifted q/k with a swish output gate, and
the decay mask is the padding-mask outer product.
reference: DEX-TTS/model/retnet.py:5-184, model/retention.py:49-514.
The recurrent and chunkwise forms are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dex_tts_tpu_torch.models.layers import AdaptiveLayerNorm, RMSNorm, drop_path, dropout


EPS = 1e-6  # the RMSNorms' epsilon (reference RetNetConfig.layernorm_eps)


@dataclass(frozen=True)
class RetNetEncoderConfig:
    """reference: DEX-TTS/model/retnet_cfg.py:14-117, the knobs the TTS text
    encoder sets (value width = embed width, gelu GLU, per-head decay
    without the LM schedule). Dropout, activation dropout and the
    drop-path rate (linear over the layers) act in train mode only."""

    embed_dim: int = 192
    ffn_dim: int = 1024
    num_layers: int = 8
    num_heads: int = 2
    dropout: float = 0.1
    activation_dropout: float = 0.0
    drop_path_rate: float = 0.1
    use_softmax: bool = True
    use_decay: bool = False
    use_adaln: bool = False


def _rotary_angle(key_dim: int) -> np.ndarray:
    half = key_dim // 2
    angle = 1.0 / (10000 ** np.linspace(0, 1, half))
    return np.repeat(angle, 2).astype(np.float32)


def _head_decay(num_heads: int) -> np.ndarray:
    """Per-head log-decay γ. reference: model/retention.py:82-88."""
    return np.log(1 - 2.0 ** (-5.0 - np.arange(num_heads))).astype(np.float32)


def rotate_every_two(x):
    """(…, 2k) → interleaved (-x_odd, x_even)."""
    return torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).reshape(x.shape)


def theta_shift(x, sin, cos):
    return x * cos + rotate_every_two(x) * sin


def rel_pos(cfg: RetNetEncoderConfig, slen: int, retention_mask):
    """Rotary sin/cos (T, D) + decay mask (B, H, T, T) for the parallel
    form; retention_mask (B, T) 0/1. reference: model/retention.py:136-161."""
    dev = retention_mask.device
    key_dim = cfg.embed_dim // cfg.num_heads
    angle = torch.from_numpy(_rotary_angle(key_dim)).to(dev)
    index = torch.arange(slen, dtype=torch.float32, device=dev)
    sin = torch.sin(index[:, None] * angle[None, :])
    cos = torch.cos(index[:, None] * angle[None, :])
    mask = (retention_mask[:, None, :] * retention_mask[:, :, None])[:, None]
    if cfg.use_decay:
        decay = torch.from_numpy(_head_decay(cfg.num_heads)).to(dev)
        diff = index[:, None] - index[None, :]
        dmask = torch.exp(diff[None] * decay[:, None, None])
        dmask = torch.where(mask > 0, dmask[None], torch.zeros((), device=dev))
        denom = torch.sqrt(dmask.sum(-1, keepdim=True))
        dmask = torch.where(denom > 0, dmask / denom, torch.zeros((), device=dev))
        return sin, cos, dmask
    return sin, cos, mask.expand(mask.shape[0], cfg.num_heads, slen, slen)


class MultiScaleRetention(nn.Module):
    """Parallel-form retention. reference: model/retention.py:183-295."""

    def __init__(self, cfg: RetNetEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.g_proj = nn.Linear(d, d, bias=False)
        self.out_proj = nn.Linear(d, d, bias=False)
        self.norm = RMSNorm(d // cfg.num_heads, EPS, False)

    def forward(self, x, sin, cos, decay_mask, train: bool = False):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_heads
        key_dim = d // h
        q = self.q_proj(x)
        k = self.k_proj(x) * key_dim**-0.5
        v = self.v_proj(x)
        g = self.g_proj(x)
        split = lambda a: a.reshape(b, t, h, key_dim).transpose(1, 2)
        qr = theta_shift(split(q), sin, cos)
        kr = theta_shift(split(k), sin, cos)
        v = split(v)

        scores = torch.einsum("bhtd,bhsd->bhts", qr.float(), kr.float())
        scores = scores * decay_mask
        if cfg.use_softmax:
            scores = scores.masked_fill(decay_mask == 0, -1e4)
            weights = scores.softmax(dim=-1)
        else:
            denom = scores.sum(-1, keepdim=True).detach().abs().clamp(min=1.0)
            weights = scores / denom
        weights = dropout(weights, 0.1, train)
        out = torch.einsum("bhts,bhsd->bhtd", weights, v.float()).to(x.dtype)
        out = self.norm(out.transpose(1, 2)).reshape(b, t, d)
        return self.out_proj(F.silu(g) * out)


class GLU(nn.Module):
    """gelu(fc1(x)) * gate(x) → fc2, with the tanh gelu that the JAX
    package's flax ``nn.gelu`` computes. reference: model/retention.py:346-380."""

    def __init__(self, cfg: RetNetEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.ffn_dim, bias=False)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.embed_dim, bias=False)
        self.gate = nn.Linear(cfg.embed_dim, cfg.ffn_dim, bias=False)

    def forward(self, x, train: bool = False):
        hidden = F.gelu(self.fc1(x).float(), approximate="tanh").to(x.dtype) * self.gate(x)
        hidden = dropout(hidden, self.cfg.activation_dropout, train)
        return dropout(self.fc2(hidden), self.cfg.dropout, train)


class RetNetEncoderLayer(nn.Module):
    """Pre-norm retention block, optional style AdaLN after each sublayer.
    reference: model/retention.py:397-514."""

    def __init__(self, cfg: RetNetEncoderConfig, depth: int = 0):
        super().__init__()
        self.cfg = cfg
        self.drop_prob = float(
            np.linspace(0, cfg.drop_path_rate, cfg.num_layers)[depth]
            if cfg.drop_path_rate > 0 else 0.0
        )
        self.retention = MultiScaleRetention(cfg)
        self.retention_layer_norm = RMSNorm(cfg.embed_dim, EPS)
        self.ffn = GLU(cfg)
        self.final_layer_norm = RMSNorm(cfg.embed_dim, EPS)
        self.use_adaln = cfg.use_adaln
        if cfg.use_adaln:
            self.adaln_1 = AdaptiveLayerNorm(cfg.embed_dim)
            self.adaln_2 = AdaptiveLayerNorm(cfg.embed_dim)

    def forward(self, x, sin, cos, decay_mask, sty=None, train: bool = False):
        h = self.retention(self.retention_layer_norm(x), sin, cos, decay_mask, train)
        h = dropout(h, self.cfg.dropout, train)
        x = x + drop_path(h, self.drop_prob, train)
        if self.use_adaln:
            x = self.adaln_1(x, sty)
        x = x + drop_path(self.ffn(self.final_layer_norm(x), train), self.drop_prob, train)
        if self.use_adaln:
            x = self.adaln_2(x, sty)
        return x


class RetNetEncoder(nn.Module):
    """Layer stack + final RMSNorm. reference: DEX-TTS/model/retnet.py:5-184."""

    def __init__(self, cfg: RetNetEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            RetNetEncoderLayer(cfg, i) for i in range(cfg.num_layers)
        )
        self.layer_norm = RMSNorm(cfg.embed_dim, EPS)

    def forward(self, x, retention_mask, sty=None, train: bool = False):
        """x (B, T, C); retention_mask (B, T) 0/1."""
        sin, cos, decay_mask = rel_pos(self.cfg, x.shape[1], retention_mask)
        for layer in self.layers:
            x = layer(x, sin, cos, decay_mask, sty, train)
        return self.layer_norm(x)
