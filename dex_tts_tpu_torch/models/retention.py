"""Retention-network text encoder core (port of
dex_tts_tpu/models/retention.py).

With the shipped configs (use_softmax=True, use_decay=False) retention is
softmax attention over rotary-shifted q/k with a swish output gate, and
the decay mask is the padding-mask outer product. The encoder runs the
parallel form; `recurrent_retention` and `chunkwise_retention` are the
decayed recurrent and chunkwise forms on plain tensors, which the
reference carries as dead code and the JAX package as working functions.
reference: DEX-TTS/model/retnet.py:5-184, model/retention.py:49-514.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dex_tts_tpu_torch.models.layers import AdaptiveLayerNorm, RMSNorm, drop_path, dropout


# the GLU activations with the JAX package's flax semantics: nn.gelu is
# the tanh form
ACTIVATIONS = {
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
    "swish": F.silu,
}


@dataclass(frozen=True)
class RetNetEncoderConfig:
    """reference: DEX-TTS/model/retnet_cfg.py:14-117, the knobs the TTS text
    encoder reads, with the JAX package's defaults (``use_glu`` is read
    nowhere there and is left out). Dropout, activation dropout and the
    drop-path rate (linear over the layers) act in train mode only.
    ``value_dim`` ≠ ``embed_dim`` runs in `MultiScaleRetention` alone: the
    encoder layer's residual needs them equal."""

    embed_dim: int = 192
    value_dim: int = 192
    ffn_dim: int = 1024
    num_layers: int = 8
    num_heads: int = 2
    dropout: float = 0.1
    activation_dropout: float = 0.0
    drop_path_rate: float = 0.1
    layernorm_eps: float = 1e-6
    activation: str = "gelu"
    use_softmax: bool = True
    use_decay: bool = False
    use_lm_decay: bool = False
    use_adaln: bool = False


def _rotary_angle(key_dim: int) -> np.ndarray:
    half = key_dim // 2
    angle = 1.0 / (10000 ** np.linspace(0, 1, half))
    return np.repeat(angle, 2).astype(np.float32)


def _head_decay(num_heads: int, use_lm_decay: bool = False) -> np.ndarray:
    """Per-head log-decay γ. reference: model/retention.py:82-88."""
    if use_lm_decay:
        s, e = np.log(1 / 32), np.log(1 / 512)
        return np.log(1 - np.exp(np.linspace(s, e, num_heads))).astype(np.float32)
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
        decay = torch.from_numpy(_head_decay(cfg.num_heads, cfg.use_lm_decay)).to(dev)
        diff = index[:, None] - index[None, :]
        dmask = torch.exp(diff[None] * decay[:, None, None])
        dmask = torch.where(mask > 0, dmask[None], torch.zeros((), device=dev))
        denom = torch.sqrt(dmask.sum(-1, keepdim=True))
        dmask = torch.where(denom > 0, dmask / denom, torch.zeros((), device=dev))
        return sin, cos, dmask
    return sin, cos, mask.expand(mask.shape[0], cfg.num_heads, slen, slen)


def recurrent_retention(q, k, v, decay):
    """The O(T) recurrent form of decayed retention: S_t = γ·S_{t-1} +
    k_tᵀ·v_t, o_t = q_t·S_t. q, k, v (B, H, T, D); decay (H,) log-decay γ →
    outputs (B, H, T, D) and the final state (B, H, D, D).
    reference: model/retention.py:99-107."""
    gamma = torch.exp(decay)[None, :, None, None]
    b, h, t, d = q.shape
    state = q.new_zeros((b, h, d, d))
    outs = []
    for i in range(t):
        state = gamma * state + k[:, :, i, :, None] * v[:, :, i, None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", q[:, :, i], state))
    return torch.stack(outs, dim=2), state


def chunkwise_retention(q, k, v, decay, chunk_size: int = 64):
    """Chunkwise decayed retention: parallel inside chunks of
    ``chunk_size``, recurrent across them; the outputs of
    `recurrent_retention`. T is padded with zeros to a multiple of the
    chunk, so the final state is the recurrent one only when T is such a
    multiple (the padded steps decay it further), as in the JAX package.
    reference: model/retention.py:108-135."""
    b, h, t, d = q.shape
    pad = (-t) % chunk_size
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
    c = chunk_size
    gamma = torch.exp(decay)  # (H,)
    idx = torch.arange(c, dtype=q.dtype, device=q.device)
    diff = idx[:, None] - idx[None, :]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    intra = torch.where(diff >= 0, gamma[:, None, None] ** diff[None], zero)  # γ^(i-j), i ≥ j
    q_decay = gamma[:, None] ** (idx + 1)[None, :]  # (H, C)
    k_decay = gamma[:, None] ** (c - 1 - idx)[None, :]
    cross = (gamma**c)[None, :, None, None]
    state = q.new_zeros((b, h, d, d))
    outs = []
    for start in range(0, q.shape[2], c):
        q_i, k_i, v_i = (a[:, :, start:start + c] for a in (q, k, v))
        inner = torch.einsum("bhcd,bhed->bhce", q_i, k_i) * intra[None]
        out = torch.einsum("bhce,bhed->bhcd", inner, v_i)
        out = out + torch.einsum("bhcd,bhde,hc->bhce", q_i, state, q_decay)
        state = cross * state + torch.einsum("bhcd,bhce,hc->bhde", k_i, v_i, k_decay)
        outs.append(out)
    return torch.cat(outs, dim=2)[:, :, :t], state


class MultiScaleRetention(nn.Module):
    """Parallel-form retention: q, k at ``embed_dim``, v, g and the output
    projection at ``value_dim`` (the JAX package's ``value_dim →
    value_dim`` out_proj). reference: model/retention.py:183-295."""

    def __init__(self, cfg: RetNetEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d, dv = cfg.embed_dim, cfg.value_dim
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, dv, bias=False)
        self.g_proj = nn.Linear(d, dv, bias=False)
        self.out_proj = nn.Linear(dv, dv, bias=False)
        self.norm = RMSNorm(dv // cfg.num_heads, cfg.layernorm_eps, False)

    def forward(self, x, sin, cos, decay_mask, train: bool = False):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_heads
        key_dim = d // h
        q = self.q_proj(x)
        k = self.k_proj(x) * key_dim**-0.5
        v = self.v_proj(x)
        g = self.g_proj(x)
        split = lambda a: a.reshape(b, t, h, a.shape[-1] // h).transpose(1, 2)
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
        out = self.norm(out.transpose(1, 2)).reshape(b, t, cfg.value_dim)
        return self.out_proj(F.silu(g) * out)


class GLU(nn.Module):
    """act(fc1(x)) * gate(x) → fc2, the activation (`ACTIVATIONS`) computed
    in f32. reference: model/retention.py:346-380."""

    def __init__(self, cfg: RetNetEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.ffn_dim, bias=False)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.embed_dim, bias=False)
        self.gate = nn.Linear(cfg.embed_dim, cfg.ffn_dim, bias=False)
        if cfg.activation not in ACTIVATIONS:
            raise ValueError(f"activation {cfg.activation!r} not in {sorted(ACTIVATIONS)}")

    def forward(self, x, train: bool = False):
        act = ACTIVATIONS[self.cfg.activation]
        hidden = act(self.fc1(x).float()).to(x.dtype) * self.gate(x)
        hidden = dropout(hidden, self.cfg.activation_dropout, train)
        return dropout(self.fc2(hidden), self.cfg.dropout, train)


class RetNetEncoderLayer(nn.Module):
    """Pre-norm retention block, optional style AdaLN after each sublayer.
    reference: model/retention.py:397-514."""

    def __init__(self, cfg: RetNetEncoderConfig, depth: int = 0):
        super().__init__()
        if cfg.value_dim != cfg.embed_dim:
            raise ValueError(
                f"the retention output (value_dim {cfg.value_dim}) is added to the"
                f" residual stream (embed_dim {cfg.embed_dim}): the widths must be equal"
            )
        self.cfg = cfg
        self.drop_prob = float(
            np.linspace(0, cfg.drop_path_rate, cfg.num_layers)[depth]
            if cfg.drop_path_rate > 0 else 0.0
        )
        self.retention = MultiScaleRetention(cfg)
        self.retention_layer_norm = RMSNorm(cfg.embed_dim, cfg.layernorm_eps)
        self.ffn = GLU(cfg)
        self.final_layer_norm = RMSNorm(cfg.embed_dim, cfg.layernorm_eps)
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
        self.layer_norm = RMSNorm(cfg.embed_dim, cfg.layernorm_eps)

    def forward(self, x, retention_mask, sty=None, train: bool = False):
        """x (B, T, C); retention_mask (B, T) 0/1."""
        sin, cos, decay_mask = rel_pos(self.cfg, x.shape[1], retention_mask)
        for layer in self.layers:
            x = layer(x, sin, cos, decay_mask, sty, train)
        return self.layer_norm(x)
