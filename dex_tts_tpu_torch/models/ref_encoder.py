"""Reference-speech style modelling (DEX only): time-variable (TV) and
time-invariant (TIV) style encoders, lf0 encoder, the EMA vector quantizer,
and the two bottleneck adaptors (port of dex_tts_tpu/models/ref_encoder.py).

reference: DEX-TTS/model/ref_encoder.py:8-273. Sequences are (B, C, T),
masks (B, 1, T), the U-Net mid feature (B, C, H, W).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dex_tts_tpu_torch.models.layers import (
    BasicConv,
    DurationPredictor,
    instance_norm_1d,
    instance_norm_stats_1d,
    instance_norm_stats_2d,
    run_in,
)
from dex_tts_tpu_torch.parallel import collectives


class Projection(DurationPredictor):
    """conv→relu→LN→dropout(0.1) ×2 → 1x1 proj to c_h, all masked.
    reference: DEX-TTS/model/ref_encoder.py:8-34."""

    def __init__(self, c_in: int, c_h: int, kernel_size: int = 3):
        super().__init__(c_in, c_h, c_h, kernel_size, p_dropout=0.1)


class LF0Encoder(nn.Module):
    """conv → bidirectional GRU → conv, plus a projection branch for the
    decoder. reference: DEX-TTS/model/ref_encoder.py:36-55."""

    def __init__(self, c_h=192, c_out=192, c_out_g=192, num_layer=2):
        super().__init__()
        self.in_conv = BasicConv(1, c_h, relu=True, norm="ln")
        self.rnn_layer = nn.GRU(
            c_h, c_h // 2, num_layer, batch_first=True, bidirectional=True
        )
        self.out_conv = BasicConv(c_h, c_out, relu=True, norm="ln")
        self.proj = Projection(c_out, c_out_g)

    def forward(self, lf0, mask, train: bool = False):
        """lf0 (B, T), mask (B, 1, T) → (enc (B, c_out, T), dec (B, c_out_g, T));
        the decoder branch sees the encoder output detached."""
        x = self.in_conv(lf0[:, None, :] * mask) * mask
        x, _ = self.rnn_layer(x.transpose(1, 2))
        x = self.out_conv(x.transpose(1, 2) * mask) * mask
        return x, self.proj(x.detach(), mask, train)


class ResidualConvBlock(nn.Module):
    """x + conv(c→h, norm, relu) → conv(h→c, plain).
    reference: DEX-TTS/model/ref_encoder.py:57-81 (TIV: BN, TV: LN)."""

    def __init__(self, c: int, c_h: int, norm: str):
        super().__init__()
        self.conv_block = nn.Sequential(
            BasicConv(c, c_h, relu=True, norm=norm),
            BasicConv(c_h, c, relu=False, norm=None),
        )

    def forward(self, x, train: bool = False):
        return x + self.conv_block[1](self.conv_block[0](x, train))


class VQEmbeddingEMA(nn.Module):
    """EMA-updated vector quantizer with a straight-through estimator.
    The codebook state (``embedding``, ``ema_count``, ``ema_weight``) is
    buffers, updated in place under no_grad in train mode, as the JAX
    package updates its "vq_stats" collection. Data-parallel: the counts,
    the sums and the commitment's denominator are the global batch's.
    reference: DEX-TTS/model/ref_encoder.py:181-237."""

    def __init__(self, n_embeddings: int = 512, embedding_dim: int = 192,
                 commitment_cost: float = 0.25, decay: float = 0.999, epsilon: float = 1e-5):
        super().__init__()
        self.commitment_cost = commitment_cost
        self.decay = decay
        self.epsilon = epsilon
        bound = 1.0 / n_embeddings
        emb = torch.empty(n_embeddings, embedding_dim).uniform_(-bound, bound)
        self.register_buffer("embedding", emb)
        self.register_buffer("ema_count", torch.zeros(n_embeddings))
        self.register_buffer("ema_weight", emb.clone())

    def forward(self, x, mask, train: bool = False):
        """x (B, T, D), mask (B, T, 1) → (quantized (B, T, D), commitment
        loss). Train mode moves the codebook after the lookup."""
        x = x * mask
        m, d = self.embedding.shape
        codes = self.embedding
        flat = x.detach().reshape(-1, d)
        dist = (
            (codes**2).sum(1)[None, :]
            + (flat**2).sum(1, keepdim=True)
            - 2.0 * flat @ codes.t()
        )
        indices = dist.argmin(-1)
        quant = codes[indices].reshape(x.shape)
        if train:
            with torch.no_grad():
                onehot = torch.nn.functional.one_hot(indices, m).to(flat.dtype)
                # the global batch's counts and sums: every rank's codebook
                # moves alike, with no buffer broadcast
                counts = collectives.global_sum(onehot.sum(0))
                new_count = self.decay * self.ema_count + (1 - self.decay) * counts
                n = new_count.sum()
                new_count = (new_count + self.epsilon) / (n + m * self.epsilon) * n
                new_weight = (self.decay * self.ema_weight
                              + (1 - self.decay) * collectives.global_sum(onehot.t() @ flat))
                self.ema_count.copy_(new_count)
                self.ema_weight.copy_(new_weight)
                self.embedding.copy_(new_weight / new_count[:, None])
        e_latent = ((x * mask - quant * mask) ** 2).sum() / (collectives.global_sum(mask.sum())
                                                             * d)
        return (x + (quant - x).detach()) * mask, self.commitment_cost * e_latent


class TVEncoder(nn.Module):
    """Time-variable style encoder: conv blocks (LN) → VQ → projection
    branch. reference: DEX-TTS/model/ref_encoder.py:108-140."""

    def __init__(self, c_in=80, c_h=128, c_out=192, c_out_g=192, num_layer=6,
                 n_emb=512, commit_w=0.25):
        super().__init__()
        self.in_conv = BasicConv(c_in, c_h, relu=True, norm="ln")
        self.conv_blocks = nn.ModuleList(
            ResidualConvBlock(c_h, c_h, "ln") for _ in range(num_layer)
        )
        self.out_conv = BasicConv(c_h, c_out, relu=False, norm=None)
        self.vq = VQEmbeddingEMA(n_emb, c_out, commit_w)
        self.proj_0 = Projection(c_out, c_out_g)
        self.proj_1 = BasicConv(c_out_g, c_out_g, relu=True, norm="bn")

    def forward(self, x, mask, train: bool = False):
        """x (B, n_mels, T), mask (B, 1, T) → (pre-VQ (B, c_out, T),
        decoder branch (B, c_out_g, T), VQ commitment loss)."""
        x = self.in_conv(x * mask) * mask
        for blk in self.conv_blocks:
            x = blk(x * mask) * mask
        z = self.out_conv(x * mask) * mask
        q, vq_loss = self.vq(z.transpose(1, 2), mask.transpose(1, 2), train)
        dec = self.proj_0(q.transpose(1, 2).detach(), mask, train)
        return z, self.proj_1(dec * mask, train) * mask, vq_loss


class TIVEncoder(nn.Module):
    """Time-invariant style encoder: conv blocks (BN) with per-block skip
    outputs, instance norm between blocks.
    reference: DEX-TTS/model/ref_encoder.py:83-106."""

    def __init__(self, c_in=80, c_h=128, c_out=64, num_layer=6):
        super().__init__()
        self.in_conv = BasicConv(c_in, c_h, relu=True, norm="bn")
        self.conv_blocks = nn.ModuleList(
            ResidualConvBlock(c_h, c_h, "bn") for _ in range(num_layer)
        )
        self.out_conv = BasicConv(c_h, c_out, relu=True, norm="bn")

    def forward(self, x, mask, train: bool = False):
        """x (B, n_mels, T) → (out (B, c_out, T), skips [(B, c_h, T)])."""
        x = self.in_conv(x * mask, train) * mask
        skips = []
        for blk in self.conv_blocks:
            x = blk(x * mask, train) * mask
            skips.append(x)
            x = instance_norm_1d(x)
        return self.out_conv(x * mask, train) * mask, skips


def stack_skip_stats(skips):
    """Per-block mean/std of the TIV skips over the full padded time axis
    → (B, L, C) each. reference: DEX-TTS/model/diffusion.py:177-188."""
    stats = [instance_norm_stats_1d(s) for s in skips]
    means = torch.cat([m for m, _ in stats], dim=-1).transpose(1, 2)
    stds = torch.cat([s for _, s in stats], dim=-1).transpose(1, 2)
    return means, stds


class SelfAttentionPooling(nn.Module):
    """Softmax pooling over a sequence with a prepended time token.
    reference: DEX-TTS/model/ref_encoder.py:239-253."""

    def __init__(self, dim: int):
        super().__init__()
        self.W = nn.Linear(dim, 1)

    def forward(self, x, time):
        """x (B, L, C), time (B, 1, C) → (B, C)."""
        x = torch.cat([time, x], dim=1)
        attn = self.W(x)[:, :, 0].softmax(dim=-1)[:, :, None]
        return (x * attn).sum(1)


class TIVAdaptor(nn.Module):
    """Adaptive instance norm of the mid feature with SAP-pooled reference
    statistics; statistics in f32, the feature map in its own dtype.
    reference: DEX-TTS/model/ref_encoder.py:255-273."""

    def __init__(self, channels: int):
        super().__init__()
        self.mean_sap = SelfAttentionPooling(channels)
        self.std_sap = SelfAttentionPooling(channels)

    def forward(self, x, ref, time):
        """x (B, C, H, W); ref (means, stds) each (B, L, C); time (B, 1, C)."""
        mean = self.mean_sap(ref[0], time)[:, :, None, None]
        std = self.std_sap(ref[1], time)[:, :, None, None]
        mean2, std2 = instance_norm_stats_2d(x.float())
        scale = (std / std2).to(x.dtype)
        shift = (mean - mean2 * std / std2).to(x.dtype)
        return x * scale + shift


class TVAdaptor(nn.Module):
    """Single-head cross-attention from the mid feature (queries) to the TV
    style sequence + time token, additive residual; runs in x.dtype with
    f32 softmax / instance-norm statistics.
    reference: DEX-TTS/model/ref_encoder.py:142-179."""

    def __init__(self, channels: int):
        super().__init__()
        self.w_q = nn.Linear(channels, channels, bias=False)
        self.w_k = nn.Linear(channels, channels, bias=False)
        self.w_v = nn.Linear(channels, channels, bias=False)
        self.linear = nn.Linear(channels, channels, bias=False)

    def forward(self, x, x_mask, sty, sty_mask, time):
        """x (B, C, H, W); x_mask (B, 1, 1, W); sty (B, Ts, C); sty_mask
        (B, Ts) 0/1; time (B, 1, C)."""
        c = x.shape[1]
        dt = x.dtype
        sty = torch.cat([time, sty], dim=1).to(dt)
        smask = torch.cat([torch.ones_like(sty_mask[:, :1]), sty_mask], dim=1)
        mean2, std2 = instance_norm_stats_2d(x.float())
        xn = x * (1.0 / std2).to(dt) - (mean2 / std2).to(dt)
        q = run_in(self.w_q, xn.permute(0, 2, 3, 1), dt)  # (B, H, W, C)
        k = run_in(self.w_k, sty, dt)
        v = run_in(self.w_v, sty, dt)
        attn = torch.einsum(
            "bhwc,btc->bhwt", (q / torch.tensor(c**0.5, dtype=dt)).float(), k.float()
        )
        attn = attn.masked_fill(smask[:, None, None, :] == 0, -1e4)
        attn = attn.softmax(dim=-1).to(dt)
        out = torch.einsum("bhwt,btc->bhwc", attn.float(), v.float()).to(dt)
        out = run_in(self.linear, out, dt).permute(0, 3, 1, 2)
        return (x + out) * x_mask.to(dt)
