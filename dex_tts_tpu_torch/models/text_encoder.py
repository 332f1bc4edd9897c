"""Text encoder: symbol embedding → conv prenet → retention encoder →
mel-prior projection + duration predictor (port of
dex_tts_tpu/models/text_encoder.py).

reference: DEX-TTS/model/text_encoder.py:94-143 (style-conditioned) and
GeDEX-TTS/model/text_encoder.py:131-146 (speaker-embedding concat).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from dex_tts_tpu_torch.models.layers import ConvReluNorm, DurationPredictor
from dex_tts_tpu_torch.models.retention import RetNetEncoder, RetNetEncoderConfig
from dex_tts_tpu_torch.ops.masks import sequence_mask


class TextEncoder(nn.Module):
    def __init__(
        self,
        n_vocab: int,
        n_feats: int = 80,
        n_channels: int = 192,
        filter_channels: int = 1024,
        filter_channels_dp: int = 256,
        n_heads: int = 2,
        n_layers: int = 8,
        kernel_size: int = 3,
        p_dropout: float = 0.1,
        use_softmax: bool = True,
        use_decay: bool = False,
        use_adaln: bool = False,
        n_spks: int = 1,
        spk_emb_dim: int = 64,
    ):
        super().__init__()
        self.n_channels = n_channels
        self.n_spks = n_spks
        width = n_channels + (spk_emb_dim if n_spks > 1 else 0)
        self.emb = nn.Embedding(n_vocab, n_channels)
        nn.init.normal_(self.emb.weight, 0.0, n_channels**-0.5)
        self.prenet = ConvReluNorm(n_channels, kernel_size=5, n_layers=3, p_dropout=0.5)
        self.encoder = RetNetEncoder(
            RetNetEncoderConfig(
                embed_dim=width,
                ffn_dim=filter_channels,
                num_layers=n_layers,
                num_heads=n_heads,
                dropout=p_dropout,
                use_softmax=use_softmax,
                use_decay=use_decay,
                use_adaln=use_adaln,
            )
        )
        self.proj_m = nn.Conv1d(width, n_feats, 1)
        self.proj_w = DurationPredictor(width, filter_channels_dp, 1, kernel_size, p_dropout)

    def forward(self, x, x_lengths, sty=None, spk=None, train: bool = False):
        """x: (B, Tx) token ids; sty: (B, C) style vector (DEX); spk:
        (B, spk_emb_dim) speaker vector (GeDEX). Returns (mu_x (B, F, Tx),
        logw (B, 1, Tx), x_mask (B, 1, Tx)). The duration predictor sees
        the encoder output detached, as in the JAX package."""
        h = self.emb(x) * math.sqrt(float(self.n_channels))
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, None, :].to(h.dtype)
        h = self.prenet(h.transpose(1, 2), x_mask, train)
        if self.n_spks > 1:
            h = torch.cat([h, spk[:, :, None].expand(-1, -1, h.shape[-1])], dim=1)
        h = self.encoder(h.transpose(1, 2), x_mask[:, 0, :], sty=sty, train=train)
        h = h.transpose(1, 2) * x_mask
        mu = self.proj_m(h) * x_mask
        logw = self.proj_w(h.detach(), x_mask, train)
        return mu, logw, x_mask
