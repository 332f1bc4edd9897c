"""Model facades: GeDEXTTS (general) and DeXTTS (expressive, reference-
speech conditioned): synthesis and the training losses (port of
dex_tts_tpu/models/tts.py).

reference: GeDEX-TTS/model/tts.py:15-122 and DEX-TTS/model/tts.py:14-153.
Module names follow the reference state_dict. The public methods keep the
JAX package's layouts: mu_x (B, Tx, F), logw and x_mask (B, Tx, 1), mels
(B, F, Ty). `compute_loss` runs MAS on the tensors' device (the K4 kernel
on CUDA, `ops/mas.py`) and cuts the training segment there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn as nn

from dex_tts_tpu_torch.models.dit import DiTConfig
from dex_tts_tpu_torch.models.edm import SamplerConfig, ablation_sampler, edm_loss
from dex_tts_tpu_torch.models.layers import dropout_generator
from dex_tts_tpu_torch.models.ref_encoder import (
    LF0Encoder,
    TIVEncoder,
    TVEncoder,
    stack_skip_stats,
)
from dex_tts_tpu_torch.models.text_encoder import TextEncoder
from dex_tts_tpu_torch.models.unet import DiffusionDenoiser
from dex_tts_tpu_torch.ops.mas import MAS_ERRORS, maximum_path
from dex_tts_tpu_torch.ops.masks import duration_loss, generate_path, sequence_mask
from dex_tts_tpu_torch.ops.segment import random_segment
from dex_tts_tpu_torch.parallel import collectives
from dex_tts_tpu_torch.utils import profiling

LOG_2PI = math.log(2 * math.pi)


def _log_prior(y, mu_x, n_feats: int):
    """Frame-token Gaussian log-likelihood grid for MAS. y (B, F, Ty),
    mu_x (B, Tx, F) → (B, Tx, Ty). reference: DEX-TTS/model/tts.py:100-106."""
    y_sq = -0.5 * (y**2).sum(1)[:, None, :]
    y_mu = torch.einsum("bxf,bft->bxt", mu_x, y)
    mu_sq = -0.5 * (mu_x**2).sum(-1)[:, :, None]
    return y_sq + y_mu + mu_sq - 0.5 * LOG_2PI * n_feats


@dataclass(frozen=True)
class TTSConfig:
    """The fields of the JAX package's GeDEXTTS / DeXTTS facades, with the
    same defaults. ``use_style`` selects DeX. ``linattn_impl`` only chose
    a TPU lowering of the U-Net's linear attention: every value maps to
    the one implementation here."""

    n_vocab: int
    n_feats: int = 80
    n_spks: int = 1
    spk_emb_dim: int = 64
    enc_channels: int = 192
    enc_filter_channels: int = 1024
    enc_filter_channels_dp: int = 256
    enc_heads: int = 2
    enc_layers: int = 8
    enc_kernel: int = 3
    enc_dropout: float = 0.1
    use_softmax: bool = True
    use_decay: bool = False
    dec_dim: int = 64
    dec_dim_mults: tuple = (1, 2)
    pe_scale: float = 1000.0
    loss_type: str = "base"
    dit: DiTConfig | None = None
    compute_dtype: str = "float32"
    linattn_impl: str = "fused"
    use_style: bool = False
    tv_c_h: int = 128
    tv_c_out: int = 192
    tv_c_out_g: int = 192
    tv_layers: int = 6
    tv_n_emb: int = 512
    tv_commit_w: float = 0.25
    lf0_c_h: int = 192
    lf0_c_out: int = 192
    lf0_c_out_g: int = 192
    lf0_layers: int = 2
    tiv_c_h: int = 128
    tiv_c_out: int = 64
    tiv_layers: int = 6

    def dit_config(self) -> DiTConfig:
        """The DiT config as the facade completes it (mid width, grid
        height, compute dtype), as GeDEXTTS.setup does in the JAX package."""
        dit = self.dit or DiTConfig()
        n_down = len(self.dec_dim_mults) - 1
        return dataclasses.replace(
            dit,
            in_channels=self.dec_dim * self.dec_dim_mults[-1],
            grid_h=(self.n_feats // (2**n_down)) // dit.stride_size,
            dtype=self.compute_dtype,
        )


class GeDEXTTS(nn.Module):
    """General DEX-TTS: no reference speech; optional speaker embedding."""

    def __init__(self, cfg: TTSConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.n_spks > 1:
            self.spk_emb = nn.Embedding(cfg.n_spks, cfg.spk_emb_dim)
        self.encoder = TextEncoder(
            n_vocab=cfg.n_vocab,
            n_feats=cfg.n_feats,
            n_channels=cfg.enc_channels,
            filter_channels=cfg.enc_filter_channels,
            filter_channels_dp=cfg.enc_filter_channels_dp,
            n_heads=cfg.enc_heads,
            n_layers=cfg.enc_layers,
            kernel_size=cfg.enc_kernel,
            p_dropout=cfg.enc_dropout,
            use_softmax=cfg.use_softmax,
            use_decay=cfg.use_decay,
            use_adaln=cfg.use_style,
            n_spks=cfg.n_spks,
            spk_emb_dim=cfg.spk_emb_dim,
        )
        self.decoder = nn.Module()
        self.decoder.denoise_fn = DiffusionDenoiser(
            dim=cfg.dec_dim,
            dim_mults=cfg.dec_dim_mults,
            n_feats=cfg.n_feats,
            pe_scale=cfg.pe_scale,
            dit_cfg=cfg.dit_config(),
            use_style=cfg.use_style,
            n_spks=cfg.n_spks,
            spk_emb_dim=cfg.spk_emb_dim,
            dtype=cfg.compute_dtype,
        )

    def _spk_vec(self, spk):
        return self.spk_emb(spk) if self.cfg.n_spks > 1 else None

    def _encode(self, x, x_lengths, spk=None, sty=None, train: bool = False):
        mu, logw, x_mask = self.encoder(x, x_lengths, sty=sty, spk=self._spk_vec(spk),
                                        train=train)
        return mu.transpose(1, 2), logw.transpose(1, 2), x_mask.transpose(1, 2)

    def encode(self, x, x_lengths, spk=None):
        """Text → (mu_x (B, Tx, F), logw (B, Tx, 1), x_mask (B, Tx, 1))."""
        return self._encode(x, x_lengths, spk=spk)

    @torch.no_grad()
    def predict_durations(self, x, x_lengths, spk=None, **cond_inputs):
        """Phase-1 duration estimate → (logw (B, Tx, 1), x_mask (B, Tx, 1)).
        Runs the style encoders when present (DEX conditions the text
        encoder on style)."""
        cond = self._cond_from_inputs(**cond_inputs)
        _, logw, x_mask = self._encode(x, x_lengths, spk=spk, sty=cond.get("sty_enc"))
        return logw, x_mask

    def _denoise_kwargs(self, spk=None, **_):
        return {"spk": self._spk_vec(spk)}

    def _cond_from_inputs(self, train: bool = False, **_):
        return {}

    @torch.no_grad()
    def synthesize(self, x, x_lengths, y_max_length: int, sampler: SamplerConfig,
                   temperature: float = 1.0, length_scale: float = 1.0, spk=None,
                   latents_noise=None, generator=None, **cond_inputs):
        """Full text→mel at a fixed frame bucket ``y_max_length``. Returns
        (enc_out (B, F, Ty), dec_out (B, F, Ty), attn (B, Tx, Ty),
        y_lengths (B,) int32); frames past each item's length are zero.
        ``latents_noise`` (B, F, y_max_length) replaces the initial noise
        drawn from ``generator``. reference: GeDEX-TTS/model/tts.py:27-56."""
        with profiling.span("tts.text_to_mel", x.device):
            with profiling.span("text_to_mel.encode", x.device):
                cond = self._cond_from_inputs(**cond_inputs)
                cond.pop("vq_loss", None)
                mu_x, logw, x_mask = self._encode(
                    x, x_lengths, spk=spk, sty=cond.pop("sty_enc", None)
                )
                w = torch.exp(logw[:, :, 0]) * x_mask[:, :, 0]
                w_ceil = torch.ceil(w) * length_scale
                y_lengths = torch.clamp(w_ceil.sum(1), min=1.0)
                y_lengths = torch.clamp(y_lengths, max=float(y_max_length)).to(torch.int32)

                y_mask = sequence_mask(y_lengths, y_max_length).to(mu_x.dtype)
                attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, None, :]
                attn = generate_path(w_ceil, attn_mask)
                mu_y = torch.einsum("bxt,bxf->bft", attn, mu_x)
                mask3 = y_mask[:, None, :]

                denoise_kwargs = self._denoise_kwargs(spk=spk, **cond)
                denoiser = self.decoder.denoise_fn

                def denoise_fn(z, t):
                    return denoiser(z, mask3, mu_y, t, **denoise_kwargs)

                # DiT-cache ("turbo") sampling hooks, used only when
                # sampler.dit_cache_interval > 1 (models/edm._dit_cache_sampler)
                def denoise_fn_mid(z, t):
                    return denoiser(z, mask3, mu_y, t, return_mid=True, **denoise_kwargs)

                def denoise_fn_cached(z, t, mid=None):
                    return denoiser(z, mask3, mu_y, t, mid_override=mid, **denoise_kwargs)

                if latents_noise is None:
                    latents_noise = collectives.randn(
                        mu_y.shape, generator=generator, dtype=mu_y.dtype, device=mu_y.device
                    )
                latents = latents_noise.to(mu_y.dtype) / temperature + mu_y
            dec_out = ablation_sampler(denoise_fn, latents, sampler, generator=generator,
                                       denoise_fn_mid=denoise_fn_mid,
                                       denoise_fn_cached=denoise_fn_cached)
            return mu_y * mask3, dec_out * mask3, attn, y_lengths

    def compute_loss(self, x, x_lengths, y, y_lengths, out_size: int | None = None,
                     spk=None, mask_ratio: float = 0.0, train: bool = True,
                     generator=None, draws=None, **cond_inputs):
        """Training losses {vq_loss (DeX), dur_loss, diff_loss, prior_loss},
        and under ``MAS_ERRORS`` the MAS guard's count of broken paths: a
        device scalar, not a loss, that `train.trainer` leaves out of the
        sum and `metrics_to_host` raises on. y (B, F, Ty) padded mel.
        Dropout, the segment offsets, σ and the noise draw from
        ``generator`` (on the tensors' device) unless
        ``draws`` = {"u": (B,), "sigma": (B, 1, 1), "noise": (B, F, W)}
        hands them over (the dropout still draws from ``generator`` in
        train mode). MAS sees the log-prior detached and its path is
        constant, as in the JAX package. reference: GeDEX-TTS/model/tts.py:58-122."""
        draws = draws or {}
        with dropout_generator(generator) if train else contextlib.nullcontext():
            cond = self._cond_from_inputs(train=train, **cond_inputs)
            losses = {}
            if "vq_loss" in cond:
                losses["vq_loss"] = cond.pop("vq_loss")
            mu_x, logw, x_mask = self._encode(
                x, x_lengths, spk=spk, sty=cond.pop("sty_enc", None), train=train
            )
            y_max_length = y.shape[-1]
            y_mask = sequence_mask(y_lengths, y_max_length).to(mu_x.dtype)
            attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, None, :]
            with torch.no_grad():
                attn, mas_errors = maximum_path(_log_prior(y, mu_x, self.cfg.n_feats), attn_mask,
                                                return_errors=True)

            logw_ = torch.log(1e-8 + attn.sum(-1))[:, :, None] * x_mask
            losses["dur_loss"] = duration_loss(logw, logw_, x_lengths)

            mask3 = y_mask[:, None, :]
            if out_size is not None and out_size < y_max_length:
                y, attn, _, mask3 = random_segment(y, attn, y_lengths, out_size,
                                                   generator=generator, u=draws.get("u"))
            mu_y = torch.einsum("bxt,bxf->bft", attn, mu_x)

            denoise_kwargs = self._denoise_kwargs(spk=spk, **cond)
            denoiser = self.decoder.denoise_fn

            def denoise_fn(z, t):
                return denoiser(z, mask3, mu_y, t, train=train, mask_ratio=mask_ratio,
                                **denoise_kwargs)

            edm_draws = (draws["sigma"], draws["noise"]) if "sigma" in draws else None
            losses["diff_loss"] = edm_loss(
                denoise_fn, y, mask3, mu_y, n_feats=self.cfg.n_feats,
                loss_type=self.cfg.loss_type, generator=generator, draws=edm_draws,
            )
            prior = (0.5 * ((y - mu_y) ** 2 + LOG_2PI) * mask3).sum()
            losses["prior_loss"] = prior / (collectives.global_sum(mask3.sum()) * self.cfg.n_feats)
        losses[MAS_ERRORS] = mas_errors
        return losses


class DeXTTS(GeDEXTTS):
    """Expressive DEX-TTS: style from a reference utterance through the
    time-variable (VQ + cross-attention), time-invariant (adaptive
    instance norm) and lf0 paths. Inputs beyond GeDEXTTS: ref (B, F, Tr) +
    ref_lengths, sty (B, F, Ts) + sty_lengths, lf0 (B, Tl) + lf0_lengths.
    reference: DEX-TTS/model/tts.py:14-153."""

    def __init__(self, cfg: TTSConfig):
        super().__init__(cfg)
        self.tv_encoder = TVEncoder(
            c_in=cfg.n_feats, c_h=cfg.tv_c_h, c_out=cfg.tv_c_out,
            c_out_g=cfg.tv_c_out_g, num_layer=cfg.tv_layers, n_emb=cfg.tv_n_emb,
            commit_w=cfg.tv_commit_w,
        )
        self.lf0_encoder = LF0Encoder(
            c_h=cfg.lf0_c_h, c_out=cfg.lf0_c_out, c_out_g=cfg.lf0_c_out_g,
            num_layer=cfg.lf0_layers,
        )
        self.tiv_encoder = TIVEncoder(
            c_in=cfg.n_feats, c_h=cfg.tiv_c_h, c_out=cfg.tiv_c_out,
            num_layer=cfg.tiv_layers,
        )
        self.conv_sty = nn.Conv1d(cfg.tv_c_out_g, cfg.dec_dim * cfg.dec_dim_mults[-1], 1)

    def _cond_from_inputs(self, ref, ref_lengths, sty, sty_lengths, lf0, lf0_lengths,
                          train: bool = False):
        """Run the three style encoders (train mode: dropout, batch
        statistics, the codebook's EMA update). reference: DEX-TTS/model/tts.py:38-51."""
        ref_mask = sequence_mask(ref_lengths, ref.shape[2])[:, None, :].to(ref.dtype)
        sty_mask = sequence_mask(sty_lengths, sty.shape[2])[:, None, :].to(sty.dtype)
        lf0_mask = sequence_mask(lf0_lengths, lf0.shape[1])[:, None, :].to(lf0.dtype)

        lf0_enc, lf0_dec = self.lf0_encoder(lf0, lf0_mask, train)
        sty_enc_seq, sty_dec, vq_loss = self.tv_encoder(sty, sty_mask, train)
        # global style vector: masked time-means of TV pre-VQ + lf0 features
        sty_enc = sty_enc_seq.sum(-1) / sty_mask.sum(-1)
        sty_enc = sty_enc + lf0_enc.sum(-1) / lf0_mask.sum(-1)
        # decoder style sequence: projected quantized TV + global lf0
        lf0_global = lf0_dec.sum(-1) / lf0_mask.sum(-1)
        sty_dec = self.conv_sty(sty_dec + lf0_global[:, :, None])

        _, ref_skips = self.tiv_encoder(ref, ref_mask, train)
        return {
            "sty_enc": sty_enc,
            "sty_dec": sty_dec.transpose(1, 2),  # (B, Ts, C_mid)
            "sty_lengths": sty_lengths,
            "ref_stats": stack_skip_stats(ref_skips),
            "vq_loss": vq_loss,
        }

    def _denoise_kwargs(self, spk=None, **cond):
        return {
            "ref": cond["ref_stats"],
            "sty": cond["sty_dec"],
            "sty_lengths": cond["sty_lengths"],
        }


def build_tts(cfg: TTSConfig) -> GeDEXTTS:
    """TTSConfig → DeXTTS (use_style) or GeDEXTTS, in eval mode."""
    return (DeXTTS if cfg.use_style else GeDEXTTS)(cfg).eval()
