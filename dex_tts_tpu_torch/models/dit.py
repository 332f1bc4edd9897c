"""DiT middle block of the U-Net denoiser (port of dex_tts_tpu/models/dit.py).

MaskDiT-derived transformer on overlapped 2-D patches of the U-Net mid
feature map (reference: DEX-TTS/model/dit.py:31-519). Layout is the
reference's (B, C, H=freq, W=time); tokens are freq-major, time-minor, as
in the JAX package. Parameter names match the reference state_dict.

Attention routes as the JAX package routes it (`resolve_attention_mode`):
"einsum" is MHSA's own plain einsum; "flash", "flash_bf16", "splash" and
"splash_bf16" all launch the hand-written Hopper kernel on CUDA
(`ops/attention.py`), in f32 for "flash" and "splash" and in bf16 for the
*_bf16 modes (`attention_kernel_dtype`), whose plain version serves CPU
tensors in the compute dtype; with grad
enabled the kernel runs under its autograd Function, whose backward is
the kernel's backward. In train mode with ``mask_ratio`` > 0 the DiT
keeps a random subset of tokens (MAE-style, reference: dit.py:139-212).

Two variants, off in every preset, as in the JAX package: the time
position embedding ``pos_embed_time="conv1d"`` (the mean over frequency
first, then a grouped 1-D conv over time: different math from the
reference's conv2d, so a conv2d state dict does not load into it), and
``use_decoder``, a token position conv and ``depth`` more blocks over the
whole token sequence after the masked tokens are put back.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from dex_tts_tpu_torch.models.layers import TimestepEmbedder, run_in, train_uniform
from dex_tts_tpu_torch.ops.attention import flash_attention_qkv
from dex_tts_tpu_torch.utils import profiling

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
POS_EMBED_TIME = ("conv2d", "conv1d")


@dataclass(frozen=True)
class DiTConfig:
    """Same fields and defaults as the JAX package's DiTConfig.

    dtype is the compute dtype of the DiT (parameters stay float32;
    LayerNorm and softmax statistics stay float32). ``pos_conv_impl``,
    ``flash_block_q`` and ``flash_block_k`` only choose a TPU lowering of
    the same math: they are accepted and ignored here, every value maps to
    one implementation. ``auto_flash_min_tokens`` keeps the JAX default so
    that mode selection matches; it has not been re-measured on the H100.
    """

    in_channels: int = 128
    patch_size: int = 3
    stride_size: int = 2
    overlap: bool = True
    hidden_size: int = 256
    depth: int = 4
    num_heads: int = 2
    mlp_ratio: float = 2.0
    conv_pos: int = 16
    conv_pos_groups: int = 8
    pos_conv_impl: str = "grouped"
    pos_embed_time: str = "conv2d"
    mask_type: str = "random"
    grid_h: int = 20
    use_decoder: bool = False
    dtype: str = "float32"
    attention: str = "einsum"
    auto_flash_min_tokens: int = 768
    auto_flash_min_tokens_train: int = 2048
    flash_block_q: int | None = None
    flash_block_k: int | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def resolve_attention_mode(cfg: DiTConfig, n_tokens: int, train: bool = False) -> str:
    """The attention choice for ``attention="auto"``, unchanged from the
    JAX package (dit.py:308-327)."""
    if cfg.attention != "auto":
        return cfg.attention
    threshold = (
        cfg.auto_flash_min_tokens_train if train else cfg.auto_flash_min_tokens
    )
    return "flash_bf16" if n_tokens >= threshold else "einsum"


def attention_kernel_dtype(mode: str, compute_dtype: torch.dtype, on_cuda: bool) -> torch.dtype:
    """The dtype a "flash*"/"splash*" mode runs its attention in, as the JAX
    package chooses it (dit.py:375,421): on the accelerator bf16 for the
    *_bf16 modes and f32 for "flash" and "splash", whatever the compute
    dtype (the result is cast back to it); elsewhere its einsum fallback in
    the compute dtype (dit.py:350-362)."""
    if not on_cuda:
        return compute_dtype
    return torch.bfloat16 if mode.endswith("_bf16") else torch.float32


def token_count(cfg: DiTConfig, width: int) -> int:
    """DiT tokens for a mid feature map ``width`` frames wide: the time
    axis padded to a multiple of the patch, then the patch conv's output
    grid, grid_h rows of it."""
    p = cfg.patch_size
    w = -(-width // p) * p
    stride, pad = (cfg.stride_size, p // 2) if cfg.overlap else (p, 0)
    return cfg.grid_h * ((w + 2 * pad - p) // stride + 1)


def modulate(x, shift, scale):
    """reference: DEX-TTS/model/dit.py:72-73."""
    return x * (1 + scale[:, None, :].to(x.dtype)) + shift[:, None, :].to(x.dtype)


def layer_norm_f32_stats(x, eps: float = 1e-6):
    """Affine-free LayerNorm: statistics in f32, application in x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf**2).mean(-1, keepdim=True) - mean**2
    inv = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * inv.to(x.dtype)


class MHSA(nn.Module):
    """timm-style multi-head self-attention (qkv bias, output projection).
    reference: timm Attention used at DEX-TTS/model/dit.py:270."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x, train: bool = False):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_heads
        hd = d // h
        dt = cfg.compute_dtype
        qkv = run_in(self.qkv, x, dt).reshape(b, t, 3, h, hd)
        mode = resolve_attention_mode(cfg, t, train)
        if mode.startswith(("flash", "splash")):
            kdt = attention_kernel_dtype(mode, dt, x.is_cuda)
            out = flash_attention_qkv(qkv.to(kdt), hd**-0.5).to(dt)
        elif mode == "einsum":
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * hd**-0.5
            weights = scores.softmax(dim=-1).to(dt)
            out = torch.einsum("bhts,bshd->bthd", weights.float(), v.float()).to(dt)
        else:
            raise ValueError(f"unknown attention mode {mode!r}")
        return run_in(self.proj, out.reshape(b, t, d), dt)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block. reference: DEX-TTS/model/dit.py:262-284."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        hidden = int(d * cfg.mlp_ratio)
        self.attn = MHSA(cfg)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, hidden), "fc2": nn.Linear(hidden, d)})
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 6 * d))
        nn.init.zeros_(self.adaLN_modulation[1].weight)
        nn.init.zeros_(self.adaLN_modulation[1].bias)

    def forward(self, x, c, train: bool = False):
        dt = self.cfg.compute_dtype
        sm, cm, gm, sp, cp, gp = self.adaLN_modulation(c).chunk(6, dim=-1)
        h = modulate(layer_norm_f32_stats(x), sm, cm)
        x = x + gm[:, None, :].to(x.dtype) * self.attn(h, train).to(x.dtype)
        h = modulate(layer_norm_f32_stats(x), sp, cp)
        h = F.gelu(run_in(self.mlp["fc1"], h, dt))
        h = run_in(self.mlp["fc2"], h, dt)
        return x + gp[:, None, :].to(x.dtype) * h.to(x.dtype)


class FinalLayer(nn.Module):
    """adaLN + zero-init linear to stride²·C patches.
    reference: DEX-TTS/model/dit.py:308-326."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.linear = nn.Linear(d, cfg.stride_size**2 * cfg.in_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 2 * d))
        for lin in (self.linear, self.adaLN_modulation[1]):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        x = modulate(layer_norm_f32_stats(x), shift, scale)
        return run_in(self.linear, x, self.cfg.compute_dtype)


def token_mask(batch: int, length: int, mask_ratio: float, like: torch.Tensor):
    """MAE-style random keep/restore index sets (keep count
    int(length·(1 − mask_ratio))), from the train-mode generator.
    reference: DEX-TTS/model/dit.py:139-157."""
    len_keep = int(length * (1 - mask_ratio))
    ids_shuffle = torch.argsort(train_uniform((batch, length), like), dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    return ids_shuffle[:, :len_keep], ids_restore


class DiT(nn.Module):
    """patchify → pos embeds → blocks → final → unpatchify → crop/mask.
    reference: DEX-TTS/model/dit.py:328-519."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        if cfg.pos_embed_time not in POS_EMBED_TIME:
            raise ValueError(f"pos_embed_time={cfg.pos_embed_time!r} not in {POS_EMBED_TIME}")
        self.cfg = cfg
        c, d, p, k = cfg.in_channels, cfg.hidden_size, cfg.patch_size, cfg.conv_pos
        stride = cfg.stride_size if cfg.overlap else p
        pad = p // 2 if cfg.overlap else 0
        self.x_embedder = nn.ModuleDict({
            "proj": nn.Sequential(
                nn.Conv2d(c, c, p, stride, padding=pad, groups=c),
                nn.SiLU(),
                nn.Conv2d(c, d, 1),
            )
        })
        self.t_embedder = TimestepEmbedder(d)
        self.freq_new_pos_embed = nn.Parameter(torch.zeros(1, d, cfg.grid_h, 1))
        # k//2 padding both sides, then SamePad trims one trailing element
        # per dim for even k (the JAX package's (k//2, k//2 - 1) padding)
        if cfg.pos_embed_time == "conv1d":
            self.pos_conv1d = nn.Sequential(
                nn.Conv1d(d, d, k, padding=k // 2, groups=cfg.conv_pos_groups)
            )
        else:
            self.pos_conv = nn.Sequential(
                nn.Conv2d(d, d, k, padding=k // 2, groups=cfg.conv_pos_groups)
            )
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        if cfg.use_decoder:
            self.decoder_pos_conv = nn.Sequential(
                nn.Conv1d(d, d, k, padding=k // 2, groups=cfg.conv_pos_groups)
            )
            self.decoder_blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(cfg)

    def _same_pad_conv(self, conv, x):
        """``conv`` in the compute dtype, its trailing output trimmed in every
        spatial dim for an even kernel (SamePad), then the exact gelu."""
        y = run_in(conv, x, self.cfg.compute_dtype)
        if self.cfg.conv_pos % 2 == 0:
            y = y[(...,) + (slice(None, -1),) * (y.dim() - 2)]
        return F.gelu(y)

    def time_pos(self, x):
        """(B, D, H', W') patches → the time position embedding (B, D, 1,
        W'), broadcast over frequency. reference: dit.py:75-90,444-447;
        JAX dit.py:234-281."""
        if self.cfg.pos_embed_time == "conv1d":
            return self._same_pad_conv(self.pos_conv1d[0], x.mean(dim=2))[:, :, None, :]
        return self._same_pad_conv(self.pos_conv[0], x).mean(dim=2, keepdim=True)

    def forward(self, x, mask, t, train: bool = False, mask_ratio: float = 0.0):
        """x: (B, C, H, W) mid feature; mask: (B, 1, 1, W) binary; t: (B,)
        noise-level embedding input (c_noise)."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, c_in, h_in, w_in = x.shape
        x = F.pad(x, (0, (-w_in) % cfg.patch_size))
        proj = self.x_embedder["proj"]
        x = F.silu(run_in(proj[0], x, dt))
        x = run_in(proj[2], x, dt)  # (B, D, H', W')
        hp, wp = x.shape[2], x.shape[3]
        t_emb = self.t_embedder(t)

        x = x + self.time_pos(x)[:, :, :, :wp].to(x.dtype)
        if profiling.TRACING:
            profiling.count_casts(x.dtype, self.freq_new_pos_embed)
        x = x + self.freq_new_pos_embed.to(x.dtype)
        tokens = x.flatten(2).transpose(1, 2)  # (B, H'·W', D), freq-major
        n_tokens = tokens.shape[1]
        use_mask = train and mask_ratio > 0
        if use_mask:
            ids_keep, ids_restore = token_mask(b, n_tokens, mask_ratio, tokens)
            tokens = torch.gather(tokens, 1, ids_keep[:, :, None].expand(-1, -1, tokens.shape[2]))

        for blk in self.blocks:
            tokens = blk(tokens, t_emb, train)
        if use_mask:
            # zero tokens re-inserted at the masked positions (reference: dit.py:200-206)
            filler = tokens.new_zeros((b, n_tokens - tokens.shape[1], tokens.shape[2]))
            tokens = torch.cat([tokens, filler], dim=1)
            tokens = torch.gather(tokens, 1, ids_restore[:, :, None].expand(-1, -1, tokens.shape[2]))
        if cfg.use_decoder:
            # the decoder over the whole token sequence: a grouped conv over
            # the tokens, gelu, the mean over channels (B, N, 1) added to
            # every channel (reference: dit.py:466-477,505-506)
            pos = self._same_pad_conv(self.decoder_pos_conv[0], tokens.transpose(1, 2))
            tokens = tokens + pos.mean(dim=1)[:, :, None].to(tokens.dtype)
            for blk in self.decoder_blocks:
                tokens = blk(tokens, t_emb, train)
        out = self.final_layer(tokens, t_emb)  # (B, N, s²·C)

        s = cfg.stride_size
        out = out.reshape(b, cfg.grid_h, wp, s, s, c_in)
        out = out.permute(0, 5, 1, 3, 2, 4).reshape(b, c_in, cfg.grid_h * s, wp * s)
        return out[:, :, :h_in, :w_in] * mask.to(out.dtype)
