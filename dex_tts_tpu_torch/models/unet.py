"""Grad-TTS-style 2-D U-Net denoiser with a DiT middle block (port of
dex_tts_tpu/models/unet.py).

reference: DEX-TTS/model/diffusion.py:11-236 (style-adapted) and
GeDEX-TTS/model/diffusion.py:16-207. Layout (B, C, H=mel bins, W=frames);
masks (B, 1, 1, W). Parameter names match the reference state_dict. With a
bfloat16 compute dtype the whole U-Net runs in bf16 with f32 statistics,
as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from dex_tts_tpu_torch.models.dit import DTYPES, DiT, DiTConfig
from dex_tts_tpu_torch.models.layers import Mish, mish, run_in, sinusoidal_pos_emb
from dex_tts_tpu_torch.models.ref_encoder import TIVAdaptor, TVAdaptor
from dex_tts_tpu_torch.ops.masks import sequence_mask


class GroupNorm(nn.GroupNorm):
    """GroupNorm with f32 per-group statistics, applied in the input dtype
    (torch semantics: eps inside rsqrt, per-channel affine)."""

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.num_groups
        xg = x.reshape(b, g, c // g, h * w)
        xf = xg.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf**2).mean(dim=(2, 3), keepdim=True) - mean**2
        inv = torch.rsqrt(var + self.eps)
        out = (xg * inv.to(x.dtype) - (mean * inv).to(x.dtype)).reshape(b, c, h, w)
        return out * self.weight.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]


class Block(nn.Module):
    """conv3x3 → GroupNorm(8) → Mish, masked in/out.
    reference: DEX-TTS/model/diffusion.py:44-53."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim_out, 3, padding=1), GroupNorm(groups, dim_out, eps=1e-5), Mish()
        )

    def forward(self, x, mask, dtype):
        h = run_in(self.block[0], x.to(dtype) * mask.to(dtype), dtype)
        return mish(self.block[1](h)) * mask.to(h.dtype)


class ResnetBlock(nn.Module):
    """Two Blocks with a time-embedding shift between them + 1x1 residual.
    reference: DEX-TTS/model/diffusion.py:56-74."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, mask, time_emb, dtype):
        x = x.to(dtype)
        mask = mask.to(dtype)
        h = self.block1(x, mask, dtype)
        h = h + self.mlp(time_emb)[:, :, None, None].to(dtype)
        h = self.block2(h, mask, dtype)
        if isinstance(self.res_conv, nn.Conv2d):
            return h + run_in(self.res_conv, x * mask, dtype)
        return h + x * mask


class LinearAttention(nn.Module):
    """k softmaxed over space (in f32), context = k·vᵀ per head, out =
    q·context. The JAX package's ``linattn_impl`` lowerings all compute
    this one function. reference: DEX-TTS/model/diffusion.py:77-95."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x, dtype):
        b, _, h, w = x.shape
        qkv = run_in(self.to_qkv, x, dtype).reshape(b, 3, self.heads, self.dim_head, h * w)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        k = k.float().softmax(dim=-1).to(dtype)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return run_in(self.to_out, out.reshape(b, -1, h, w), dtype)


class Rezero(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))


class Residual(nn.Module):
    """x + g·LinearAttention(x), g zero at init (reference's
    Residual(Rezero(LinearAttention)) naming).
    reference: DEX-TTS/model/diffusion.py:34-41,98-105."""

    def __init__(self, dim: int):
        super().__init__()
        self.fn = Rezero(LinearAttention(dim))

    def forward(self, x, dtype):
        return x + self.fn.fn(x, dtype) * self.fn.g.to(x.dtype)


class Downsample(nn.Module):
    """conv3x3 stride 2. reference: DEX-TTS/model/diffusion.py:25-31."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x, dtype):
        return run_in(self.conv, x, dtype)


class Upsample(nn.Module):
    """ConvTranspose k=4 s=2 p=1 (exact 2x). reference: diffusion.py:16-22."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(dim, dim, 4, 2, 1)

    def forward(self, x, dtype):
        return run_in(self.conv, x, dtype)


class DiffusionDenoiser(nn.Module):
    """U-Net: per resolution [2×ResnetBlock + linear attention + down/up]
    with a (style-adapted) DiT bottleneck. use_style adds the TV → TIV
    adaptors (DEX); otherwise n_spks > 1 stacks a speaker channel (GeDEX)."""

    def __init__(
        self,
        dim: int = 64,
        dim_mults: Sequence[int] = (1, 2),
        groups: int = 8,
        n_feats: int = 80,
        pe_scale: float = 1000.0,
        dit_cfg: DiTConfig | None = None,
        use_style: bool = False,
        n_spks: int = 1,
        spk_emb_dim: int = 64,
        dtype: str = "float32",
    ):
        super().__init__()
        self.dim = dim
        self.pe_scale = pe_scale
        self.use_style = use_style
        self.n_spks = n_spks
        self.compute_dtype = DTYPES[dtype]
        dims = [d * dim for d in dim_mults]
        mid = dims[-1]
        self.mlp = nn.Sequential(nn.Linear(dim, dim * 4), Mish(), nn.Linear(dim * 4, dim))
        in_ch = 2
        if use_style:
            self.mlp_adap = nn.Sequential(nn.Linear(dim, dim), Mish(), nn.Linear(dim, mid))
            self.mlp_adap_sty = nn.Sequential(nn.Linear(dim, dim), Mish(), nn.Linear(dim, mid))
            self.tv_adaptor = TVAdaptor(mid)
            self.tiv_adaptor = TIVAdaptor(mid)
        elif n_spks > 1:
            self.spk_mlp = nn.Sequential(
                nn.Linear(spk_emb_dim, spk_emb_dim * 4), Mish(),
                nn.Linear(spk_emb_dim * 4, n_feats),
            )
            in_ch = 3
        self.downs = nn.ModuleList()
        dim_in = in_ch
        for i, dim_out in enumerate(dims):
            last = i == len(dims) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(dim_in, dim_out, dim, groups),
                ResnetBlock(dim_out, dim_out, dim, groups),
                Residual(dim_out),
                nn.Identity() if last else Downsample(dim_out),
            ]))
            dim_in = dim_out
        self.vit = DiT(dit_cfg)
        self.ups = nn.ModuleList()
        for dim_in_, dim_out in zip(reversed(dims[:-1]), reversed(dims[1:])):
            self.ups.append(nn.ModuleList([
                ResnetBlock(dim_out * 2, dim_in_, dim, groups),
                ResnetBlock(dim_in_, dim_in_, dim, groups),
                Residual(dim_in_),
                Upsample(dim_in_),
            ]))
        self.final_block = Block(dim, dim, groups)
        self.final_conv = nn.Conv2d(dim, 1, 1)

    def forward(self, x, mask, mu, t, ref=None, sty=None, sty_lengths=None, spk=None,
                train: bool = False, mask_ratio: float = 0.0):
        """x, mu: (B, n_feats, W); mask: (B, 1, W); t: (B,) noise labels;
        ref (DEX): (means, stds) each (B, L, C_mid); sty (DEX): (B, Ts,
        C_mid); spk (GeDEX): (B, spk_emb_dim). ``train`` and ``mask_ratio``
        reach the DiT (attention-mode threshold, token masking). Returns
        (B, n_feats, W) f32."""
        dt = self.compute_dtype
        channels = [mu, x]
        if not self.use_style and self.n_spks > 1:
            s = self.spk_mlp(spk)
            channels.append(s[:, :, None].expand(-1, -1, x.shape[-1]))
        h = torch.stack(channels, dim=1).to(dt)
        mask4 = mask[:, None].to(dt)  # (B, 1, 1, W)

        t_init = sinusoidal_pos_emb(t, self.dim, self.pe_scale)
        t_unet = self.mlp(t_init)

        hiddens = []
        masks = [mask4]
        for res1, res2, attn, down in self.downs:
            m = masks[-1]
            h = res1(h, m, t_unet, dt)
            h = res2(h, m, t_unet, dt)
            h = attn(h, dt)
            hiddens.append(h)
            h = h * m if isinstance(down, nn.Identity) else down(h * m, dt)
            masks.append(m[:, :, :, ::2])
        masks = masks[:-1]
        mask_mid = masks[-1]

        if self.use_style:
            t_adap = self.mlp_adap(t_init)
            t_sty = self.mlp_adap_sty(t_init)
            sty_mask = sequence_mask(sty_lengths, sty.shape[1]).float()
            h = self.tv_adaptor(h, mask_mid, sty, sty_mask, t_sty[:, None, :])
            h = self.tiv_adaptor(h, ref, t_adap[:, None, :])
        h = self.vit(h, mask_mid, t, train=train, mask_ratio=mask_ratio).to(dt)

        for (res1, res2, attn, up), m in zip(self.ups, reversed(masks[1:])):
            h = torch.cat([h, hiddens.pop()], dim=1)
            h = res1(h, m, t_unet, dt)
            h = res2(h, m, t_unet, dt)
            h = attn(h, dt)
            h = up(h * m, dt)

        h = self.final_block(h, mask4, dt)
        out = run_in(self.final_conv, h * mask4, dt)
        return (out * mask4).float()[:, 0]
