"""Plain DeX-TTS / GeDEX-TTS inference in float32: text and style
encoders, the duration pre-pass, the U-Net denoiser with its DiT middle
block, and text→mel through the EDM samplers (`sampler.py`).

Written from the reference's equations (DEX-TTS/model/{tts,text_encoder,
retention,ref_encoder,diffusion,dit,edm}.py, GeDEX-TTS/model/*) in plain
torch operations: no kernel, no cache, no reduced precision, no batching
trick. Module and parameter names are the reference's state-dict names,
so one state dict loads strictly here and into the program under test.
Only inference (eval mode) is written: BatchNorm uses its running
statistics, the VQ codebook is read, never updated.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.sampler import sample


def sequence_mask(lengths, n: int):
    return torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]


def mish(x):
    return x * torch.tanh(F.softplus(x))


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels of (B, C, T), eps 1e-4 inside the root."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = ((x - mean) ** 2).mean(1, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-4) * self.gamma[:, None] + self.beta[:, None]


class RMSNorm(nn.Module):
    def __init__(self, dim: int, affine: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim)) if affine else None

    def forward(self, x):
        y = x / torch.sqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
        return y if self.weight is None else y * self.weight


class AdaptiveLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.W_scale = nn.Linear(dim, dim)
        self.W_bias = nn.Linear(dim, dim)

    def forward(self, x, sty):
        y = F.layer_norm(x, x.shape[-1:], eps=1e-5)
        return y * self.W_scale(sty)[:, None, :] + self.W_bias(sty)[:, None, :]


class ConvReluNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv_layers = nn.ModuleList(nn.Conv1d(c, c, 5, padding=2) for _ in range(3))
        self.norm_layers = nn.ModuleList(ChannelLayerNorm(c) for _ in range(3))
        self.proj = nn.Conv1d(c, c, 1)

    def forward(self, x, mask):
        h = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            h = torch.relu(norm(conv(h * mask)))
        return (x + self.proj(h)) * mask


class DurationPredictor(nn.Module):
    """[conv → relu → LN] × 2 → 1×1 projection, masked (also the
    style encoders' Projection)."""

    def __init__(self, c_in: int, c_h: int, out: int):
        super().__init__()
        self.conv_1 = nn.Conv1d(c_in, c_h, 3, padding=1)
        self.norm_1 = ChannelLayerNorm(c_h)
        self.conv_2 = nn.Conv1d(c_h, c_h, 3, padding=1)
        self.norm_2 = ChannelLayerNorm(c_h)
        self.proj = nn.Conv1d(c_h, out, 1)

    def forward(self, x, mask):
        x = self.norm_1(torch.relu(self.conv_1(x * mask)))
        x = self.norm_2(torch.relu(self.conv_2(x * mask)))
        return self.proj(x * mask) * mask


class BasicConv(nn.Module):
    """conv k3 without bias, then BatchNorm → relu, or relu → LayerNorm."""

    def __init__(self, c_in: int, c_out: int, relu: bool, norm=None):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, 3, padding=1, bias=False)
        self.relu = relu
        self.bn = nn.BatchNorm1d(c_out) if norm == "bn" else None
        self.ln = nn.LayerNorm(c_out) if norm == "ln" else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.relu:
            x = torch.relu(x)
        if self.ln is not None:
            x = self.ln(x.transpose(1, 2)).transpose(1, 2)
        return x


# ---- text encoder: conv prenet + retention (softmax, no decay) ----------

def rotary(t: int, key_dim: int, device):
    angle = 1.0 / (10000 ** np.linspace(0, 1, key_dim // 2))
    angle = torch.tensor(np.repeat(angle, 2), dtype=torch.float32, device=device)
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None] * angle[None, :]
    return torch.sin(pos), torch.cos(pos)


def theta_shift(x, sin, cos):
    rotated = torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).reshape(x.shape)
    return x * cos + rotated * sin


class MultiScaleRetention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.g_proj = nn.Linear(d, d, bias=False)
        self.out_proj = nn.Linear(d, d, bias=False)
        self.norm = RMSNorm(d // heads, affine=False)

    def forward(self, x, sin, cos, pair_mask):
        b, t, d = x.shape
        h = self.heads
        split = lambda a: a.reshape(b, t, h, d // h).transpose(1, 2)
        q = theta_shift(split(self.q_proj(x)), sin, cos)
        k = theta_shift(split(self.k_proj(x) * (d // h) ** -0.5), sin, cos)
        scores = (q @ k.transpose(-1, -2)) * pair_mask
        weights = scores.masked_fill(pair_mask == 0, -1e4).softmax(-1)
        out = self.norm(weights @ split(self.v_proj(x)))
        out = out.transpose(1, 2).reshape(b, t, d)
        return self.out_proj(F.silu(self.g_proj(x)) * out)


class GLU(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.fc1 = nn.Linear(d, ffn, bias=False)
        self.fc2 = nn.Linear(ffn, d, bias=False)
        self.gate = nn.Linear(d, ffn, bias=False)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh") * self.gate(x))


class RetNetEncoderLayer(nn.Module):
    def __init__(self, d: int, ffn: int, heads: int, adaln: bool):
        super().__init__()
        self.retention = MultiScaleRetention(d, heads)
        self.retention_layer_norm = RMSNorm(d)
        self.ffn = GLU(d, ffn)
        self.final_layer_norm = RMSNorm(d)
        self.adaln = adaln
        if adaln:
            self.adaln_1 = AdaptiveLayerNorm(d)
            self.adaln_2 = AdaptiveLayerNorm(d)

    def forward(self, x, sin, cos, pair_mask, sty):
        x = x + self.retention(self.retention_layer_norm(x), sin, cos, pair_mask)
        if self.adaln:
            x = self.adaln_1(x, sty)
        x = x + self.ffn(self.final_layer_norm(x))
        if self.adaln:
            x = self.adaln_2(x, sty)
        return x


class RetNetEncoder(nn.Module):
    def __init__(self, d, ffn, layers, heads, adaln):
        super().__init__()
        self.heads = heads
        self.layers = nn.ModuleList(RetNetEncoderLayer(d, ffn, heads, adaln)
                                    for _ in range(layers))
        self.layer_norm = RMSNorm(d)

    def forward(self, x, mask, sty):
        sin, cos = rotary(x.shape[1], x.shape[2] // self.heads, x.device)
        pair_mask = (mask[:, None, :] * mask[:, :, None])[:, None]
        for layer in self.layers:
            x = layer(x, sin, cos, pair_mask, sty)
        return self.layer_norm(x)


class TextEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.spk = c["n_spks"] > 1
        width = c["enc_channels"] + (c["spk_emb_dim"] if self.spk else 0)
        self.channels = c["enc_channels"]
        self.emb = nn.Embedding(c["n_vocab"], c["enc_channels"])
        self.prenet = ConvReluNorm(c["enc_channels"])
        self.encoder = RetNetEncoder(width, c["enc_filter_channels"], c["enc_layers"],
                                     c["enc_heads"], c["use_style"])
        self.proj_m = nn.Conv1d(width, c["n_feats"], 1)
        self.proj_w = DurationPredictor(width, c["enc_filter_channels_dp"], 1)

    def forward(self, x, x_lengths, sty=None, spk=None):
        """→ mu (B, F, Tx), logw (B, 1, Tx), mask (B, 1, Tx)."""
        mask = sequence_mask(x_lengths, x.shape[1])[:, None, :].float()
        h = self.prenet(self.emb(x).transpose(1, 2) * math.sqrt(self.channels), mask)
        if self.spk:
            h = torch.cat([h, spk[:, :, None].expand(-1, -1, h.shape[-1])], 1)
        h = self.encoder(h.transpose(1, 2), mask[:, 0], sty).transpose(1, 2) * mask
        return self.proj_m(h) * mask, self.proj_w(h, mask), mask


# ---- style encoders (DeX) ------------------------------------------------

class LF0Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        h = c["lf0_c_h"]
        self.in_conv = BasicConv(1, h, True, "ln")
        self.rnn_layer = nn.GRU(h, h // 2, c["lf0_layers"], batch_first=True, bidirectional=True)
        self.out_conv = BasicConv(h, c["lf0_c_out"], True, "ln")
        self.proj = DurationPredictor(c["lf0_c_out"], c["lf0_c_out_g"], c["lf0_c_out_g"])

    def forward(self, lf0, mask):
        x = self.in_conv(lf0[:, None, :] * mask) * mask
        x = self.rnn_layer(x.transpose(1, 2))[0].transpose(1, 2)
        x = self.out_conv(x * mask) * mask
        return x, self.proj(x, mask)


class ResidualConvBlock(nn.Module):
    def __init__(self, c: int, norm: str):
        super().__init__()
        self.conv_block = nn.Sequential(BasicConv(c, c, True, norm), BasicConv(c, c, False))

    def forward(self, x):
        return x + self.conv_block(x)


class VQEmbeddingEMA(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.register_buffer("embedding", torch.zeros(n, d))
        self.register_buffer("ema_count", torch.zeros(n))
        self.register_buffer("ema_weight", torch.zeros(n, d))

    def forward(self, x, mask):
        """x (B, T, D) → the nearest code of each masked frame."""
        x = x * mask
        dist = torch.cdist(x.reshape(-1, x.shape[-1]), self.embedding)
        return self.embedding[dist.argmin(-1)].reshape(x.shape) * mask


class TVEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        h, out, out_g = c["tv_c_h"], c["tv_c_out"], c["tv_c_out_g"]
        self.in_conv = BasicConv(c["n_feats"], h, True, "ln")
        self.conv_blocks = nn.ModuleList(ResidualConvBlock(h, "ln") for _ in range(c["tv_layers"]))
        self.out_conv = BasicConv(h, out, False)
        self.vq = VQEmbeddingEMA(c["tv_n_emb"], out)
        self.proj_0 = DurationPredictor(out, out_g, out_g)
        self.proj_1 = BasicConv(out_g, out_g, True, "bn")

    def forward(self, x, mask):
        x = self.in_conv(x * mask) * mask
        for blk in self.conv_blocks:
            x = blk(x * mask) * mask
        z = self.out_conv(x * mask) * mask
        q = self.vq(z.transpose(1, 2), mask.transpose(1, 2)).transpose(1, 2)
        return z, self.proj_1(self.proj_0(q, mask) * mask) * mask


def instance_stats(x, dims):
    """Mean and unbiased standard deviation (eps 1e-5) over ``dims``."""
    mean = x.mean(dims, keepdim=True)
    return mean, torch.sqrt(x.var(dims, keepdim=True, unbiased=True) + 1e-5)


class TIVEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        h = c["tiv_c_h"]
        self.in_conv = BasicConv(c["n_feats"], h, True, "bn")
        self.conv_blocks = nn.ModuleList(ResidualConvBlock(h, "bn")
                                         for _ in range(c["tiv_layers"]))
        self.out_conv = BasicConv(h, c["tiv_c_out"], True, "bn")

    def skip_stats(self, x, mask):
        """The per-block (mean, std) over time of the skips, each (B, L, C)."""
        x = self.in_conv(x * mask) * mask
        stats = []
        for blk in self.conv_blocks:
            x = blk(x * mask) * mask
            mean, std = instance_stats(x, -1)
            stats.append((mean, std))
            x = (x - mean) / std
        return (torch.cat([m for m, _ in stats], -1).transpose(1, 2),
                torch.cat([s for _, s in stats], -1).transpose(1, 2))


class SelfAttentionPooling(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.W = nn.Linear(c, 1)

    def forward(self, x, time):
        x = torch.cat([time, x], 1)
        return (x * self.W(x).softmax(1)).sum(1)


class TIVAdaptor(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.mean_sap = SelfAttentionPooling(c)
        self.std_sap = SelfAttentionPooling(c)

    def forward(self, x, ref, time):
        mean = self.mean_sap(ref[0], time)[:, :, None, None]
        std = self.std_sap(ref[1], time)[:, :, None, None]
        mean2, std2 = instance_stats(x, (2, 3))
        return (x - mean2) / std2 * std + mean


class TVAdaptor(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.w_q = nn.Linear(c, c, bias=False)
        self.w_k = nn.Linear(c, c, bias=False)
        self.w_v = nn.Linear(c, c, bias=False)
        self.linear = nn.Linear(c, c, bias=False)

    def forward(self, x, x_mask, sty, sty_mask, time):
        c = x.shape[1]
        sty = torch.cat([time, sty], 1)
        keep = torch.cat([torch.ones_like(sty_mask[:, :1]), sty_mask], 1)
        mean2, std2 = instance_stats(x, (2, 3))
        q = self.w_q(((x - mean2) / std2).permute(0, 2, 3, 1))
        scores = torch.einsum("bhwc,btc->bhwt", q / math.sqrt(c), self.w_k(sty))
        scores = scores.masked_fill(keep[:, None, None, :] == 0, -1e4)
        out = torch.einsum("bhwt,btc->bhwc", scores.softmax(-1), self.w_v(sty))
        return (x + self.linear(out).permute(0, 3, 1, 2)) * x_mask


# ---- U-Net denoiser with the DiT middle block ---------------------------

class Block(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(dim, dim_out, 3, padding=1),
                                   nn.GroupNorm(8, dim_out), Mish())

    def forward(self, x, mask):
        return self.block(x * mask) * mask


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, t_dim: int):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(t_dim, dim_out))
        self.block1 = Block(dim, dim_out)
        self.block2 = Block(dim_out, dim_out)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, mask, t):
        h = self.block1(x, mask) + self.mlp(t)[:, :, None, None]
        return self.block2(h, mask) + self.res_conv(x * mask)


class LinearAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Conv2d(dim, 3 * heads * dim_head, 1, bias=False)
        self.to_out = nn.Conv2d(heads * dim_head, dim, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = self.to_qkv(x).reshape(b, 3, self.heads, self.dim_head, h * w).unbind(1)
        context = torch.einsum("bhdn,bhen->bhde", k.softmax(-1), v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(b, -1, h, w))


class Rezero(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))


class Residual(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fn = Rezero(LinearAttention(dim))

    def forward(self, x):
        return x + self.fn.fn(x) * self.fn.g


class Downsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def layer_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class MHSA(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.heads
        q, k, v = self.qkv(x).reshape(b, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        weights = (q @ k.transpose(-1, -2) * hd**-0.5).softmax(-1)
        return self.proj((weights @ v).transpose(1, 2).reshape(b, t, d))


class DiTBlock(nn.Module):
    def __init__(self, d: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.attn = MHSA(d, heads)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, int(d * mlp_ratio)),
                                  "fc2": nn.Linear(int(d * mlp_ratio), d)})
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 6 * d))

    def forward(self, x, c):
        sm, cm, gm, sp, cp, gp = self.adaLN_modulation(c).chunk(6, -1)
        x = x + gm[:, None] * self.attn(modulate(layer_norm(x), sm, cm))
        h = self.mlp["fc2"](F.gelu(self.mlp["fc1"](modulate(layer_norm(x), sp, cp))))
        return x + gp[:, None] * h


class FinalLayer(nn.Module):
    def __init__(self, d: int, out: int):
        super().__init__()
        self.linear = nn.Linear(d, out)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 2 * d))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, -1)
        return self.linear(modulate(layer_norm(x), shift, scale))


class TimestepEmbedder(nn.Module):
    def __init__(self, d: int, freq: int = 256):
        super().__init__()
        self.freq = freq
        self.mlp = nn.Sequential(nn.Linear(freq, d), nn.SiLU(), nn.Linear(d, d))

    def forward(self, t):
        half = self.freq // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
        args = t[:, None] * freqs[None, :]
        return self.mlp(torch.cat([torch.cos(args), torch.sin(args)], -1))


class DiT(nn.Module):
    """Overlapped patches of the mid feature map (B, C, H, W), a time
    position conv, the frequency position embedding, adaLN blocks over all
    tokens (frequency-major), the final layer, unpatchify and the mask."""

    def __init__(self, dit: dict, c_in: int, grid_h: int):
        super().__init__()
        d, p, k = dit["hidden_size"], dit["patch_size"], dit["conv_pos"]
        self.dit, self.c_in, self.grid_h = dit, c_in, grid_h
        self.x_embedder = nn.ModuleDict({"proj": nn.Sequential(
            nn.Conv2d(c_in, c_in, p, dit["stride_size"], padding=p // 2, groups=c_in),
            nn.SiLU(), nn.Conv2d(c_in, d, 1))})
        self.t_embedder = TimestepEmbedder(d)
        self.freq_new_pos_embed = nn.Parameter(torch.zeros(1, d, grid_h, 1))
        self.pos_conv = nn.Sequential(nn.Conv2d(d, d, k, padding=k // 2,
                                                groups=dit["conv_pos_groups"]))
        self.blocks = nn.ModuleList(DiTBlock(d, dit["num_heads"], dit["mlp_ratio"])
                                    for _ in range(dit["depth"]))
        self.final_layer = FinalLayer(d, dit["stride_size"] ** 2 * c_in)

    def forward(self, x, mask, t):
        b, c, h_in, w_in = x.shape
        x = F.pad(x, (0, (-w_in) % self.dit["patch_size"]))
        x = self.x_embedder["proj"](x)
        wp = x.shape[3]
        pos = self.pos_conv(x)
        if self.dit["conv_pos"] % 2 == 0:  # "same" padding for an even kernel
            pos = pos[:, :, :-1, :-1]
        x = x + F.gelu(pos).mean(2, keepdim=True)[..., :wp] + self.freq_new_pos_embed
        c_emb = self.t_embedder(t)
        tokens = x.flatten(2).transpose(1, 2)
        for blk in self.blocks:
            tokens = blk(tokens, c_emb)
        s = self.dit["stride_size"]
        out = self.final_layer(tokens, c_emb).reshape(b, self.grid_h, wp, s, s, c)
        out = out.permute(0, 5, 1, 3, 2, 4).reshape(b, c, self.grid_h * s, wp * s)
        return out[:, :, :h_in, :w_in] * mask


def sinusoidal_pos_emb(t, dim: int, scale: float):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / (half - 1))
    args = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], -1)


class DiffusionDenoiser(nn.Module):
    def __init__(self, c):
        super().__init__()
        dim, mults = c["dec_dim"], c["dec_dim_mults"]
        dims = [m * dim for m in mults]
        mid = dims[-1]
        self.dim, self.pe_scale = dim, c["pe_scale"]
        self.style, self.spk = c["use_style"], (not c["use_style"]) and c["n_spks"] > 1
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), Mish(), nn.Linear(4 * dim, dim))
        if self.style:
            self.mlp_adap = nn.Sequential(nn.Linear(dim, dim), Mish(), nn.Linear(dim, mid))
            self.mlp_adap_sty = nn.Sequential(nn.Linear(dim, dim), Mish(), nn.Linear(dim, mid))
            self.tv_adaptor = TVAdaptor(mid)
            self.tiv_adaptor = TIVAdaptor(mid)
        if self.spk:
            e = c["spk_emb_dim"]
            self.spk_mlp = nn.Sequential(nn.Linear(e, 4 * e), Mish(),
                                         nn.Linear(4 * e, c["n_feats"]))
        dim_in = 3 if self.spk else 2
        self.downs = nn.ModuleList()
        for i, dim_out in enumerate(dims):
            last = i == len(dims) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(dim_in, dim_out, dim), ResnetBlock(dim_out, dim_out, dim),
                Residual(dim_out), nn.Identity() if last else Downsample(dim_out)]))
            dim_in = dim_out
        n_down = len(mults) - 1
        self.vit = DiT(c["dit"], mid, (c["n_feats"] // 2**n_down) // c["dit"]["stride_size"])
        self.ups = nn.ModuleList()
        for d_in, d_out in zip(reversed(dims[:-1]), reversed(dims[1:])):
            self.ups.append(nn.ModuleList([
                ResnetBlock(2 * d_out, d_in, dim), ResnetBlock(d_in, d_in, dim),
                Residual(d_in), Upsample(d_in)]))
        self.final_block = Block(dim, dim)
        self.final_conv = nn.Conv2d(dim, 1, 1)

    def forward(self, x, mask, mu, t, ref=None, sty=None, sty_lengths=None, spk=None):
        """x, mu (B, F, W); mask (B, 1, W); t (B,) → (B, F, W)."""
        channels = [mu, x]
        if self.spk:
            channels.append(self.spk_mlp(spk)[:, :, None].expand(-1, -1, x.shape[-1]))
        h = torch.stack(channels, 1)
        mask = mask[:, None]
        t_init = sinusoidal_pos_emb(t, self.dim, self.pe_scale)
        t_unet = self.mlp(t_init)
        hiddens, masks = [], [mask]
        for res1, res2, attn, down in self.downs:
            m = masks[-1]
            h = attn(res2(res1(h, m, t_unet), m, t_unet))
            hiddens.append(h)
            h = down(h * m)
            masks.append(m[..., ::2])
        masks = masks[:-1]
        if self.style:
            sty_mask = sequence_mask(sty_lengths, sty.shape[1]).float()
            h = self.tv_adaptor(h, masks[-1], sty, sty_mask, self.mlp_adap_sty(t_init)[:, None])
            h = self.tiv_adaptor(h, ref, self.mlp_adap(t_init)[:, None])
        h = self.vit(h, masks[-1], t)
        for (res1, res2, attn, up), m in zip(self.ups, reversed(masks[1:])):
            h = torch.cat([h, hiddens.pop()], 1)
            h = up(attn(res2(res1(h, m, t_unet), m, t_unet)) * m)
        h = self.final_block(h, mask)
        return (self.final_conv(h * mask) * mask)[:, 0]


# ---- the facade ---------------------------------------------------------

def generate_path(w_ceil, mask):
    """Durations (B, Tx) → the monotonic 0/1 path (B, Tx, Ty)."""
    cum = torch.cumsum(w_ceil, 1)
    pos = torch.arange(mask.shape[2], device=cum.device, dtype=cum.dtype)
    upper = (pos[None, None, :] < cum[:, :, None]).float()
    return (upper - F.pad(upper, (0, 0, 1, 0))[:, :-1]) * mask


class TTS(nn.Module):
    """GeDEX-TTS, or DeX-TTS with ``use_style`` (three style encoders)."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        if c["n_spks"] > 1:
            self.spk_emb = nn.Embedding(c["n_spks"], c["spk_emb_dim"])
        self.encoder = TextEncoder(c)
        self.decoder = nn.Module()
        self.decoder.denoise_fn = DiffusionDenoiser(c)
        if c["use_style"]:
            self.tv_encoder = TVEncoder(c)
            self.lf0_encoder = LF0Encoder(c)
            self.tiv_encoder = TIVEncoder(c)
            mid = c["dec_dim"] * c["dec_dim_mults"][-1]
            self.conv_sty = nn.Conv1d(c["tv_c_out_g"], mid, 1)

    def style(self, ref, ref_lengths, lf0):
        """DeX's style from reference features: the global vector for the
        text encoder and the denoiser's keyword arguments."""
        mask = sequence_mask(ref_lengths, ref.shape[2])[:, None, :].float()
        lf0_enc, lf0_dec = self.lf0_encoder(lf0, mask)
        z, tv_dec = self.tv_encoder(ref, mask)
        frames = mask.sum(-1)
        sty_enc = z.sum(-1) / frames + lf0_enc.sum(-1) / frames
        sty_dec = self.conv_sty(tv_dec + (lf0_dec.sum(-1) / frames)[:, :, None])
        return sty_enc, {"ref": self.tiv_encoder.skip_stats(ref, mask),
                         "sty": sty_dec.transpose(1, 2), "sty_lengths": ref_lengths}

    @torch.no_grad()
    def encode(self, x, x_lengths, ref=None, ref_lengths=None, lf0=None, spk=None):
        """→ (mu_x (B, F, Tx), logw (B, 1, Tx), x_mask, denoiser kwargs)."""
        if self.c["use_style"]:
            sty_enc, kwargs = self.style(ref, ref_lengths, lf0)
        else:
            spk_vec = self.spk_emb(spk) if self.c["n_spks"] > 1 else None
            sty_enc, kwargs = None, {"spk": spk_vec}
        mu, logw, mask = self.encoder(x, x_lengths, sty=sty_enc, spk=kwargs.get("spk"))
        return mu, logw, mask, kwargs

    @staticmethod
    def frames(logw, x_mask):
        """The pre-pass: frames per item, Σ ⌈exp(logw)⌉ over the tokens."""
        return torch.ceil(torch.exp(logw) * x_mask).sum((1, 2))

    @torch.no_grad()
    def synthesize(self, encoded, y_max: int, noise, solver: str, steps: int,
                   temperature: float):
        """Text→mel at the frame bucket ``y_max`` from the initial ``noise``
        (B, F, y_max) → (mel (B, F, y_max), y_lengths (B,))."""
        mu_x, logw, x_mask, kwargs = encoded
        w_ceil = torch.ceil(torch.exp(logw[:, 0]) * x_mask[:, 0])
        y_lengths = torch.clamp(w_ceil.sum(1), 1, y_max).long()
        y_mask = sequence_mask(y_lengths, y_max).float()
        attn = generate_path(w_ceil, x_mask[:, 0, :, None] * y_mask[:, None, :])
        mu_y = torch.einsum("bxt,bfx->bft", attn, mu_x)
        mask = y_mask[:, None, :]
        denoiser = self.decoder.denoise_fn
        mel = sample(lambda z, t: denoiser(z, mask, mu_y, t, **kwargs),
                     noise / temperature + mu_y, solver, steps)
        return mel * mask, y_lengths
