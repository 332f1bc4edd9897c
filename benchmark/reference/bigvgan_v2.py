"""The plain BigVGAN-v2 generator from a configuration's ``vocoder``
section: `benchmark.reference.vocoders.BigVGAN` with the v2 head of
NVIDIA/BigVGAN bigvgan.py (v2 release), where ``use_bias_at_final`` false
builds ``conv_post`` without a bias and ``use_tanh_at_final`` false
clamps the waveform to [-1, 1] in place of ``tanh``. Float32, inference;
the comparison runs it with TF32 off (`benchmark.check.strict_float32`)."""

import torch
import torch.nn as nn

from benchmark.reference.vocoders import BigVGAN


class BigVGANv2(BigVGAN):
    def __init__(self, c):
        super().__init__(c)
        self.use_tanh = c.get("use_tanh_at_final", True)
        if not c.get("use_bias_at_final", True):
            self.conv_post = nn.Conv1d(self.conv_post.in_channels, 1, 7, padding=3, bias=False)

    def forward(self, mel):
        x = self.conv_pre(mel)
        for i, (up,) in enumerate(self.ups):
            x = up(x)
            x = sum(self.resblocks[i * self.n_k + j](x) for j in range(self.n_k)) / self.n_k
        x = self.conv_post(self.activation_post(x))
        return (torch.tanh(x) if self.use_tanh else x.clamp(-1.0, 1.0))[:, 0]


def build(config: dict) -> BigVGANv2:
    return BigVGANv2(config["vocoder"]).eval()
