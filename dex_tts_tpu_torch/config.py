"""Presets and model factory (port of dex_tts_tpu/config/__init__.py).

Presets are Python dataclasses, not YAML reads: the machine with the card
has no PyYAML. ``vctk`` is transcribed from
dex_tts_tpu/config/presets/vctk.yaml (reference: DEX-TTS/config/VCTK/
base.yaml; f32 compute); ``vctk_bench`` is the benchmark's full-size DeX
(bf16 compute, attention "auto") with HiFi-GAN; ``vctk_bench_bigvgan`` is
the same DeX with the bf16 BigVGAN at the released 22 kHz 80-band widths,
the JAX bench's ``--vocoder bigvgan`` (bench.py:108-119).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

from dex_tts_tpu_torch.models.dit import DiTConfig
from dex_tts_tpu_torch.models.tts import GeDEXTTS, TTSConfig, build_tts
from dex_tts_tpu_torch.models.vocoder import (
    BigVGANConfig,
    BigVGANGenerator,
    HiFiGANConfig,
    HiFiGANGenerator,
)
from dex_tts_tpu_torch.text.symbols import N_VOCAB
from dex_tts_tpu_torch.utils.device import resolve_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class Preset:
    """A model config plus what inference reads from the rest of its YAML
    (``vocoder``, ``test``, ``path.cmu_path``)."""

    model: TTSConfig
    vocoder: HiFiGANConfig | BigVGANConfig = field(default_factory=HiFiGANConfig)
    n_timesteps: int = 50
    temperature: float = 1.5
    cmu_path: str = os.path.join(REPO_ROOT, "resources", "cmu_dictionary")


def vctk() -> Preset:
    """dex_tts_tpu/config/presets/vctk.yaml."""
    return Preset(
        model=TTSConfig(
            n_vocab=N_VOCAB,
            n_feats=80,
            n_spks=0,
            spk_emb_dim=64,
            enc_channels=192,
            enc_filter_channels=1024,
            enc_filter_channels_dp=256,
            enc_heads=2,
            enc_layers=8,
            enc_kernel=3,
            enc_dropout=0.1,
            use_softmax=True,
            use_decay=False,
            dec_dim=64,
            dec_dim_mults=(1, 2),
            pe_scale=1000.0,
            loss_type="base",
            compute_dtype="float32",
            linattn_impl="fused",
            dit=DiTConfig(
                patch_size=3,
                stride_size=2,
                overlap=True,
                hidden_size=256,
                depth=4,
                num_heads=2,
                mlp_ratio=2.0,
                conv_pos=16,
                conv_pos_groups=8,
                mask_type="time_random",
                use_decoder=False,
                attention="auto",
            ),
            use_style=True,
            tv_c_h=128,
            tv_c_out=192,
            tv_c_out_g=192,
            tv_layers=6,
            tv_n_emb=512,
            tv_commit_w=0.25,
            lf0_c_h=192,
            lf0_c_out=192,
            lf0_c_out_g=192,
            lf0_layers=2,
            tiv_c_h=128,
            tiv_c_out=64,
            tiv_layers=6,
        )
    )


def vctk_bench() -> Preset:
    """The benchmark's flagship DeX at the reference VCTK width
    (`__graft_entry__._full_size_dex`): bf16 compute, attention "auto"."""
    return Preset(
        model=TTSConfig(
            n_vocab=149,
            n_feats=80,
            compute_dtype="bfloat16",
            enc_channels=192,
            enc_filter_channels=1024,
            enc_filter_channels_dp=256,
            enc_heads=2,
            enc_layers=8,
            dec_dim=64,
            dec_dim_mults=(1, 2),
            dit=DiTConfig(
                patch_size=3,
                stride_size=2,
                hidden_size=256,
                depth=4,
                num_heads=2,
                mlp_ratio=2.0,
                conv_pos=16,
                conv_pos_groups=8,
                attention="auto",
            ),
            use_style=True,
        )
    )


def vctk_bench_bigvgan() -> Preset:
    """`vctk_bench`'s DeX with BigVGAN in bf16 (snake_impl "auto": the
    fold kernel's polynomial sin²), every other field at its default:
    1536 channels, rates (4, 4, 2, 2, 2, 2)."""
    return dataclasses.replace(
        vctk_bench(), vocoder=BigVGANConfig(num_mels=80, dtype="bfloat16")
    )


PRESETS = {"vctk": vctk, "vctk_bench": vctk_bench, "vctk_bench_bigvgan": vctk_bench_bigvgan}


def load_preset(name: str) -> Preset:
    return PRESETS[name]()


def build_model(cfg: TTSConfig, device=None) -> GeDEXTTS:
    """TTSConfig → DeXTTS (use_style) or GeDEXTTS, in eval mode on
    ``device`` (CUDA by default)."""
    return build_tts(cfg).to(resolve_device(device))


def build_vocoder(cfg: HiFiGANConfig | BigVGANConfig, device=None):
    """Vocoder config → HiFiGANGenerator or BigVGANGenerator, in eval mode
    on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    cls = BigVGANGenerator if isinstance(cfg, BigVGANConfig) else HiFiGANGenerator
    return cls(cfg).eval().to(device)
