"""Presets and model factory (port of dex_tts_tpu/config/__init__.py).

Presets are Python dataclasses, not YAML reads: the machine with the card
has no PyYAML. ``vctk`` is transcribed from
dex_tts_tpu/config/presets/vctk.yaml (reference: DEX-TTS/config/VCTK/
base.yaml; f32 compute); ``esd`` from dex_tts_tpu/config/presets/esd.yaml
(the same model, with its ``train:`` block: the configuration that
bench_train.py trains); ``vctk_bench`` is the benchmark's full-size DeX
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
from dex_tts_tpu_torch.ops.masks import fix_len_compatibility
from dex_tts_tpu_torch.text.symbols import N_VOCAB
from dex_tts_tpu_torch.utils.device import resolve_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class TrainConfig:
    """A preset's ``train:`` block. Defaults are what the JAX package's
    main.py takes when a key is missing."""

    epoch: int
    batch_size: int
    lr: float
    save_epoch: int = 200
    syn_every: int = 0
    fix_len: float = 2.0  # seconds of mel per training segment
    out_size: bool = True
    max_grad: float = 1.0
    ema_decay: float = 0.9999
    mask_ratio: float = 0.0
    ref_type: str = "mel"
    sty_type: str = "mel"
    aug_type: tuple = ("N", "N", "N")
    unseen_spk: tuple = ()
    x_quantum: int = 32
    y_quantum: int = 64
    accum_steps: int = 1
    async_ckpt: bool = False


@dataclass(frozen=True)
class Preset:
    """A model config plus what inference and training read from the rest
    of its YAML (``vocoder``, ``test``, ``path``, ``preprocess``,
    ``train``)."""

    model: TTSConfig
    vocoder: HiFiGANConfig | BigVGANConfig = field(default_factory=HiFiGANConfig)
    n_timesteps: int = 50
    temperature: float = 1.5
    cmu_path: str = os.path.join(REPO_ROOT, "resources", "cmu_dictionary")
    train: TrainConfig | None = None
    train_path: str | None = None
    val_path: str | None = None
    add_blank: bool = True
    sample_rate: int = 22050
    hop_length: int = 256

    def out_size(self) -> int | None:
        """Training mel segment length: ``fix_len`` s of audio, rounded for
        the U-Net (reference: DEX-TTS/main.py:61-64; 2 s ⇒ 172 frames)."""
        if self.train is None or not self.train.out_size:
            return None
        return fix_len_compatibility(int(self.train.fix_len * self.sample_rate / self.hop_length))


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


def esd() -> Preset:
    """dex_tts_tpu/config/presets/esd.yaml: the VCTK model (f32, attention
    "auto") with ESD's filelists and ``train:`` block."""
    return dataclasses.replace(
        vctk(),
        train=TrainConfig(
            epoch=2000, batch_size=32, lr=1e-4, save_epoch=200, syn_every=200, fix_len=2,
            out_size=True, max_grad=5.0, ema_decay=0.99999, mask_ratio=0.0, ref_type="mel",
            sty_type="mel", aug_type=("N", "N", "N"), unseen_spk=(0, 7), x_quantum=32,
            y_quantum=64,
        ),
        train_path="filelists/ESD/train.txt",
        val_path="filelists/ESD/valid.txt",
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


PRESETS = {"vctk": vctk, "esd": esd, "vctk_bench": vctk_bench,
           "vctk_bench_bigvgan": vctk_bench_bigvgan}


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
