"""Presets and model factory (port of dex_tts_tpu/config/__init__.py).

Presets are Python dataclasses, not YAML reads: the machine with the card
has no PyYAML. ``vctk`` is transcribed from
dex_tts_tpu/config/presets/vctk.yaml (reference: DEX-TTS/config/VCTK/
base.yaml; f32 compute); ``esd`` from dex_tts_tpu/config/presets/esd.yaml
(the same model, with its ``train:`` block: the configuration that
bench_train.py trains); ``vctk_bench`` is the benchmark's full-size DeX
(bf16 compute, attention "auto") with HiFi-GAN; ``vctk_bench_bigvgan`` is
the same DeX with the bf16 BigVGAN at the released 22 kHz 80-band widths,
the JAX bench's ``--vocoder bigvgan`` (bench.py:108-119);
``dex_vctk_bigvgan_v2_44k`` is the VCTK DeX at 128 mel bands (bf16
compute) behind BigVGAN-v2 44 kHz 128-band 512x, with a 44.1 kHz front
end (configs/dex_vctk_bigvgan_v2_44k.yaml is the same preset as a YAML);
``gedex_bench``
is the benchmark's GeDEX (`__graft_entry__._full_size_gedex`: patch 7,
stride 4, one speaker, no style) with HiFi-GAN. ``libritts``,
``gedex_vctk`` and ``gedex_ljspeech`` are transcribed from their YAMLs
in dex_tts_tpu/config/presets/ (GeDEX: no style; VCTK's 108 speakers,
LJSpeech's one with DiT patch 7 / stride 4; both read EMA weights).

`preset_from_config` builds a Preset from a YAML config in the JAX
package's layout (`utils.config.Config`), as `dex_tts_tpu.config.
build_model`/`build_dit_config` and the JAX entry points read it, with
their ``.get`` defaults and casts. Keys that chose a TPU lowering of the
same math are accepted and change nothing here: ``model.dit.
pos_conv_impl``, ``flash_block_q``, ``flash_block_k`` and ``model.
decoder.linattn_impl`` are carried into the configs, which ignore them;
``vocoder_upsample_impl``, ``vocoder_snake_pallas`` and
``vocoder_snake_impl`` are not read. Paths stay as the YAML gives them,
relative to the working directory.
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
from dex_tts_tpu_torch.pipeline import AudioConfig
from dex_tts_tpu_torch.text.symbols import N_VOCAB
from dex_tts_tpu_torch.utils.config import Config
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
    ``train``). ``ema`` is ``test.ema`` (synthesize from the EMA weights);
    ``vocoder_path`` is ``path.vocoder_path``, the directory (or file) of
    the vocoder's reference checkpoint, relative to the working
    directory. ``sample_rate``, ``hop_length``, ``n_fft``, ``win_length``,
    ``n_mels``, ``f_min`` and ``f_max`` are the ``preprocess`` section's
    mel parameters, which the vocoder trainer trains on and the
    Synthesizer synthesizes at (`audio`), with `pipeline.AudioConfig`'s
    defaults. ``vocoder_dtype``
    is the YAML's ``vocoder_dtype``: "auto" (bf16 BigVGAN on the card,
    f32 otherwise) or a dtype that `eval.evaluation.load_vocoder` forces."""

    model: TTSConfig
    vocoder: HiFiGANConfig | BigVGANConfig = field(default_factory=HiFiGANConfig)
    n_timesteps: int = 50
    temperature: float = 1.5
    cmu_path: str = os.path.join(REPO_ROOT, "resources", "cmu_dictionary")
    train: TrainConfig | None = None
    train_path: str | None = None
    val_path: str | None = None
    add_blank: bool = True
    sample_rate: int = AudioConfig.sample_rate
    hop_length: int = AudioConfig.hop_length
    n_fft: int = AudioConfig.n_fft
    win_length: int = AudioConfig.win_length
    n_mels: int = AudioConfig.n_mels
    f_min: float = AudioConfig.f_min
    f_max: float | None = AudioConfig.f_max
    ema: bool = False
    vocoder_path: str = "hifigan/weights"
    vocoder_dtype: str = "auto"

    def out_size(self) -> int | None:
        """Training mel segment length: ``fix_len`` s of audio, rounded for
        the U-Net (reference: DEX-TTS/main.py:61-64; 2 s ⇒ 172 frames)."""
        if self.train is None or not self.train.out_size:
            return None
        return fix_len_compatibility(int(self.train.fix_len * self.sample_rate / self.hop_length))

    def audio(self) -> AudioConfig:
        """The mel parameters as the Synthesizer takes them."""
        return AudioConfig(**{f.name: getattr(self, f.name)
                              for f in dataclasses.fields(AudioConfig)})


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


def dex_vctk_bigvgan_v2_44k() -> Preset:
    """`vctk`'s DeX (DEX-TTS/config/VCTK/base.yaml widths) at 128 mel bands
    with bf16 compute, behind NVIDIA's BigVGAN-v2
    bigvgan_v2_44khz_128band_512x (config.json: rates (8, 4, 2, 2, 2, 2),
    kernels (16, 8, 4, 4, 4, 4), 1536 channels, snakebeta in logscale, no
    tanh and no bias at the head), and its 44.1 kHz front end: n_fft 2048,
    hop 512, window 2048, 0 Hz to Nyquist. No 44.1 kHz DEX-TTS checkpoint
    is published: the 128 bands and the front end follow the vocoder."""
    dex = vctk()
    return dataclasses.replace(
        dex,
        model=dataclasses.replace(dex.model, n_feats=128, compute_dtype="bfloat16"),
        vocoder=BigVGANConfig(
            num_mels=128, upsample_rates=(8, 4, 2, 2, 2, 2),
            upsample_kernel_sizes=(16, 8, 4, 4, 4, 4), upsample_initial_channel=1536,
            use_tanh_at_final=False, use_bias_at_final=False),
        sample_rate=44100, hop_length=512, n_fft=2048, win_length=2048, n_mels=128,
        f_min=0.0, f_max=None, vocoder_path="bigvgan_v2_44khz_128band_512x",
    )


def gedex_bench() -> Preset:
    """The benchmark's GeDEX at the reference's LJSpeech scale
    (`__graft_entry__._full_size_gedex`; GeDEX-TTS/config/LJSpeech/
    base.yaml:29-62): bf16 compute, DiT patch 7 / stride 4, attention
    "auto", no style, one speaker."""
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
                patch_size=7,
                stride_size=4,
                hidden_size=256,
                depth=4,
                num_heads=2,
                mlp_ratio=2.0,
                conv_pos=16,
                conv_pos_groups=8,
                attention="auto",
            ),
        )
    )


def libritts() -> Preset:
    """dex_tts_tpu/config/presets/libritts.yaml: the VCTK model with
    LibriTTS's filelists and ``train:`` block."""
    return dataclasses.replace(
        vctk(),
        train=TrainConfig(
            epoch=1000, batch_size=32, lr=1e-4, save_epoch=200, syn_every=200, fix_len=2,
            out_size=True, max_grad=1.0, ema_decay=0.99999, mask_ratio=0.0, ref_type="mel",
            sty_type="mel", aug_type=("N", "N", "N"),
            unseen_spk=(18, 22, 44, 50, 55, 58, 64, 90, 93, 98), x_quantum=32, y_quantum=64,
        ),
        train_path="filelists/LibriTTS/train.txt",
        val_path="filelists/LibriTTS/valid.txt",
    )


def _gedex(n_spks: int, patch_size: int, stride_size: int, dataset: str,
           epoch: int) -> Preset:
    """The GeDEX presets' shared fields (reference: GeDEX-TTS/config/
    LJSpeech/base.yaml): the VCTK encoder and decoder, no style encoders,
    EMA weights at test time."""
    dex = vctk().model
    model = dataclasses.replace(
        dex, n_spks=n_spks, use_style=False,
        dit=dataclasses.replace(dex.dit, patch_size=patch_size, stride_size=stride_size),
    )
    return Preset(
        model=model,
        train=TrainConfig(
            epoch=epoch, batch_size=32, lr=1e-4, save_epoch=200, syn_every=200, fix_len=2,
            out_size=True, max_grad=1.0, ema_decay=0.9999, mask_ratio=0.0, unseen_spk=(),
            x_quantum=32, y_quantum=64,
        ),
        train_path=f"filelists/{dataset}/train.txt",
        val_path=f"filelists/{dataset}/valid.txt",
        ema=True,
    )


def gedex_vctk() -> Preset:
    """dex_tts_tpu/config/presets/gedex_vctk.yaml: 108 speakers, DiT
    patch 3 / stride 2."""
    return _gedex(108, 3, 2, "VCTK", epoch=1000)


def gedex_ljspeech() -> Preset:
    """dex_tts_tpu/config/presets/gedex_ljspeech.yaml: one speaker, DiT
    patch 7 / stride 4."""
    return _gedex(1, 7, 4, "LJSpeech", epoch=2000)


PRESETS = {"vctk": vctk, "esd": esd, "libritts": libritts, "gedex_vctk": gedex_vctk,
           "gedex_ljspeech": gedex_ljspeech, "vctk_bench": vctk_bench,
           "vctk_bench_bigvgan": vctk_bench_bigvgan, "gedex_bench": gedex_bench,
           "dex_vctk_bigvgan_v2_44k": dex_vctk_bigvgan_v2_44k}


def load_preset(name: str) -> Preset:
    return PRESETS[name]()


def _dit_config(d) -> DiTConfig:
    """The ``model.dit`` section (JAX: config/__init__.py build_dit_config)."""
    return DiTConfig(
        patch_size=d.patch_size,
        stride_size=d.stride_size,
        overlap=d.get("overlap", True),
        hidden_size=d.hidden_size,
        depth=d.depth,
        num_heads=d.num_heads,
        mlp_ratio=float(d.mlp_ratio),
        conv_pos=d.get("conv_pos", 16),
        conv_pos_groups=d.get("conv_pos_groups", 8),
        pos_conv_impl=d.get("pos_conv_impl", DiTConfig.pos_conv_impl),
        pos_embed_time=d.get("pos_embed_time", DiTConfig.pos_embed_time),
        mask_type=d.get("mask_type", "random"),
        use_decoder=d.get("use_decoder", False),
        attention=d.get("attention", "einsum"),
        auto_flash_min_tokens=d.get("auto_flash_min_tokens", DiTConfig.auto_flash_min_tokens),
        auto_flash_min_tokens_train=d.get("auto_flash_min_tokens_train",
                                          DiTConfig.auto_flash_min_tokens_train),
        flash_block_q=d.get("flash_block_q", None),
        flash_block_k=d.get("flash_block_k", None),
    )


def _tts_config(cfg) -> TTSConfig:
    """The ``model`` section and ``model_family``/``n_vocab`` (JAX:
    config/__init__.py build_model; DeX forces n_spks=0)."""
    m, enc, dec = cfg.model, cfg.model.encoder, cfg.model.decoder
    common = dict(
        n_vocab=cfg.get("n_vocab", N_VOCAB),
        n_feats=m.n_feats,
        spk_emb_dim=m.get("spk_emb_dim", 64),
        enc_channels=enc.n_channels,
        enc_filter_channels=enc.filter_channels,
        enc_filter_channels_dp=enc.filter_channels_dp,
        enc_heads=enc.n_heads,
        enc_layers=enc.n_layers,
        enc_kernel=enc.kernel_size,
        enc_dropout=enc.p_dropout,
        use_softmax=enc.get("use_softmax", True),
        use_decay=enc.get("use_decay", False),
        dec_dim=dec.dim,
        dec_dim_mults=tuple(dec.dim_mults),
        pe_scale=float(dec.get("pe_scale", 1000)),
        loss_type=dec.get("loss_type", "base"),
        compute_dtype=dec.get("compute_dtype", "float32"),
        linattn_impl=dec.get("linattn_impl", "fused"),
        dit=_dit_config(m.dit),
    )
    if cfg.get("model_family", "dex") != "dex":
        return TTSConfig(n_spks=m.get("n_spks", 1), **common)
    tv, lf0, tiv = m.tv_encoder, m.lf0_encoder, m.tiv_encoder
    return TTSConfig(
        n_spks=0, use_style=True,
        tv_c_h=tv.c_h, tv_c_out=tv.c_out, tv_c_out_g=tv.c_out_g, tv_layers=tv.num_layer,
        tv_n_emb=tv.n_emb, tv_commit_w=tv.commit_w,
        lf0_c_h=lf0.c_h, lf0_c_out=lf0.c_out, lf0_c_out_g=lf0.c_out_g,
        lf0_layers=lf0.num_layer,
        tiv_c_h=tiv.c_h, tiv_c_out=tiv.c_out, tiv_layers=tiv.num_layer,
        **common,
    )


def _train_config(tr) -> TrainConfig:
    """The ``train`` section, with main.py's defaults and casts."""
    return TrainConfig(
        epoch=int(tr.epoch),
        batch_size=int(tr.batch_size),
        lr=float(tr.lr),
        save_epoch=int(tr.get("save_epoch", 200)),
        syn_every=int(tr.get("syn_every", 0)),
        fix_len=float(tr.get("fix_len", 2)),
        out_size=bool(tr.get("out_size", True)),
        max_grad=float(tr.get("max_grad", 1.0)),
        ema_decay=float(tr.get("ema_decay", 0.9999)),
        mask_ratio=float(tr.get("mask_ratio", 0.0)),
        ref_type=tr.get("ref_type", "mel"),
        sty_type=tr.get("sty_type", "mel"),
        aug_type=tuple(tr.get("aug_type", ["N", "N", "N"])),
        unseen_spk=tuple(tr.get("unseen_spk", ())),
        x_quantum=int(tr.get("x_quantum", 32)),
        y_quantum=int(tr.get("y_quantum", 64)),
        accum_steps=int(tr.get("accum_steps", 1)),
        async_ckpt=bool(tr.get("async_ckpt", False)),
    )


def preset_from_config(cfg) -> Preset:
    """A YAML config in the JAX package's layout (`utils.config.Config`)
    → Preset: the model, the vocoder ``vocoder`` names at the
    ``preprocess`` section's n_mels (HiFi-GAN or BigVGAN, as the JAX
    loader builds them), ``test``'s ema, steps and temperature, ``path``'s
    filelists, CMU dictionary and vocoder path, the mel parameters, the
    ``train`` block (None without one) and ``vocoder_dtype``."""
    pre, test, path = cfg.get("preprocess", {}), cfg.get("test", {}), cfg.path
    n_mels = int(pre.get("n_mels", 80))
    kind = str(cfg.get("vocoder", "hifigan")).lower()
    f_max = pre.get("f_max", 8000.0)
    return Preset(
        model=_tts_config(cfg),
        vocoder=(BigVGANConfig if kind == "bigvgan" else HiFiGANConfig)(num_mels=n_mels),
        n_timesteps=int(test.get("n_timesteps", 50)),
        temperature=float(test.get("temperature", 1.5)),
        cmu_path=path.get("cmu_path"),
        train=_train_config(cfg.train) if cfg.get("train") else None,
        train_path=path.get("train_path"),
        val_path=path.get("val_path"),
        add_blank=bool(cfg.model.get("add_blank", True)),
        sample_rate=int(pre.get("sample_rate", 22050)),
        hop_length=int(pre.get("hop_length", 256)),
        n_fft=int(pre.get("n_fft", 1024)),
        win_length=int(pre.get("win_length", 1024)),
        n_mels=n_mels,
        f_min=float(pre.get("f_min", 0.0)),
        f_max=None if f_max is None else float(f_max),
        ema=bool(test.get("ema", False)),
        vocoder_path=path.get("vocoder_path", ""),
        vocoder_dtype=str(cfg.get("vocoder_dtype") or "auto"),
    )


def load_preset_or_config(preset: str | None = None, config: str | None = None) -> Preset:
    """The entry points' ``--preset NAME`` or ``--config YAML``."""
    if config is not None:
        return preset_from_config(Config(config))
    return load_preset(preset)


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
