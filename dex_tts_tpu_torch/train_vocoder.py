"""Vocoder GAN training CLI: HiFi-GAN or BigVGAN against MPD/MRD (port of
train_vocoder.py).

    python -m dex_tts_tpu_torch.train_vocoder --data ./preprocessed/LJSpeech/wav \\
        --vocoder bigvgan --steps 100000 --ckpt_dir ckpt_bigvgan [--preset esd] \\
        [--resume] [--init_gen generator.pth] [--device cuda]

Trains on raw WAVs (a directory, a list of paths or a TTS filelist), both
mels computed on the device inside the step. ``--preset`` takes the mel
parameters of a TTS preset's ``preprocess`` section, the ones the TTS
pipeline will feed the vocoder. Runs on the card unless ``--device cpu``;
without a card it raises. Checkpoints: ``<ckpt_dir>/last.pth``,
``step_{n}.pth`` and ``gen_last.pth`` (the generator alone, which
`eval.evaluation.load_vocoder` serves when the preset's ``vocoder_path``
is ``ckpt_dir``). SIGTERM/SIGINT save ``preempt.pth`` and ``last.pth``
and stop. Data parallelism (the JAX CLI's ``--n_devices``) is not ported.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from dex_tts_tpu_torch.audio.stft import MelSpectrogram
from dex_tts_tpu_torch.config import load_preset
from dex_tts_tpu_torch.convert import fold_weight_norm, load_torch_checkpoint
from dex_tts_tpu_torch.data.vocoder_dataset import WavSegmentDataset, wav_paths_from_source
from dex_tts_tpu_torch.eval.evaluation import BIGVGAN_FILTER_SUFFIXES
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, HiFiGANConfig
from dex_tts_tpu_torch.models.vocoder.discriminators import DiscriminatorConfig
from dex_tts_tpu_torch.train.preemption import PreemptionGuard
from dex_tts_tpu_torch.train.vocoder import (
    VocoderCheckpoints,
    VocoderTrainState,
    create_vocoder_train_state,
    make_vocoder_train_step,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="wav directory or TTS filelist")
    p.add_argument("--preset", default=None,
                   help="TTS preset whose mel parameters the vocoder trains on (the ones "
                        "the TTS pipeline feeds it at serving time)")
    p.add_argument("--vocoder", choices=["hifigan", "bigvgan"], default="hifigan")
    p.add_argument("--segment", type=int, default=8192)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr_decay", type=float, default=0.999)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--lambda_mel", type=float, default=45.0)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--cache_gb", type=float, default=2.0,
                   help="decoded-audio host cache bound (0 disables)")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--ckpt_dir", default="ckpt_vocoder")
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_gen", default=None, metavar="PATH",
                   help="warm-start the generator from a released torch checkpoint "
                        "(.pth/.pth.tar[.zip], weight norm folded); critics and optimizers "
                        "start fresh")
    p.add_argument("--device", default=None, help="default: cuda")
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def warm_start_generator(state: VocoderTrainState, path: str) -> VocoderTrainState:
    """Load a released generator checkpoint (weight-normed, possibly
    zipped) into a fresh state's generator, strictly; BigVGAN's Kaiser-sinc
    filter buffers are dropped, as `load_vocoder` does. The critics and
    both optimizers stay fresh (the state must not have stepped)."""
    if state.step:
        raise ValueError(f"warm start needs a fresh state, this one is at step {state.step}")
    weights = fold_weight_norm(load_torch_checkpoint(path))
    weights = {k: torch.from_numpy(v.copy()) for k, v in weights.items()
               if not k.endswith(BIGVGAN_FILTER_SUFFIXES)}
    state.generator.load_state_dict(weights, strict=True)
    return state


def mel_settings(args) -> dict:
    """MelSpectrogram keywords: the preset's preprocess section, else the
    defaults at ``--sample_rate``."""
    if not args.preset:
        return dict(sample_rate=args.sample_rate)
    pre = load_preset(args.preset)
    return dict(n_fft=pre.n_fft, hop_length=pre.hop_length, win_length=pre.win_length,
                n_mels=pre.n_mels, sample_rate=pre.sample_rate, fmin=pre.f_min, fmax=pre.f_max)


def main(argv=None) -> VocoderTrainState:
    """Train as the flags say → the final state."""
    p = build_parser()
    args = p.parse_args(argv)
    mel_kw = mel_settings(args)
    n_mels = mel_kw.get("n_mels", 80)
    sample_rate = mel_kw["sample_rate"]
    gen_cfg = (HiFiGANConfig(num_mels=n_mels) if args.vocoder == "hifigan"
               else BigVGANConfig(num_mels=n_mels))
    mel = MelSpectrogram(**mel_kw)
    up = int(np.prod(gen_cfg.upsample_rates))
    if up != mel.hop_length:
        p.error(f"generator upsamples x{up} but the mel hop is {mel.hop_length}; pick "
                "matching upsample_rates/hop")
    if args.segment % mel.hop_length:
        p.error(f"--segment {args.segment} must be a multiple of the mel hop ({mel.hop_length})")
    # full-band mel for the L1 term (upstream fmax_for_loss: null)
    mel_l1 = MelSpectrogram(**{**mel_kw, "fmax": sample_rate / 2})

    data = WavSegmentDataset(wav_paths_from_source(args.data), segment=args.segment,
                             sample_rate=sample_rate, seed=args.seed,
                             cache_bytes=int(args.cache_gb * (1 << 30)))
    print(f"{len(data)} wav files from {args.data}")
    state = create_vocoder_train_state(gen_cfg, DiscriminatorConfig(), lr=args.lr,
                                       lr_decay=args.lr_decay,
                                       steps_per_epoch=args.steps_per_epoch, seed=args.seed,
                                       device=args.device)
    if args.init_gen:
        warm_start_generator(state, args.init_gen)
        print(f"generator warm start from {args.init_gen}")
    step_fn = make_vocoder_train_step(mel, mel_l1, lambda_mel=args.lambda_mel)

    ckpt = VocoderCheckpoints(args.ckpt_dir)
    if args.resume and ckpt.exists("last"):
        ckpt.restore(state, "last")
        print(f"resumed at step {state.step}")

    guard = PreemptionGuard()  # SIGTERM/SIGINT → save and stop
    start = state.step
    t0, last_log = time.time(), start
    try:
        for i, batch in enumerate(data.batches(args.batch, args.steps - start), 1):
            if guard.triggered:
                print("preempted: saving checkpoint and exiting", flush=True)
                ckpt.save(state, "preempt")
                break
            metrics = step_fn(state, batch)
            n = start + i
            if n % args.log_every == 0:
                values = torch.stack(list(metrics.values())).cpu().tolist()  # one host read
                dt = time.time() - t0
                rate = (n - last_log) / dt if dt > 0 else 0.0
                print(json.dumps({"step": n, "steps_per_sec": round(rate, 3),
                                  **{k: round(v, 4) for k, v in zip(metrics, values)}}),
                      flush=True)
                t0, last_log = time.time(), n
            if n % args.save_every == 0:
                ckpt.save(state, "last")
                ckpt.save(state, f"step_{n}")
                ckpt.save_generator(state, "gen_last")
        ckpt.save(state, "last")
        ckpt.save_generator(state, "gen_last")
        print(f"done at step {state.step}")
    finally:
        guard.restore()  # keep Ctrl-C working for in-process callers
    return state


if __name__ == "__main__":
    main()
