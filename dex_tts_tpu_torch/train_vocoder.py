"""Vocoder GAN training CLI: HiFi-GAN or BigVGAN against MPD/MRD (port of
train_vocoder.py).

    python -m dex_tts_tpu_torch.train_vocoder --data ./preprocessed/LJSpeech/wav \\
        --vocoder bigvgan --steps 100000 --ckpt_dir ckpt_bigvgan \\
        [--config dex_tts_tpu/config/presets/esd.yaml | --preset esd] \\
        [--resume] [--init_gen generator.pth] [--n_devices N] [--device cuda]

Trains on raw WAVs (a directory, a list of paths or a TTS filelist), both
mels computed on the device inside the step. ``--config`` takes the mel
parameters of a TTS YAML config's ``preprocess`` section (and nothing
else of it), ``--preset`` those of a port preset: the ones the TTS
pipeline will feed the vocoder. Runs on the card unless ``--device cpu``;
without a card it raises. Checkpoints: ``<ckpt_dir>/last.pth``,
``step_{n}.pth`` and ``gen_last.pth`` (the generator alone, which
`eval.evaluation.load_vocoder` serves when the preset's ``vocoder_path``
is ``ckpt_dir``). SIGTERM/SIGINT save ``preempt.pth`` and ``last.pth``
and stop.

``--n_devices N`` (N > 1) trains data-parallel over N ranks, one process
per card started here (gloo ranks on the CPU with ``--device cpu``), or
over the ranks torchrun started: ``--batch`` is the global batch, every
rank draws the same seeded crops and keeps its rows, and the step equals
the one-process step on the global batch. Rank 0 alone logs and writes
checkpoints; the ranks agree on a preemption before each step.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from dex_tts_tpu_torch import parallel
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
from dex_tts_tpu_torch.utils.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="wav directory or TTS filelist")
    source = p.add_mutually_exclusive_group()
    source.add_argument("--config", default=None, metavar="YAML",
                        help="TTS YAML config whose preprocess section the vocoder trains on "
                             "(the mel parameters the TTS pipeline feeds it at serving time)")
    source.add_argument("--preset", default=None,
                        help="TTS preset whose mel parameters the vocoder trains on")
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
    p.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel ranks, one per card (0 = one process)")
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
    """MelSpectrogram keywords: the config's ``preprocess`` section with
    train_vocoder.py's defaults, or the preset's mel parameters, else the
    defaults at ``--sample_rate``."""
    if args.config:
        pre = Config(args.config).preprocess
        return dict(n_fft=int(pre.get("n_fft", 1024)), hop_length=int(pre.get("hop_length", 256)),
                    win_length=int(pre.get("win_length", 1024)),
                    n_mels=int(pre.get("n_mels", 80)),
                    sample_rate=int(pre.get("sample_rate", args.sample_rate)),
                    fmin=float(pre.get("f_min", 0.0)), fmax=float(pre.get("f_max", 8000.0)))
    if not args.preset:
        return dict(sample_rate=args.sample_rate)
    pre = load_preset(args.preset)
    return dict(n_fft=pre.n_fft, hop_length=pre.hop_length, win_length=pre.win_length,
                n_mels=pre.n_mels, sample_rate=pre.sample_rate, fmin=pre.f_min, fmax=pre.f_max)


def main(argv=None) -> VocoderTrainState | None:
    """Train as the flags say → the final state (None when this call
    started the data-parallel ranks itself)."""
    p = build_parser()
    args = p.parse_args(argv)
    if not parallel.initialize(device=args.device) and args.n_devices > 1:
        parallel.launch(_rank_main, args.n_devices, args=(argv,), timeout=None,
                        devices=parallel.runtime.rank_devices(args.n_devices, args.device))
        return None
    return _run(p, args)


def _rank_main(rank, argv):
    _run(build_parser(), build_parser().parse_args(argv))


def _run(p, args) -> VocoderTrainState:
    mesh = None
    if dist.is_initialized():
        args.device = args.device or parallel.runtime.rank_device()
        mesh = parallel.make_mesh()
        if args.batch % mesh.dp_size:
            p.error(f"--batch {args.batch} must divide over {mesh.dp_size} ranks")
    writer = mesh is None or mesh.rank == 0
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
    if writer:
        print(f"{len(data)} wav files from {args.data}")
    state = create_vocoder_train_state(gen_cfg, DiscriminatorConfig(), lr=args.lr,
                                       lr_decay=args.lr_decay,
                                       steps_per_epoch=args.steps_per_epoch, seed=args.seed,
                                       device=args.device)
    if args.init_gen:
        warm_start_generator(state, args.init_gen)
        if writer:
            print(f"generator warm start from {args.init_gen}")
    step_fn = make_vocoder_train_step(mel, mel_l1, lambda_mel=args.lambda_mel)

    ckpt = VocoderCheckpoints(args.ckpt_dir)
    if args.resume and ckpt.exists("last"):
        ckpt.restore(state, "last")
        if writer:
            print(f"resumed at step {state.step}")
    if mesh is not None:
        parallel.replicate_state(state, mesh)
        step_fn = parallel.make_parallel_train_step(step_fn, mesh)

    def save(*tags):
        if writer:
            for tag in tags:
                (ckpt.save_generator if tag == "gen_last" else ckpt.save)(state, tag)
        if mesh is not None:
            dist.barrier(group=mesh.cpu_group)

    guard = PreemptionGuard()  # SIGTERM/SIGINT → save and stop
    start = state.step
    t0, last_log = time.time(), start
    try:
        for i, batch in enumerate(data.batches(args.batch, args.steps - start), 1):
            if parallel.collectives.agree_any(guard.triggered, mesh):
                if writer:
                    print("preempted: saving checkpoint and exiting", flush=True)
                save("preempt")
                break
            if mesh is not None:  # this rank's rows of the seeded global batch
                batch = parallel.shard_rows(batch, mesh)
            metrics = step_fn(state, batch)
            n = start + i
            if writer and n % args.log_every == 0:
                values = torch.stack(list(metrics.values())).cpu().tolist()  # one host read
                dt = time.time() - t0
                rate = (n - last_log) / dt if dt > 0 else 0.0
                print(json.dumps({"step": n, "steps_per_sec": round(rate, 3),
                                  **{k: round(v, 4) for k, v in zip(metrics, values)}}),
                      flush=True)
                t0, last_log = time.time(), n
            if n % args.save_every == 0:
                save("last", f"step_{n}", "gen_last")
        save("last", "gen_last")
        if writer:
            print(f"done at step {state.step}")
    finally:
        guard.restore()  # keep Ctrl-C working for in-process callers
    return state


if __name__ == "__main__":
    main()
