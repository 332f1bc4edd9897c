"""Train CLI (port of main.py's train action; reference: DEX-TTS/main.py:21-67).

    python -m dex_tts_tpu_torch.main train --preset esd \\
        --train_path filelists/ESD/train.txt --val_path filelists/ESD/valid.txt \\
        --exp_dir checkpoints/esd [--seed 100] [--resume] [--device cuda]

Filelist lines are ``mel_path|text|speaker(|emotion)`` with mel .npy files
stored (T, n_mels) and lf0 files beside them under ``/lf0/`` (the layout of
the JAX package's preprocessing). Checkpoints go to ``<exp_dir>/ckpt/``,
the epoch log to ``<exp_dir>/log.txt``. The test action waits for the eval
slice of the port.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from dex_tts_tpu_torch.config import Preset, build_model, load_preset
from dex_tts_tpu_torch.data import BucketBatcher, TextMelDataset
from dex_tts_tpu_torch.train import Trainer, create_train_state


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("action", choices=["train"])
    p.add_argument("--preset", default="esd")
    p.add_argument("--train_path", default=None)
    p.add_argument("--val_path", default=None)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None, help="default: cuda")
    return p.parse_args(argv)


def make_loaders(preset: Preset, seed: int):
    """Train and validation batchers over the preset's filelists → (train
    loader factory, valid loader factory, train dataset)."""
    tc = preset.train
    common = dict(cmu_path=preset.cmu_path, add_blank=preset.add_blank,
                  load_style=preset.model.use_style, aug_types=tuple(tc.aug_type), seed=seed)
    train_ds = TextMelDataset(preset.train_path, **common)
    val_ds = TextMelDataset(preset.val_path, **common)
    bq = dict(batch_size=tc.batch_size, x_quantum=tc.x_quantum, y_quantum=tc.y_quantum,
              seed=seed)
    return (lambda: BucketBatcher(train_ds, shuffle=True, **bq),
            lambda: BucketBatcher(val_ds, shuffle=False, **bq), train_ds)


def train(preset: Preset, exp_dir: str, seed: int = 100, resume: bool = False,
          device=None) -> Trainer:
    """Build the model (initialised from ``seed``), the train state and the
    trainer, resume from ``last`` if asked and a checkpoint is there, and
    run the preset's epochs. → the trainer."""
    tc = preset.train
    torch.manual_seed(seed)  # parameter init only; steps draw from the state's generator
    model = build_model(preset.model, device=device)
    state = create_train_state(model, seed=seed, lr=tc.lr, max_grad=tc.max_grad)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.2f} M | out_size: {preset.out_size()}")
    trainer = Trainer(state, exp_dir, out_size=preset.out_size(), ema_decay=tc.ema_decay,
                      mask_ratio=tc.mask_ratio, accum_steps=tc.accum_steps,
                      save_epoch=tc.save_epoch, async_ckpt=tc.async_ckpt)
    if resume and trainer.ckpt.exists("last"):
        trainer.ckpt.restore(state, "last")
        print(f"resumed from step {state.step}")
    train_fn, valid_fn, _ = make_loaders(preset, seed)
    trainer.fit(train_fn, valid_fn, epochs=tc.epoch)
    return trainer


def main(argv=None):
    args = parse_args(argv)
    preset = load_preset(args.preset)
    overrides = {k: getattr(args, k) for k in ("train_path", "val_path") if getattr(args, k)}
    preset = dataclasses.replace(preset, **overrides)
    if preset.train is None:
        raise SystemExit(f"preset {args.preset!r} has no train block")
    train(preset, args.exp_dir, seed=args.seed, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
