"""Train / evaluate CLI (port of main.py; reference: DEX-TTS/main.py:21-67).

    python -m dex_tts_tpu_torch.main train --config dex_tts_tpu/config/presets/esd.yaml \\
        [--tag run1] [--exp_dir checkpoints/esd] [--seed 100] [--resume] \\
        [--init_from PATH] [--n_timesteps 50] [--solver euler] [--n_devices N] \\
        [--device cuda]
    python -m dex_tts_tpu_torch.main train --preset esd \\
        --train_path filelists/ESD/train.txt --val_path filelists/ESD/valid.txt \\
        --exp_dir checkpoints/esd ...
    torchrun --nproc_per_node N -m dex_tts_tpu_torch.main train ...
    python -m dex_tts_tpu_torch.main test (--config Y | --preset esd) \\
        --test_checkpoint <exp_dir or .pth> [--val_path filelists/ESD/test.txt] \\
        [--tag best-train] [--sample_size 10] [--test_file sentences.txt] \\
        [--n_timesteps 50] [--solver euler] [--dit_cache_interval 1] \\
        [--spk_encoder pretrained.pt] [--seed 100] [--random_init] [--device cuda]

``--config`` reads a YAML config in the JAX package's layout
(`config.preset_from_config`); ``--preset`` names one of the port's
presets instead (default: esd). ``train --config`` without ``--exp_dir``
creates the experiment directory from the config, as main.py does
(`utils.config.set_experiment`: ``{checkpoint}/{dataset}-{N}[-{tag}]``
with the config written to its ``base.yaml``). ``--tag`` is that
experiment tag for ``train`` and the checkpoint tag (default best-train)
for ``test``.

Filelist lines are ``mel_path|text|speaker(|emotion)`` with mel .npy files
stored (T, n_mels) and lf0 files beside them under ``/lf0/`` (the layout of
the JAX package's preprocessing). Checkpoints go to ``<exp_dir>/ckpt/``,
the epoch log to ``<exp_dir>/log.txt``. ``--init_from`` warm-starts from a
reference-format torch checkpoint; every ``train.syn_every`` epochs the
trainer synthesizes a few validation sentences into ``<exp_dir>/sample/``
(``--n_timesteps`` and ``--solver``) with the preset's vocoder; SIGTERM
or SIGINT saves ``last`` and ``preempt`` and returns.

Training is data-parallel over ``--n_devices`` ranks (default: every
card; 1 with ``--device cpu``), lowered until it divides the batch size,
one process per card started here (gloo ranks on the CPU with ``--device
cpu``), or over the ranks torchrun started. Each rank loads its rows of
every global batch; the step equals the one-process step on the global
batch (`parallel`). Asking for more cards than there are raises.

The test action (`eval.evaluation.run_objective_eval`) synthesizes the
first ``--sample_size`` items of ``--val_path`` (or the preset's) with the
checkpoint of ``--tag`` (a missing one raises unless ``--random_init``),
writes ``<exp_dir>/eval/`` and prints mel MAE and MCD, plus WER/CER and
speaker cosine where their backends are available (``--spk_encoder``:
resemblyzer's pretrained.pt for the built-in GE2E encoder). ``--seed``
seeds the evaluation's noise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch
import torch.distributed as dist

from dex_tts_tpu_torch import parallel
from dex_tts_tpu_torch.config import Preset, build_model, load_preset, preset_from_config
from dex_tts_tpu_torch.convert import load_numpy_state, load_torch_trainer_checkpoint
from dex_tts_tpu_torch.data import BucketBatcher, TextMelDataset
from dex_tts_tpu_torch.train import PreemptionGuard, Trainer, TrainState, create_train_state
from dex_tts_tpu_torch.utils.config import Config, set_experiment


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("action", choices=["train", "test"])
    source = p.add_mutually_exclusive_group()
    source.add_argument("--config", default=None, metavar="YAML",
                        help="a YAML config in the JAX package's layout")
    source.add_argument("--preset", default="esd", help="one of config.PRESETS")
    p.add_argument("--train_path", default=None)
    p.add_argument("--val_path", default=None)
    p.add_argument("--exp_dir", default=None,
                   help="train: the experiment directory (required with --preset; with "
                        "--config the default creates one from the config)")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_from", default=None, metavar="PATH",
                   help="warm-start weights and EMA from a reference-format torch "
                        "checkpoint (.pth file or reference experiment dir); the optimizer "
                        "starts fresh")
    p.add_argument("--n_timesteps", type=int, default=50,
                   help="sampler steps of the periodic synthesis and of the test action")
    p.add_argument("--solver", default="euler", choices=["euler", "heun", "dpmpp2m"],
                   help="ODE solver of the periodic synthesis and of the test action")
    p.add_argument("--n_devices", type=int, default=None,
                   help="train: data-parallel ranks, one per card (default: every card; "
                        "1 with --device cpu)")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--test_checkpoint", default=None, metavar="PATH",
                   help="test: the experiment directory or .pth file to evaluate (required)")
    p.add_argument("--tag", default=None,
                   help="train --config: the experiment tag, appended to the name of the "
                        "directory it creates; test: the checkpoint tag (default "
                        "best-train)")
    p.add_argument("--sample_size", type=int, default=10, help="test: items to evaluate")
    p.add_argument("--test_file", default=None,
                   help="test: synthesize these lines (text only) instead of the val items")
    p.add_argument("--dit_cache_interval", type=int, default=1,
                   help="test: evaluate the approximate DiT-cache sampler (1 = exact)")
    p.add_argument("--spk_encoder", default=None, metavar="PT",
                   help="test: resemblyzer's pretrained.pt for the built-in GE2E speaker "
                        "encoder (the speaker-cosine metric)")
    p.add_argument("--random_init", action="store_true",
                   help="test: random weights where a checkpoint is missing (smoke runs only)")
    args = p.parse_args(argv)
    if args.action == "test" and args.test_checkpoint is None:
        p.error("test needs --test_checkpoint")
    if args.action == "train" and args.exp_dir is None:
        if args.config is None:
            p.error("train --preset needs --exp_dir")
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            # every rank would create a directory of its own
            p.error("train --config under torchrun needs --exp_dir")
    if args.action == "test":
        args.tag = args.tag or "best-train"
    return args


def warm_start_state(state: TrainState, path: str) -> TrainState:
    """Load a reference-format torch checkpoint into a fresh train state, in
    place: the weights and buffers (BatchNorm statistics, VQ codebook)
    strictly, the EMA from the file's ``ema`` or else from its weights.
    The optimizer starts fresh. reference checkpoint format:
    DEX-TTS/src/train.py:112-122."""
    from dex_tts_tpu_torch.eval.evaluation import _find_torch_tts_checkpoint

    # "best-train" already falls back through val-best and last
    resolved = _find_torch_tts_checkpoint(path, "best-train")
    if not resolved:
        raise FileNotFoundError(f"no reference checkpoint found at {path}")
    state_dict, ema = load_torch_trainer_checkpoint(resolved)  # one disk read
    load_numpy_state(state.model, state_dict)
    ema = state_dict if ema is None else ema
    with torch.no_grad():
        for name, value in state.ema.items():
            value.copy_(torch.from_numpy(ema[name]))
    print(f"warm start from {resolved}")
    return state


def make_synthesis_callback(preset: Preset, model, exp_dir: str, n_timesteps: int = 50,
                            solver: str = "euler", n_samples: int = 2, device=None):
    """Periodic train-time synthesis (reference: DEX-TTS/src/train.py:176-178
    runs a Tester every syn_every epochs) → ``syn_fn(state, epoch)``, which
    writes ``<exp_dir>/sample/epoch{epoch}_{i}.wav`` for the first
    ``n_samples`` validation sentences and prints each one's mel MAE
    against its ground truth.

    The dataset, the vocoder (`load_vocoder(preset)`) and the Synthesizer
    are built at the first call and kept. The model synthesizes under
    ``torch.no_grad()`` in eval mode and goes back to the mode it was in;
    the noise comes from generators of its own, never from the train
    state's, so training draws the same numbers with or without it. A
    missing vocoder checkpoint or validation filelist (`FileNotFoundError`)
    is logged and the call skipped; every other error raises."""
    from dex_tts_tpu_torch.audio.wav import write_wav
    from dex_tts_tpu_torch.eval.evaluation import load_vocoder
    from dex_tts_tpu_torch.eval.metric import mel_mae
    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.pipeline import Synthesizer

    cache: dict = {}
    out_dir = os.path.join(exp_dir, "sample")

    def syn_fn(state: TrainState, epoch: int) -> None:
        was_training = model.training
        try:
            if "synth" not in cache:
                try:
                    ds = TextMelDataset(preset.val_path, cmu_path=preset.cmu_path,
                                        add_blank=preset.add_blank,
                                        load_style=preset.model.use_style)
                    vocoder = load_vocoder(preset, device=device)
                except FileNotFoundError as exc:
                    print(f"  periodic synthesis skipped: {exc}", flush=True)
                    return
                cache["ds"] = ds
                cache["synth"] = Synthesizer(
                    model, vocoder, cmu_path=preset.cmu_path, add_blank=preset.add_blank,
                    sampler=SamplerConfig(num_steps=n_timesteps, solver=solver), device=device)
            ds, synth = cache["ds"], cache["synth"]
            model.eval()
            os.makedirs(out_dir, exist_ok=True)
            for i in range(min(n_samples, len(ds))):
                item = ds.eval_item(i)
                kwargs = {"ref_feats": [(item["ref"], item["lf0"])]} if "ref" in item else {}
                out = synth.tts([item["raw_text"]],
                                generator=torch.Generator(synth.device).manual_seed(i),
                                **kwargs)[0]
                write_wav(os.path.join(out_dir, f"epoch{epoch}_{i}.wav"), out["wav"])
                print(f"  syn sample {i}: mel_mae={mel_mae(item['y'], out['mel']):.4f}",
                      flush=True)
        finally:
            model.train(was_training)

    return syn_fn


def make_loaders(preset: Preset, seed: int, process_count: int = 1, process_index: int = 0):
    """Train and validation batchers over the preset's filelists → (train
    loader factory, valid loader factory, train dataset). With
    ``process_count`` > 1 each batcher yields rank ``process_index``'s rows
    of every global batch, at the global batch's bucket shapes."""
    tc = preset.train
    common = dict(cmu_path=preset.cmu_path, add_blank=preset.add_blank,
                  load_style=preset.model.use_style, aug_types=tuple(tc.aug_type), seed=seed)
    train_ds = TextMelDataset(preset.train_path, **common)
    val_ds = TextMelDataset(preset.val_path, **common)
    bq = dict(batch_size=tc.batch_size, x_quantum=tc.x_quantum, y_quantum=tc.y_quantum,
              seed=seed, process_count=process_count, process_index=process_index)
    return (lambda: BucketBatcher(train_ds, shuffle=True, **bq),
            lambda: BucketBatcher(val_ds, shuffle=False, **bq), train_ds)


def data_parallel_size(batch_size: int, n_devices: int | None, device=None) -> int:
    """The number of data-parallel ranks ``main train`` starts: ``n_devices``
    (default: every card; 1 on the CPU), lowered until it divides
    ``batch_size`` (JAX: main.py:214-228). More ranks than cards raises and
    names both counts; CUDA without a card raises unless the CPU is asked
    for (`parallel.runtime.rank_devices`)."""
    n = len(parallel.runtime.rank_devices(n_devices, device))
    while n > 1 and batch_size % n:
        n -= 1
    return n


def train(preset: Preset, exp_dir: str, seed: int = 100, resume: bool = False,
          device=None, init_from: str | None = None, n_timesteps: int = 50,
          solver: str = "euler", n_devices: int | None = None) -> Trainer | None:
    """Build the model (initialised from ``seed``, or warm-started from
    ``init_from``), the train state and the trainer, resume from ``last``
    if asked and a checkpoint is there, and run the preset's epochs with
    periodic synthesis every ``train.syn_every`` epochs and a
    `PreemptionGuard` installed (the previous signal handlers come back
    when this returns). → the trainer; None when it started the ranks
    itself (`data_parallel_size` > 1). Inside a process group (torchrun, or
    `parallel.launch`) this is one rank of a data-parallel run."""
    if not parallel.initialize(device=device):
        n = data_parallel_size(preset.train.batch_size, n_devices, device)
        if n > 1:
            parallel.launch(_train_rank, n, devices=parallel.runtime.rank_devices(n, device),
                            timeout=None, args=(preset, exp_dir, seed, resume, init_from,
                                                n_timesteps, solver))
            return None
    elif device is None:
        device = parallel.runtime.rank_device()
    return _train(preset, exp_dir, seed, resume, device, init_from, n_timesteps, solver)


def _train_rank(rank, preset, exp_dir, seed, resume, init_from, n_timesteps, solver):
    _train(preset, exp_dir, seed, resume, parallel.runtime.rank_device(), init_from,
           n_timesteps, solver)


def _train(preset: Preset, exp_dir: str, seed: int, resume: bool, device, init_from,
           n_timesteps: int, solver: str) -> Trainer:
    tc = preset.train
    mesh = None
    if dist.is_initialized():
        world = dist.get_world_size()
        if tc.batch_size % world:
            raise ValueError(f"batch_size {tc.batch_size} must divide evenly over {world} ranks")
        mesh = parallel.make_mesh()
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    torch.manual_seed(seed)  # parameter init only; steps draw from the state's generator
    model = build_model(preset.model, device=device)
    state = create_train_state(model, seed=seed, lr=tc.lr, max_grad=tc.max_grad)
    if init_from:
        warm_start_state(state, init_from)
    if rank == 0:
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model params: {n_params / 1e6:.2f} M | out_size: {preset.out_size()}"
              + (f" | {world} data-parallel ranks" if world > 1 else ""))
    syn_fn = make_synthesis_callback(preset, model, exp_dir, n_timesteps=n_timesteps,
                                     solver=solver, device=device)
    # SIGTERM (maintenance, reclaim) → checkpoint and a clean return
    guard = PreemptionGuard()
    try:
        trainer = Trainer(state, exp_dir, out_size=preset.out_size(), ema_decay=tc.ema_decay,
                          mask_ratio=tc.mask_ratio, accum_steps=tc.accum_steps,
                          save_epoch=tc.save_epoch, async_ckpt=tc.async_ckpt,
                          preemption=guard, syn_every=tc.syn_every, syn_fn=syn_fn, mesh=mesh)
        if resume and trainer.ckpt.exists("last"):
            trainer.ckpt.restore(state, "last")  # on every rank, then replicated
            if mesh is not None:
                parallel.replicate_state(state, mesh)
            if rank == 0:
                print(f"resumed from step {state.step}")
        train_fn, valid_fn, _ = (make_loaders(preset, seed) if mesh is None
                                 else make_loaders(preset, seed, world, rank))
        trainer.fit(train_fn, valid_fn, epochs=tc.epoch)
    finally:
        # only fit polls the guard: in-process callers keep a working Ctrl-C
        guard.restore()
    return trainer


def test(args, preset: Preset) -> dict:
    """The test action → `run_objective_eval`'s report."""
    from dex_tts_tpu_torch.eval.evaluation import run_objective_eval

    return run_objective_eval(
        preset, args.test_checkpoint, sample_size=args.sample_size,
        n_timesteps=args.n_timesteps, test_file=args.test_file, seed=args.seed,
        dit_cache_interval=args.dit_cache_interval, solver=args.solver,
        spk_encoder=args.spk_encoder, tag=args.tag, device=args.device,
        random_init=args.random_init,
    )


def main(argv=None):
    args = parse_args(argv)
    cfg = Config(args.config) if args.config else None
    preset = preset_from_config(cfg) if cfg is not None else load_preset(args.preset)
    overrides = {k: getattr(args, k) for k in ("train_path", "val_path") if getattr(args, k)}
    preset = dataclasses.replace(preset, **overrides)
    if args.action == "test":
        return test(args, preset)
    if preset.train is None:
        raise SystemExit(f"{args.config or 'preset ' + repr(args.preset)} has no train block")
    if args.exp_dir is None:
        args.exp_dir = set_experiment(cfg, tag=args.tag).exp_dir
    return train(preset, args.exp_dir, seed=args.seed, resume=args.resume, device=args.device,
                 init_from=args.init_from, n_timesteps=args.n_timesteps, solver=args.solver,
                 n_devices=args.n_devices)


if __name__ == "__main__":
    main()
