"""The ranks of the port's parallel tests (tests/test_torch_parallel*.py),
started by `dex_tts_tpu_torch.parallel.launch` as gloo ranks on the CPU.
This module imports no JAX, so a rank starts in a few seconds; each
function takes its rank first and returns host objects (numpy, floats)."""

from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from dex_tts_tpu_torch import parallel
from dex_tts_tpu_torch.models import layers, retention
from dex_tts_tpu_torch.models.tts import build_tts
from dex_tts_tpu_torch.ops.mas import MAS_ERRORS
from dex_tts_tpu_torch.parallel import collectives
from dex_tts_tpu_torch.parallel.collectives import gather_dim
from dex_tts_tpu_torch.parallel.tp import TensorParallelLinear, full_ema
from dex_tts_tpu_torch.train import CheckpointManager, Trainer, create_train_state
from dex_tts_tpu_torch.train.trainer import make_train_step

OUT = 16
LR = 1e-3


def sequence(rank, calls):
    """Several rank functions in one launch (a launch costs ~3.5 s):
    ``calls`` = [(fn, args), ...] → their results in order. Each call
    leaves the process as it found it."""
    return [fn(rank, *args) for fn, args in calls]


@contextlib.contextmanager
def no_dropout():
    """Dropout and DropPath are the identity inside (the rates set to 0:
    JAX's dropout keys and torch's generators are different streams), and
    themselves again after it, for the calls that follow in the launch."""
    ident = lambda x, p, train: x  # noqa: E731
    saved = [(mod, mod.dropout, mod.drop_path) for mod in (layers, retention)]
    for mod, _, _ in saved:
        mod.dropout = ident
        mod.drop_path = ident
    try:
        yield
    finally:
        for mod, dropout, drop_path in saved:
            mod.dropout = dropout
            mod.drop_path = drop_path


def tensors(batch: dict) -> dict:
    """numpy batch → CPU tensors (integer arrays as int64)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long() if v.dtype.kind == "i"
            else torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def numpy_dict(d: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def full_grads(model) -> dict:
    """Every parameter's gradient in the one-process layout."""
    out = {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
           for n, p in model.named_parameters()}
    for mname, mod in model.named_modules():
        if isinstance(mod, TensorParallelLinear):
            for pname, p in mod.named_parameters(recurse=False):
                if hasattr(p, "tp_dim"):
                    out[f"{mname}.{pname}"] = gather_dim(p.grad, p.tp_dim, mod.group, mod.rank,
                                                         mod.size)
    return out


def loss_and_grads(rank, cfg, state_dict, inputs, draws):
    """dp compute_loss (train=True, dropout off, the draws handed over)
    and its gradients summed over the ranks, the buffers after the
    codebook's and BatchNorm's updates."""
    model = build_tts(cfg)
    model.load_state_dict(state_dict)
    model.train()
    mesh = parallel.make_mesh()
    rows = parallel.shard_rows(tensors(inputs), mesh)
    rdraws = parallel.shard_rows({k: torch.from_numpy(v) for k, v in draws.items()}, mesh)
    with no_dropout(), collectives.data_parallel(mesh):
        losses = model.compute_loss(**rows, out_size=OUT, train=True,
                                    generator=torch.Generator().manual_seed(0), draws=rdraws)
        losses["mas"] = losses.pop(MAS_ERRORS)
        sum(v for k, v in losses.items() if k != "mas").backward()
        grads = full_grads(model)
        collectives.reduce_gradients_(list(grads.values()))
        losses = collectives.sum_metrics(losses)
    return {"losses": {k: float(v) for k, v in losses.items()}, "grads": numpy_dict(grads),
            "buffers": numpy_dict(dict(model.named_buffers()))}


def _state(cfg, seed):
    torch.manual_seed(seed)
    return create_train_state(build_tts(cfg), seed=seed, lr=LR, max_grad=1.0)


def train_step(rank, cfg, batch, tp_size=1, seed=0, rank_seeds=False, save_dir=None,
               draws=None, state_dict=None):
    """One dp×tp step from the state of ``seed`` (``rank_seeds``: each rank
    starts from ``seed + rank``, and `replicate_state` must make them
    equal) or of ``state_dict``; ``draws`` replays given draws (JAX's) in
    compute_loss, with dropout off; ``save_dir``: save the state as
    ``last`` there afterwards. → metrics, gradients (after the clip),
    state and EMA in the one-process layout."""
    state = _state(cfg, seed + (rank if rank_seeds else 0))
    if state_dict is not None:
        state.model.load_state_dict(state_dict)
        state.ema = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    mesh = parallel.make_mesh(tp_size=tp_size)
    parallel.replicate_state(state, mesh)
    parallel.shard_train_state(state, mesh)
    replay = contextlib.nullcontext()
    if draws is not None:
        replay = no_dropout()
        state.model.compute_loss = functools.partial(
            state.model.compute_loss,
            draws=parallel.shard_rows({k: torch.from_numpy(v) for k, v in draws.items()}, mesh))
    step = parallel.make_parallel_train_step(make_train_step(out_size=OUT, ema_decay=0.9), mesh)
    with replay:
        metrics = step(state, parallel.shard_rows(batch, mesh))
    grads = full_grads(state.model)
    if save_dir is not None:
        CheckpointManager(save_dir, write=mesh.rank == 0).save(state, "last")
        dist.barrier()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": numpy_dict(grads),
            "state": numpy_dict(parallel.full_state_dict(state.model)),
            "ema": numpy_dict(full_ema(state.model, state.ema)),
            "shard_count": parallel.shard_count(state.model)}


def restore_and_step(rank, cfg, ckpt_dir, batch, tp_size):
    """A fresh state restored from ``ckpt_dir``'s ``last`` (one-process
    layout), sharded over dp×tp, then one step → metrics."""
    state = _state(cfg, seed=99)
    CheckpointManager(ckpt_dir, write=False).restore(state, "last")
    mesh = parallel.make_mesh(tp_size=tp_size)
    parallel.replicate_state(state, mesh)
    parallel.shard_train_state(state, mesh)
    step = parallel.make_parallel_train_step(make_train_step(out_size=OUT, ema_decay=0.9), mesh)
    return {k: float(v) for k, v in step(state, parallel.shard_rows(batch, mesh)).items()}


class FlagGuard:
    """A `PreemptionGuard` stand-in: ``triggered`` set by the test."""

    triggered = False


def preempted_fit(rank, cfg, exp_dir, batches, stop_rank, stop_at):
    """`Trainer.fit` over dp ranks; rank ``stop_rank`` alone sees the
    preemption flag rise before its batch ``stop_at``."""
    guard = FlagGuard()
    trainer = Trainer(_state(cfg, 0), exp_dir, out_size=OUT, preemption=guard,
                      mesh=parallel.make_mesh())
    mesh = trainer.mesh

    def loader():
        for i, batch in enumerate(batches):
            if rank == stop_rank and i == stop_at:
                guard.triggered = True
            yield parallel.shard_rows(batch, mesh)

    trainer.fit(loader, None, epochs=2)
    return {"step": trainer.state.step, "preempted": trainer.preempted,
            "files": sorted(os.listdir(os.path.join(exp_dir, "ckpt")))}


def synthesize(rank, cfg, state_dict, texts, feats, tp_size, pad_batches=True):
    """`Synthesizer.tts` over dp×tp (2 euler steps) → the mels (every rank
    returns the whole batch)."""
    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.pipeline import Synthesizer

    model = build_tts(cfg)
    model.load_state_dict(state_dict)
    mesh = parallel.make_mesh(tp_size=tp_size)
    synth = Synthesizer(model, None, sampler=SamplerConfig(num_steps=2), device="cpu",
                        x_quantum=8, y_quantum=16, pad_batches=pad_batches, mesh=mesh)
    out = synth.tts(texts, generator=torch.Generator().manual_seed(5), ref_feats=feats)
    return {"mels": [r["mel"] for r in out], "n_frames": [r["n_frames"] for r in out],
            "shard_count": parallel.shard_count(synth.model)}


def vocoder_step(rank, make_state, mel_kw, wav):
    """One data-parallel GAN step of the vocoder state ``make_state()`` on
    this rank's rows of ``wav`` → metrics and both optimizers' gradients
    (summed over the ranks, clipped)."""
    from dex_tts_tpu_torch.audio.stft import MelSpectrogram
    from dex_tts_tpu_torch.train.vocoder import make_vocoder_train_step

    state = make_state()
    mesh = parallel.make_mesh()
    parallel.replicate_state(state, mesh)
    mel = MelSpectrogram(**mel_kw)
    step = parallel.make_parallel_train_step(make_vocoder_train_step(mel), mesh)
    metrics = step(state, parallel.shard_rows({"wav": wav}, mesh))
    grads = {f"gen.{n}": p.grad for n, p in state.generator.named_parameters()}
    grads.update({f"critics.{n}": p.grad for n, p in state.critics.named_parameters()})
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": numpy_dict(grads)}


def dit_tp_round_trip(rank, dit_cfg, state_dict, inputs):
    """A DiT (the decoder variant) sharded over tp 2: its output on the
    same inputs and its `full_state_dict` gathered back, as numpy."""
    from dex_tts_tpu_torch.models.dit import DiT

    model = DiT(dit_cfg)
    model.load_state_dict(state_dict)
    parallel.shard_tensor_parallel(model, parallel.make_mesh(tp_size=2))
    with torch.no_grad():
        out = model(*tensors(inputs).values())
    return {"out": out.numpy(), "state": numpy_dict(parallel.full_state_dict(model)),
            "shard_count": parallel.shard_count(model)}
