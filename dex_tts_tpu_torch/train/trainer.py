"""Training engine: train/valid steps, EMA, checkpoints, epoch loop (port of
dex_tts_tpu/train/trainer.py).

Capability equivalent of reference: DEX-TTS/src/train.py:28-214: Adam +
global-norm clipping, EMA weights, best-train/best-val/every-N/last
checkpoints, a plaintext epoch log. A step issues its work on the model's
device and returns its metrics as device tensors: nothing comes to the
host until `metrics_to_host`, which also reads the MAS path guard's
count of broken paths. The epoch loop keeps its metric sums on the device and
reads them once per epoch. A `PreemptionGuard` (``preemption``) is polled
before each batch: when it has fired, `fit` saves ``last`` and ``preempt``,
waits for the write and returns. ``syn_fn(state, epoch)`` runs every
``syn_every`` epochs after the epoch's checkpoints (periodic synthesis,
`main.make_synthesis_callback`).

With a ``mesh`` (`parallel.make_mesh`) each rank runs the step on its rows
of the global batch as its share of the one-process step
(`parallel.make_parallel_train_step`): the state is broadcast from rank 0
once, gradients and metrics are summed over the dp group, the ranks agree
before each batch whether a preemption stops them, and rank 0 alone
writes checkpoints and the log and runs the periodic synthesis while the
others wait at a barrier.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from dex_tts_tpu_torch.ops.mas import MAS_ERRORS, raise_on_path_errors
from dex_tts_tpu_torch.parallel import collectives
from dex_tts_tpu_torch.parallel.mesh import make_parallel_train_step, replicate_state
from dex_tts_tpu_torch.train.checkpoint import CheckpointManager
from dex_tts_tpu_torch.train.preemption import PreemptionGuard
from dex_tts_tpu_torch.train.state import TrainState, clip_by_global_norm_, ema_update_

BATCH_KEYS = ("x", "x_lengths", "y", "y_lengths", "spk", "ref", "ref_lengths",
              "sty", "sty_lengths", "lf0", "lf0_lengths")
STYLE_KEYS = ("ref", "ref_lengths", "sty", "sty_lengths", "lf0", "lf0_lengths")


def model_inputs(model, batch: dict) -> dict:
    """The batch entries ``model.compute_loss`` takes, as tensors on the
    model's device (integer arrays as int64)."""
    cfg = model.cfg
    keys = set(BATCH_KEYS)
    if not cfg.use_style:
        keys -= set(STYLE_KEYS)
    if cfg.n_spks <= 1:
        keys.discard("spk")
    device = next(model.parameters()).device
    out = {}
    for k, v in batch.items():
        if k not in keys:
            continue
        v = torch.as_tensor(v)
        v = v.long() if not v.is_floating_point() else v.float()
        out[k] = v.to(device, non_blocking=True)
    return out


def metrics_to_host(metrics: dict) -> dict:
    """Device metrics → floats, in one transfer. The MAS guard's count
    (``MAS_ERRORS``) comes with them and is not returned: MASPathError if
    any path was broken."""
    keys = list(metrics)
    values = torch.stack([metrics[k].detach().float() for k in keys]).cpu().tolist()
    values = dict(zip(keys, values))
    raise_on_path_errors(values.pop(MAS_ERRORS, 0.0))
    return values


def make_train_step(out_size: int | None = None, ema_decay: float = 0.9999,
                    mask_ratio: float = 0.0, accum_steps: int = 1):
    """Build the train step: (state, batch) → metrics (device tensors),
    updating ``state`` in place.

    The loss optimized is the raw sum of the per-term losses (reference:
    DEX-TTS/src/train.py:131-137,198 — the reference *displays* the mean
    but steps on the sum). ``accum_steps`` > 1 splits the batch into that
    many micro-batches run one after the other (gradients averaged;
    BatchNorm and VQ-EMA state updated by each in turn): one optimizer
    update either way. Inside `collectives.data_parallel` the gradients are
    summed over the dp group before the clip, and micro-batch i is the
    union of every rank's i-th slice."""

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        inputs = model_inputs(model, batch)
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        b = inputs["x"].shape[0]
        assert b % accum_steps == 0, (b, accum_steps)
        sums, mas_errors = {}, 0.0
        for i in range(accum_steps):
            micro = {k: v[i * b // accum_steps:(i + 1) * b // accum_steps]
                     for k, v in inputs.items()}
            losses = model.compute_loss(out_size=out_size, mask_ratio=mask_ratio, train=True,
                                        generator=state.generator, **micro)
            mas_errors = mas_errors + losses.pop(MAS_ERRORS)
            (sum(losses.values()) / accum_steps).backward()
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        losses = {k: v / accum_steps for k, v in sums.items()}
        grads = []
        for p in params:
            if p.grad is None:  # optax updates every leaf, zero grads included
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        collectives.reduce_gradients_(grads)
        mesh = collectives.current()
        norm = (torch.sqrt(collectives.grad_sq_norm(params))
                if mesh is not None and mesh.tp_size > 1 else None)
        grad_norm = clip_by_global_norm_(grads, state.max_grad, norm)
        state.optimizer.step()
        ema_update_(state.ema, model, ema_decay)
        state.step += 1
        metrics = dict(losses)
        metrics["total_loss"] = sum(losses.values())
        metrics["grad_norm"] = grad_norm
        metrics[MAS_ERRORS] = mas_errors
        return metrics

    return train_step


def make_valid_step(out_size: int | None = None):
    """Validation losses: no dropout, no state update, segment and noise
    draws from ``generator``."""

    @torch.no_grad()
    def valid_step(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        model = state.model
        losses = model.compute_loss(out_size=out_size, train=False, generator=generator,
                                    **model_inputs(model, batch))
        mas_errors = losses.pop(MAS_ERRORS)
        losses["total_loss"] = sum(losses.values())
        losses[MAS_ERRORS] = mas_errors
        return losses

    return valid_step


class Trainer:
    """Epoch loop with logging and checkpoint policies.

    Checkpoints (reference: DEX-TTS/src/train.py:139-150): best-train,
    best-val, every ``save_epoch``, and last (with the optimizer and the
    generator, for resume); ``last`` and ``preempt`` when ``preemption``
    fires. ``syn_fn(state, epoch)`` every ``syn_every`` epochs (0: never;
    reference: DEX-TTS/src/train.py:176-178). ``mesh``: data-parallel (and
    tensor-parallel, for a state already through `shard_train_state`)
    training; every rank builds its Trainer and calls `fit` with its own
    rows (`BucketBatcher(process_count, process_index)`)."""

    def __init__(self, state: TrainState, exp_dir: str, out_size: int | None = None,
                 ema_decay: float = 0.9999, mask_ratio: float = 0.0, accum_steps: int = 1,
                 save_epoch: int = 200, async_ckpt: bool = False,
                 preemption: PreemptionGuard | None = None, syn_every: int = 0,
                 syn_fn: Callable[[TrainState, int], None] | None = None, mesh=None):
        if mesh is not None and mesh.tp_size > 1 and syn_every:
            # rank 0 synthesizes alone, and a split layer needs its tp group
            raise ValueError("periodic synthesis needs tp_size 1")
        self.mesh = mesh
        self.state = state if mesh is None else replicate_state(state, mesh)
        self.is_writer = mesh is None or mesh.rank == 0
        self.exp_dir = exp_dir
        self.save_epoch = save_epoch
        self.preemption = preemption
        self.syn_every = syn_every
        self.syn_fn = syn_fn
        self.preempted = False
        os.makedirs(exp_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(exp_dir, "ckpt"), async_save=async_ckpt,
                                      write=self.is_writer)
        self.train_step = make_train_step(out_size, ema_decay, mask_ratio, accum_steps)
        self.valid_step = make_valid_step(out_size)
        if mesh is not None:
            self.train_step = make_parallel_train_step(self.train_step, mesh)
            self.valid_step = make_parallel_train_step(self.valid_step, mesh)
        self.best_train = float("inf")
        self.best_val = float("inf")
        self.log_path = os.path.join(exp_dir, "log.txt")

    def log(self, msg: str):
        if not self.is_writer:
            return
        print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def _barrier(self):
        """Rank 0's writes are done before any rank goes on."""
        if self.mesh is not None and self.mesh.world_size > 1:
            dist.barrier(group=self.mesh.cpu_group)

    def _stop_requested(self) -> bool:
        flag = self.preemption is not None and self.preemption.triggered
        if self.mesh is not None:  # a signal to one rank stops all at the same batch
            flag = collectives.agree_any(flag, self.mesh)
        self.preempted = self.preempted or flag
        return flag

    def run_epoch(self, loader: Iterable[dict], train: bool = True) -> dict:
        sums, count = None, 0
        device = next(self.state.model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(int(self.state.step))
        for batch in loader:
            if self._stop_requested():
                break
            batch = {k: v for k, v in batch.items() if not isinstance(v, str)}
            if train:
                metrics = self.train_step(self.state, batch)
            else:
                metrics = self.valid_step(self.state, batch, generator)
            sums = metrics if sums is None else {k: sums[k] + metrics[k] for k in metrics}
            count += 1
        if sums is None:
            return {}
        # one host read for the whole epoch
        return {k: v / max(count, 1) for k, v in metrics_to_host(sums).items()}

    def fit(self, train_loader_fn: Callable[[], Iterable[dict]],
            valid_loader_fn: Callable[[], Iterable[dict]] | None = None,
            epochs: int = 1, start_epoch: int = 0) -> TrainState:
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            train_metrics = self.run_epoch(train_loader_fn(), train=True)
            # a signal during the epoch's last batch is caught here; every
            # rank reaches this point, so the vote is safe
            if self.preempted or self._stop_requested():
                # grace-window checkpoint: a resume continues from here
                self.ckpt.save_many(self.state, ["last", "preempt"])
                self.ckpt.wait()  # durable before the grace window ends
                self.log(f"preempted during epoch {epoch + 1}: saved last/preempt "
                         "checkpoints, exiting")
                self._barrier()
                return self.state
            line = f"epoch {epoch + 1} | " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(train_metrics.items()))
            tags = []
            scores = {"train": train_metrics}
            if valid_loader_fn is not None:
                val_metrics = self.run_epoch(valid_loader_fn(), train=False)
                scores["val"] = val_metrics
                line += " | val " + " ".join(
                    f"{k}={v:.4f}" for k, v in sorted(val_metrics.items()))
                if val_metrics.get("total_loss", np.inf) < self.best_val:
                    self.best_val = val_metrics["total_loss"]
                    tags.append("best-val")
            line += f" | {time.time() - t0:.1f}s"
            self.log(line)
            if train_metrics.get("total_loss", np.inf) < self.best_train:
                self.best_train = train_metrics["total_loss"]
                tags.append("best-train")
            if self.save_epoch and (epoch + 1) % self.save_epoch == 0:
                tags.append(f"epoch-{epoch + 1}")
            tags.append("last")
            self.ckpt.save_many(self.state, tags, scores={"epoch": epoch + 1, **scores})
            if (self.is_writer and self.syn_every and self.syn_fn
                    and (epoch + 1) % self.syn_every == 0):
                self.syn_fn(self.state, epoch + 1)
            self._barrier()
        self.ckpt.wait()  # background writes must land before we return
        self._barrier()
        return self.state
