"""The (dp, tp) process mesh and data-parallel training (port of
dex_tts_tpu/parallel/mesh.py).

The JAX package jits the train step over a dp-sharded batch and lets XLA
derive the gradient all-reduce. Here every rank runs the step on its rows
inside `collectives.data_parallel`: the loss denominators, BatchNorm's
statistics, the codebook's EMA and the random draws are the global
batch's, and the gradients are summed over the dp group in a few
flattened buckets before the global-norm clip. This is not
`DistributedDataParallel`: DDP averages per-rank losses whose
denominators are per-rank sums, normalises BatchNorm by each rank's rows,
and broadcasts rank 0's buffers over the other ranks' codebook updates.

Ranks are laid out as JAX reshapes its devices, ``rank = dp_rank·tp +
tp_rank``: the tp groups hold consecutive ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from dex_tts_tpu_torch.parallel import collectives, runtime


@dataclass
class Mesh:
    """One rank's view of the (dp, tp) mesh. Groups are None in a single
    process."""

    dp_size: int
    tp_size: int
    dp_rank: int
    tp_rank: int
    dp_group: object
    tp_group: object
    cpu_group: object

    @property
    def world_size(self) -> int:
        return self.dp_size * self.tp_size

    @property
    def rank(self) -> int:
        return self.dp_rank * self.tp_size + self.tp_rank

    @property
    def dp_root(self) -> int:
        """The global rank of this rank's dp group's first member."""
        return self.tp_rank


def make_mesh(n_devices: int | None = None, tp_size: int = 1) -> Mesh:
    """The mesh over the initialised process group (`runtime.initialize`):
    dp = world / tp_size. ``n_devices``, if given, must be the world size.
    Without a process group: the one-rank mesh (``n_devices`` 1 or None).
    Every group it creates gets `runtime.GROUP_TIMEOUT`, as the world
    group does, so a dead peer raises instead of hanging."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices {n_devices} != the process group's world size {world}")
    if world % tp_size:
        raise ValueError(f"world size {world} is not a multiple of tp_size {tp_size}")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, None, None, None)
    rank = dist.get_rank()
    dp_size = world // tp_size
    grid = np.arange(world).reshape(dp_size, tp_size)
    dp_group = tp_group = None
    # every rank creates every group, in the same order
    for t in range(tp_size):
        g = dist.new_group(grid[:, t].tolist(), timeout=runtime.GROUP_TIMEOUT)
        if rank in grid[:, t]:
            dp_group = g
    for d in range(dp_size):
        g = dist.new_group(grid[d].tolist(), timeout=runtime.GROUP_TIMEOUT)
        if rank in grid[d]:
            tp_group = g
    cpu_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                 else dist.new_group(backend="gloo", timeout=runtime.GROUP_TIMEOUT))
    return Mesh(dp_size, tp_size, rank // tp_size, rank % tp_size, dp_group, tp_group,
                cpu_group)


def shard_rows(batch: dict, mesh: Mesh) -> dict:
    """This dp rank's contiguous rows of every array of a global batch
    (the counterpart of JAX's `shard_batch`)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % mesh.dp_size:
            raise ValueError(f"batch {b} of {k!r} does not divide over {mesh.dp_size} dp ranks")
        per = b // mesh.dp_size
        out[k] = v[mesh.dp_rank * per:(mesh.dp_rank + 1) * per]
    return out


def _broadcast_(t: torch.Tensor, mesh: Mesh, sharded: bool) -> None:
    if sharded:  # each tp rank holds its own slice: broadcast within the dp group
        dist.broadcast(t, src=mesh.dp_root, group=mesh.dp_group)
    elif t.device.type == "cpu":  # e.g. Adam's step count, beside nccl's card tensors
        dist.broadcast(t, src=0, group=mesh.cpu_group)
    else:
        dist.broadcast(t, src=0)


def replicate_state(state, mesh: Mesh):
    """Broadcast a train state from rank 0 (its dp group's first rank for
    tensor-parallel slices), once: parameters, buffers, the EMA, the
    optimizer's tensors, the step and the generator. Works for the DeX
    `TrainState` and the vocoder's state. → ``state``, in place."""
    if mesh.world_size == 1:
        return state
    modules = [getattr(state, "model", None), getattr(state, "generator", None),
               getattr(state, "critics", None)]
    with torch.no_grad():
        for module in modules:
            if not isinstance(module, torch.nn.Module):
                continue
            for p in module.parameters():
                _broadcast_(p.data, mesh, hasattr(p, "tp_dim"))
            for b in module.buffers():
                _broadcast_(b, mesh, False)
        if getattr(state, "ema", None) is not None:
            params = dict(state.model.named_parameters())
            for name, t in state.ema.items():
                _broadcast_(t, mesh, hasattr(params[name], "tp_dim"))
        for opt in _optimizers(state):
            for p, st in opt.state.items():
                for t in st.values():
                    if isinstance(t, torch.Tensor):
                        _broadcast_(t, mesh, hasattr(p, "tp_dim") and t.dim() > 0)
    step = torch.tensor([int(state.step)], dtype=torch.int64)
    dist.broadcast(step, src=0, group=mesh.cpu_group)
    state.step = int(step.item())
    gen = getattr(state, "generator", None)
    if isinstance(gen, torch.Generator):
        rng = gen.get_state()
        dist.broadcast(rng, src=0, group=mesh.cpu_group)
        gen.set_state(rng)
    return state


def _optimizers(state):
    for name in ("optimizer", "gen_optimizer", "disc_optimizer"):
        opt = getattr(state, name, None)
        if opt is not None:
            yield getattr(opt, "adamw", opt)  # VocoderOptimizer wraps an AdamW


def make_parallel_train_step(train_step, mesh: Mesh):
    """Wrap ``train_step(state, batch, *args) → metrics`` (the DeX step,
    its validation step, or the vocoder's) to run on this rank's rows as
    its share of the global step: inside `collectives.data_parallel(mesh)`,
    so the step's gradients are summed over the dp group before its clip,
    and the metrics summed after it (``grad_norm`` is global already)."""

    def step(state, batch, *args):
        with collectives.data_parallel(mesh):
            return collectives.sum_metrics(train_step(state, batch, *args))

    return step
