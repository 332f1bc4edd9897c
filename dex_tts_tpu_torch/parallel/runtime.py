"""Process-group runtime: joining a `torch.distributed` group, and
launching one process per rank (port of dex_tts_tpu/parallel/runtime.py).

One process per rank, each on its own card (nccl), or any number on the
CPU or sharing a card (gloo). `initialize` reads torchrun's
``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` unless told otherwise; `launch`
starts the ranks itself, joined through a file store, and fails (killing
every rank) if one raises or the group does not finish in time, so a dead
peer never leaves the others waiting. A rank's share of the data comes
from `BucketBatcher(process_count, process_index)` or, for callers that
hold the global batch, `parallel.mesh.shard_rows`.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

GROUP_TIMEOUT = datetime.timedelta(seconds=300)
_DEVICE: list = []


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None, device=None) -> bool:
    """Join the process group → True, or False for a single process
    (``WORLD_SIZE`` unset or 1 and no arguments). The rank's device is
    ``device``, else ``cuda:LOCAL_RANK`` (raising without CUDA, or when
    there are fewer cards than local ranks: the CPU must be asked for); the
    backend is nccl on a card and gloo on the CPU unless ``backend`` names
    one (gloo lets several ranks share one card). The group gets
    `GROUP_TIMEOUT`, so a dead peer raises instead of hanging. Already
    initialised: True."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None and rank is None:
        return False
    rank = int(env.get("RANK", "0")) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    if device is None:
        if torch.cuda.is_available() and local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} needs card {local_rank}, but "
                               f"torch.cuda.device_count() is {torch.cuda.device_count()}")
        device = f"cuda:{local_rank}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    # nccl binds the rank to its card now, not by guessing from the rank
    bind = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=GROUP_TIMEOUT, **bind)
    _DEVICE[:] = [device]
    return True


def rank_devices(n: int | None = None, device=None) -> list[str]:
    """One device per rank for `launch`: ``n`` cards (default: every card),
    or ``n`` CPU ranks (default 1) when ``device`` is the CPU. Without CUDA
    this raises unless the CPU is asked for; more ranks than cards raises,
    naming both counts (ranks that share a card must be asked for
    explicitly, through `launch`'s ``devices``)."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * (n or 1)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    count = torch.cuda.device_count()
    n = n or count
    if n > count:
        raise ValueError(f"--n_devices {n} asks for {n} cards, but "
                         f"torch.cuda.device_count() is {count}")
    return [f"cuda:{r}" for r in range(n)]


def rank_device() -> torch.device | None:
    """The device `initialize` chose for this rank (None before)."""
    return _DEVICE[0] if _DEVICE else None


def _rank_main(rank, world_size, init_method, backend, device, fn, args, results):
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        initialize(init_method, world_size, rank, backend, device)
        out = fn(rank, *args)
        dist.barrier()
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world_size: int, args: tuple = (), backend: str | None = None,
           devices=None, timeout: float | None = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes joined in
    one group (a file store in a temporary directory) → each rank's return
    value, by rank (picklable, host objects). ``devices``: one per rank
    (default: `rank_devices`; ranks on the CPU run one thread each). The
    first rank that raises, or ``timeout`` seconds (None: no limit)
    without an end, kills every rank and raises here."""
    import torch.multiprocessing as mp

    devices = [str(d) for d in devices or rank_devices(world_size)]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, init_method, backend, devices[r], fn, args,
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.time() + (float("inf") if timeout is None else timeout)
        try:
            while len(out) < world_size:
                try:
                    rank, status, value = results.get(timeout=1.0)
                except queue.Empty:
                    if time.time() > deadline:
                        raise TimeoutError(f"{world_size} ranks did not finish in {timeout} s")
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank process exited with code {dead[0].exitcode}")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=max(1.0, min(60.0, deadline - time.time())))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
