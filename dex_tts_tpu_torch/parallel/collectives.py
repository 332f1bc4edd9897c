"""The collectives that make a data-parallel rank's step its share of the
one-process step on the global batch (the port's counterpart of what XLA
SPMD derives for dex_tts_tpu/parallel/).

A JAX step over a dp-sharded batch equals the one-device step on the
global batch: batch statistics, the VQ codebook's EMA, the loss
denominators and the random draws are all global. Inside
``data_parallel(mesh)`` the helpers below keep that so:

- `global_sum`: a differentiable all-reduced sum over the dp group (loss
  denominators, BatchNorm's sums, the codebook's counts). Each rank's loss
  is then its share of the global loss, and the gradients are *summed*
  over the ranks (`reduce_gradients_`).
- `rand` / `randn`: the global batch's draw from the shared generator, of
  which the rank keeps its rows.
- `sum_metrics`, `agree_any`: metrics and control flow agreed by all ranks.

Outside the context, or with one dp rank, every helper is the identity,
so one-process numbers stay bit for bit as they are. Every collective is
an ``all_reduce`` or a ``broadcast``: the two that gloo documents for
CUDA tensors, so one code path serves nccl and gloo.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_MESHES: list = []
BUCKET_BYTES = 32 << 20  # gradient all-reduce bucket


@contextlib.contextmanager
def data_parallel(mesh):
    """Run the block as one rank of ``mesh`` (a `parallel.mesh.Mesh`;
    None: one process, every helper the identity)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current():
    """The mesh of the enclosing `data_parallel` block, or None."""
    return _MESHES[-1] if _MESHES else None


def _dp():
    """The mesh when its dp group has more than one rank, else None."""
    mesh = current()
    return mesh if mesh is not None and mesh.dp_size > 1 else None


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``; half-precision tensors are summed in
    f32."""
    if x.dtype in (torch.bfloat16, torch.float16):
        wide = x.float()
        dist.all_reduce(wide, group=group)
        x.copy_(wide)
    else:
        dist.all_reduce(x, group=group)
    return x


class AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x on every rank; the gradient is all-reduced the same
    way, since every rank's loss uses y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the dp ranks of ``x``, differentiable (the identity outside
    a data-parallel block)."""
    mesh = _dp()
    return x if mesh is None else AllReduceSum.apply(x, mesh.dp_group)


def dp_world() -> int:
    """The number of dp ranks that share the global batch (1 outside)."""
    mesh = _dp()
    return 1 if mesh is None else mesh.dp_size


def _draw(fn, shape, **kwargs):
    mesh = _dp()
    shape = tuple(shape)
    if mesh is None:
        return fn(shape, **kwargs)
    b = shape[0]
    full = fn((b * mesh.dp_size,) + shape[1:], **kwargs)
    return full[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]


def rand(shape, generator=None, device=None, dtype=None) -> torch.Tensor:
    """Uniform [0, 1) draws whose leading axis is the batch: the global
    batch's draw, of which this rank keeps its rows."""
    return _draw(torch.rand, shape, generator=generator, device=device, dtype=dtype)


def randn(shape, generator=None, device=None, dtype=None) -> torch.Tensor:
    """Standard normal draws, batch-leading, as `rand`."""
    return _draw(torch.randn, shape, generator=generator, device=device, dtype=dtype)


def gather_dim(t: torch.Tensor, dim: int, group, rank: int, size: int) -> torch.Tensor:
    """The full tensor on every rank of ``group`` from each rank's equal
    slice along ``dim``: one broadcast per slice, so each byte crosses
    once (not differentiable)."""
    t = t.contiguous()
    parts = [t if r == rank else torch.empty_like(t) for r in range(size)]
    for r, part in enumerate(parts):
        dist.broadcast(part, src=dist.get_global_rank(group, r), group=group)
    return torch.cat(parts, dim)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(b, ...) rows of each dp rank → the (dp·b, ...) global batch on
    every rank."""
    mesh = _dp()
    return x if mesh is None else gather_dim(x, 0, mesh.dp_group, mesh.dp_rank, mesh.dp_size)


def reduce_gradients_(grads: list[torch.Tensor]) -> None:
    """Sum the gradients over the dp group in place, in flattened buckets
    of at most `BUCKET_BYTES`. Runs whenever the block's mesh has a dp
    group, one rank included (an all-reduce over one rank is exact)."""
    mesh = current()
    if mesh is None or mesh.dp_group is None:
        return
    bucket, size = [], 0
    for g in grads + [None]:
        if g is not None:
            bucket.append(g)
            size += g.numel() * g.element_size()
        if bucket and (g is None or size >= BUCKET_BYTES):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            all_reduce_(flat, mesh.dp_group)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            bucket, size = [], 0


def grad_sq_norm(params) -> torch.Tensor:
    """Σ g² over the parameters' gradients of the whole model: a slice of
    a tensor-parallel weight (``tp_dim`` set) is summed over the tp group,
    a replicated one counted once."""
    params = [p for p in params if p.grad is not None]
    sharded = [p.grad for p in params if hasattr(p, "tp_dim")]
    total = sum((g.float() ** 2).sum() for g in (p.grad for p in params
                                                 if not hasattr(p, "tp_dim")))
    mesh = current()
    if sharded:
        part = sum((g.float() ** 2).sum() for g in sharded)
        if mesh is not None and mesh.tp_size > 1:
            part = all_reduce_(part.clone(), mesh.tp_group)
        total = total + part
    return total


def sum_metrics(metrics: dict) -> dict:
    """Every metric summed over the dp group in one all-reduce, except
    ``grad_norm`` (taken after the gradients' sum: global already). Each
    rank's loss is its share, so the sum is the global batch's value."""
    mesh = _dp()
    if mesh is None:
        return metrics
    keys = [k for k in metrics if k != "grad_norm"]
    device = next(v.device for v in metrics.values() if torch.is_tensor(v))
    flat = torch.stack([torch.as_tensor(metrics[k], device=device).detach().float().reshape(())
                        for k in keys])
    all_reduce_(flat, mesh.dp_group)
    out = dict(metrics)
    out.update(zip(keys, flat.unbind()))
    return out


def agree_max(value: int, mesh=None) -> int:
    """The largest of every rank's ``value`` (a max-reduce over the mesh's
    CPU group), on every rank."""
    mesh = mesh or current()
    if mesh is None or mesh.world_size == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.cpu_group)
    return int(t.item())


def agree_any(flag: bool, mesh=None) -> bool:
    """True on every rank when ``flag`` is true on any, so all ranks take
    the same branch."""
    return bool(agree_max(1 if flag else 0, mesh))
