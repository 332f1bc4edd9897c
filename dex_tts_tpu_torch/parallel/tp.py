"""Tensor parallelism over the mesh's tp group (port of
dex_tts_tpu/parallel/tp.py).

Megatron-style column/row rules for the matmul-heavy submodules (RetNet
q/k/v/g and the GLU FFN, DiT attention qkv/proj and MLP), on the port's
module names. `shard_tensor_parallel` swaps each matching ``nn.Linear``
for a `TensorParallelLinear` that holds only this rank's slice of the
weight (and of the bias, where JAX shards it) and computes exactly the
full layer through differentiable collectives:

- column: the local product, then an all-gather of the output features
  (so a fused qkv output keeps its full layout for any split);
- row: the local slice of the input features × the local weight, an
  all-reduce, then the bias.

Every rank of a tp group computes the rest of the model on the same rows,
so the loss is the same on each; the backward all-reduces a layer's input
gradient over the group. A width that does not divide stays replicated, as
JAX's `partition_spec` leaves it. Sliced parameters carry ``tp_dim`` (the
axis of the ``(out, in)`` weight or of the bias that is split); the EMA and
the Adam moments follow them (`shard_train_state`), and `full_state_dict`,
`full_ema` and `full_optimizer_state` gather them back, so checkpoints
keep the one-process layout and restore into any world or tp size.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dex_tts_tpu_torch.parallel.collectives import all_reduce_, gather_dim
from dex_tts_tpu_torch.utils import profiling

# weight (out, in) split on the output axis; the bias split alike
COLUMN_RULES = (
    "retention.q_proj",
    "retention.k_proj",
    "retention.v_proj",
    "retention.g_proj",
    "ffn.gate",
    "ffn.fc1",
    "attn.qkv",
    "mlp.fc1",
)
# weight split on the input axis; the bias stays replicated
ROW_RULES = (
    "retention.out_proj",
    "ffn.fc2",
    "attn.proj",
    "mlp.fc2",
)


def partition(name: str, module: nn.Module, tp_size: int) -> str | None:
    """"column", "row" or None (replicated) for the module ``name``."""
    if not isinstance(module, nn.Linear) or tp_size == 1:
        return None
    if name.endswith(COLUMN_RULES) and module.out_features % tp_size == 0:
        return "column"
    if name.endswith(ROW_RULES) and module.in_features % tp_size == 0:
        return "row"
    return None


def _local(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).clone()


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the tp
    group (each rank holds only its slice's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward; identity backward (the output's gradient is the
    same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    """The ranks' slices of the last axis → the full last axis; the
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.n = rank, x.shape[-1]
        return gather_dim(x.contiguous(), x.dim() - 1, group, rank, size)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None


class TensorParallelLinear(nn.Module):
    """A column- or row-parallel slice of an ``nn.Linear`` that computes the
    full layer. ``forward(x, dtype)`` casts input, weight and bias to
    ``dtype`` first, as `models.layers.run_in` does for a plain Linear."""

    def __init__(self, linear: nn.Linear, kind: str, mesh):
        super().__init__()
        self.kind = kind
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.group, self.rank, self.size = mesh.tp_group, mesh.tp_rank, mesh.tp_size
        dim = 0 if kind == "column" else 1
        self.weight = nn.Parameter(_local(linear.weight.detach(), dim, self.rank, self.size))
        self.weight.tp_dim = dim
        if linear.bias is None:
            self.bias = None
        elif kind == "column":
            self.bias = nn.Parameter(_local(linear.bias.detach(), 0, self.rank, self.size))
            self.bias.tp_dim = 0
        else:
            self.bias = nn.Parameter(linear.bias.detach().clone())

    def forward(self, x, dtype: torch.dtype | None = None):
        w, b = self.weight, self.bias
        if dtype is not None:
            if profiling.TRACING:
                profiling.count_casts(dtype, w, b)
            x, w = x.to(dtype), w.to(dtype)
            b = None if b is None else b.to(dtype)
        x = _CopyToGroup.apply(x, self.group)
        if self.kind == "column":
            return _GatherLast.apply(F.linear(x, w, b), self.group, self.rank, self.size)
        n = self.in_features // self.size
        y = _ReduceFromGroup.apply(F.linear(x[..., self.rank * n:(self.rank + 1) * n], w),
                                   self.group)
        return y if b is None else y + b

    def extra_repr(self) -> str:
        return (f"{self.kind}, in_features={self.in_features}, "
                f"out_features={self.out_features}, tp={self.rank}/{self.size}")


def shard_tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Swap every ``nn.Linear`` that a rule matches, and whose split width
    divides, for this rank's `TensorParallelLinear` (in place; the
    parameter order is kept). tp size 1: unchanged. → ``model``."""
    if mesh.tp_size == 1:
        return model
    for name, mod in list(model.named_modules()):
        kind = partition(name, mod, mesh.tp_size)
        if kind is None:
            continue
        parent, _, child = name.rpartition(".")
        new = TensorParallelLinear(mod, kind, mesh).to(mod.weight.device)
        setattr(model.get_submodule(parent) if parent else model, child, new)
    return model


def _sharded(model: nn.Module) -> dict:
    """name → its TensorParallelLinear's parameter, for sliced ones."""
    out = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, TensorParallelLinear):
            for pname, p in mod.named_parameters(recurse=False):
                if hasattr(p, "tp_dim"):
                    out[f"{mname}.{pname}"] = (p, mod)
    return out


def shard_count(model: nn.Module) -> int:
    """Number of sliced parameter tensors (weights and column biases)."""
    return len(_sharded(model))


def _gather(t: torch.Tensor, p, mod: TensorParallelLinear) -> torch.Tensor:
    return gather_dim(t.detach(), p.tp_dim, mod.group, mod.rank, mod.size)


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every slice gathered back to the
    one-process layout (a collective: every rank of the tp group calls it)."""
    sd = model.state_dict()
    for name, (p, mod) in _sharded(model).items():
        sd[name] = _gather(p, p, mod)
    return sd


def full_ema(model: nn.Module, ema: dict) -> dict:
    """The EMA dict with sliced entries gathered (collective)."""
    out = dict(ema)
    for name, (p, mod) in _sharded(model).items():
        out[name] = _gather(ema[name], p, mod)
    return out


def _param_list(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with each sliced parameter's moments
    gathered (collective)."""
    sd = optimizer.state_dict()
    owners = {id(p): mod for p, mod in _sharded(model).values()}
    for i, p in enumerate(_param_list(optimizer)):
        mod = owners.get(id(p))
        if mod is None or i not in sd["state"]:
            continue
        sd["state"][i] = {k: _gather(v, p, mod) if torch.is_tensor(v) and v.dim() else v
                          for k, v in sd["state"][i].items()}
    return sd


def shard_train_state(state, mesh):
    """`shard_tensor_parallel` on a one-process-layout `TrainState`, with
    its EMA and Adam moments sliced alike (a fresh optimizer over the new
    parameters, loaded with the sliced state). → ``state``, in place."""
    if mesh.tp_size == 1:
        return state
    opt_sd = state.optimizer.state_dict()
    shard_tensor_parallel(state.model, mesh)
    sharded = _sharded(state.model)
    for name, (p, mod) in sharded.items():
        state.ema[name] = _local(state.ema[name], p.tp_dim, mod.rank, mod.size)
    opt = type(state.optimizer)(state.model.parameters(), **state.optimizer.defaults)
    for i, p in enumerate(_param_list(opt)):
        if hasattr(p, "tp_dim") and i in opt_sd["state"]:
            opt_sd["state"][i] = {
                k: _local(v, p.tp_dim, mesh.tp_rank, mesh.tp_size)
                if torch.is_tensor(v) and v.dim() else v
                for k, v in opt_sd["state"][i].items()}
    opt.load_state_dict(opt_sd)
    state.optimizer = opt
    return state
