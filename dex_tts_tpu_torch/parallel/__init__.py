"""Data and tensor parallelism over `torch.distributed` (port of
dex_tts_tpu/parallel/). The JAX names map as: `initialize` (runtime),
`make_mesh`, `replicate_state` and `make_parallel_train_step` (mesh),
`shard_batch` / `assemble_global_batch` → `shard_rows` or the batcher's
``process_count``/``process_index``, `tp_state_shardings` →
`shard_tensor_parallel` / `shard_train_state`, `shard_count` (tp)."""

from dex_tts_tpu_torch.parallel.collectives import data_parallel
from dex_tts_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_parallel_train_step,
    replicate_state,
    shard_rows,
)
from dex_tts_tpu_torch.parallel.runtime import initialize, launch
from dex_tts_tpu_torch.parallel.tp import (
    full_state_dict,
    shard_count,
    shard_tensor_parallel,
    shard_train_state,
)

__all__ = [
    "Mesh",
    "data_parallel",
    "full_state_dict",
    "initialize",
    "launch",
    "make_mesh",
    "make_parallel_train_step",
    "replicate_state",
    "shard_count",
    "shard_rows",
    "shard_tensor_parallel",
    "shard_train_state",
]
