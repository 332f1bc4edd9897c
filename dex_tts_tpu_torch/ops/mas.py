"""Monotonic alignment search (MAS): the Hopper kernel (`csrc/mas.cu`) and
its plain PyTorch version (port of dex_tts_tpu/ops/mas.py).

Replaces the TPU kernel dex_tts_tpu/ops/mas.py `_mas_kernel`, launched by
`maximum_path_pallas`. The kernel has two routes, chosen by shape alone
(`plan`, which mirrors the launcher's own `maximum_path_mas_plan`): one DP
warp per item with the column in registers and the bits in shared memory
for Tx ≤ 512 when they fit, a block per item with a barrier per frame
otherwise; `maximum_path.launches_by_route` counts them. `maximum_path`
takes the plain version
(`maximum_path_scan`, a loop over frames) for CPU tensors and launches the
kernel for CUDA tensors, whatever the backend setting: the JAX package's
reasons to default to its scan form (GSPMD partitioning, a v5e custom-call
corruption) are TPU-only, and on CUDA the scan form is about 2·Ty small
launches per step.

The path guard on the kernel's path stays on by default, as in JAX. A
direct call checks the path at once (for a CUDA tensor that waits for the kernel). A train step
must not stall, so `compute_loss` asks for the count of broken paths
instead, a device scalar that comes to the host with the step's metrics
(`train.trainer.metrics_to_host` raises MASPathError on it).
"""

from __future__ import annotations

import ctypes
import functools
import warnings

import torch

_NEG = -1e9
_GUARD: bool = True
MAS_ERRORS = "mas_errors"  # compute_loss's entry for the guard's count


class MASPathError(RuntimeError):
    """The MAS path violated its structural invariant: a valid monotonic
    alignment emits exactly one token per active mel frame, so per item
    sum(path) == t_y (the masked frame count)."""


def set_mas_backend(backend: str | None) -> None:
    """Accepts the JAX package's settings (None, "scan", "pallas"). They
    choose a TPU lowering only, so nothing is stored: CPU tensors always
    take the plain version and CUDA tensors always launch the kernel."""
    if backend not in (None, "scan", "pallas"):
        raise ValueError(f"unknown MAS backend {backend!r}")
    if backend == "pallas":
        warnings.warn(
            "set_mas_backend('pallas') selects a TPU lowering; the port launches "
            "its CUDA kernel for CUDA tensors under every setting",
            stacklevel=2,
        )


def set_mas_guard(enabled: bool) -> None:
    """Enable/disable the path-invariant guard (default: enabled)."""
    global _GUARD
    _GUARD = bool(enabled)


def _path_counts(path, mask):
    got = torch.round(path.float().sum((1, 2))).to(torch.int32)
    want = torch.round(mask[:, 0, :].float().sum(1)).to(torch.int32)
    return got, want


def _raise_on_bad_path(got, want) -> None:
    bad = torch.nonzero(got != want).flatten()
    if bad.numel():
        raise MASPathError(
            "MAS path invariant violated: per-item path frame counts "
            f"{got[bad][:8].tolist()} != masked frame counts {want[bad][:8].tolist()} "
            f"for batch items {bad[:8].tolist()} ({bad.numel()}/{got.numel()} items corrupt)"
        )


def check_mas_path(path, mask):
    """Per item sum(path) == t_y, compared at once (a host read): raises
    MASPathError, else returns ``path`` unchanged."""
    _raise_on_bad_path(*_path_counts(path, mask))
    return path


def path_errors(path, mask):
    """The number of items whose path breaks sum(path) == t_y, as an f32
    scalar on the path's device: nothing is read to the host."""
    got, want = _path_counts(path, mask)
    return (got != want).sum().float()


def raise_on_path_errors(count: float) -> None:
    """Raise MASPathError if a `path_errors` count, read to the host, is
    not 0."""
    if count:
        raise MASPathError(f"MAS path invariant violated: {int(count)} item paths with"
                           " sum(path) != t_y (the masked frame count)")


def maximum_path_scan(value, mask):
    """Plain version: the JAX scan form (mas.py:178-244) as a loop over
    frames. value (B, Tx, Ty) log-prior scores (higher is better), mask
    (B, Tx, Ty) the text × mel mask → (B, Tx, Ty) 0/1 path in value's
    dtype."""
    b, t_x_max, t_y_max = value.shape
    dev, dtype = value.device, value.dtype
    value = value * mask
    t_xs = mask[:, :, 0].sum(1).to(torch.int32)
    t_ys = mask[:, 0, :].sum(1).to(torch.int32)
    x_ids = torch.arange(t_x_max, device=dev, dtype=torch.int32)[None, :]
    neg = torch.tensor(_NEG, dtype=dtype, device=dev)
    prev = torch.full((b, t_x_max), _NEG, dtype=dtype, device=dev)
    acc = []
    for y in range(t_y_max):
        v_cur = torch.where(x_ids == y, neg, prev)
        shifted = torch.cat([neg.expand(b, 1), prev[:, :-1]], dim=1)
        first = 0.0 if y == 0 else _NEG
        v_prev = torch.where(x_ids == 0, torch.tensor(first, dtype=dtype, device=dev), shifted)
        cand = value[:, :, y] + torch.maximum(v_cur, v_prev)
        valid = ((x_ids <= y) & (x_ids >= t_xs[:, None] + y - t_ys[:, None])
                 & (x_ids < t_xs[:, None]) & (y < t_ys[:, None]))
        prev = torch.where(valid, cand, neg)
        acc.append(prev)

    batch_ids = torch.arange(b, device=dev)
    index = (t_xs - 1).long()
    path = torch.zeros((b, t_x_max, t_y_max), dtype=dtype, device=dev)
    for y in range(t_y_max - 1, -1, -1):
        active = y < t_ys
        col_prev = acc[y - 1] if y > 0 else torch.full_like(prev, _NEG)
        path[:, :, y] = ((x_ids == index[:, None]) & active[:, None]).to(dtype)
        v_here = col_prev[batch_ids, index]
        v_diag = col_prev[batch_ids, torch.clamp(index - 1, min=0)]
        move = (index != 0) & ((index == y) | (v_here < v_diag))
        index = torch.where(active & move, index - 1, index)
    return path * mask


# K4's routes (csrc/mas.cu, `maximum_path_mas_plan`), mirrored for the
# wrapper's count and the CPU emulation of the schedule: the warp route for
# Tx ≤ MAX_WARP_TX when its ring, bits and idx fit SMEM_BUDGET, the wide
# route for every other shape
SMEM_BUDGET = 227 * 1024
MAX_WARP_TX = 512
WARP_KS = (1, 2, 3, 4, 6, 8, 12, 16)
WARPS = 3  # a warp-route block: the DP warp, the copying warp, the zeroing warp
STAGES = 3  # ring tiles of the warp route
MAX_TILE_F = 32  # frames per ring tile
WIDE_THREADS = 256
MAX_TILE_Y = 32


def _round4(n: int) -> int:
    return (n + 3) & ~3


def plan(t_x: int, t_y: int) -> tuple[str, int, int, int]:
    """K4's route for a (Tx, Ty) shape, as the launcher chooses it:
    ("warp", K tokens per lane, F frames per ring tile, shared bytes) or
    ("wide", 0, frames per staged tile, shared bytes); ("none", 0, 0, 0)
    where no route fits."""
    if t_x <= 0 or t_y <= 0:
        return "none", 0, 0, 0
    if t_x <= MAX_WARP_TX:
        k = next(k for k in WARP_KS if 32 * k >= t_x)
        # mbarriers, bits and idx (Ty rounded up to 4 frames), the sums, a flag
        fixed = 16 * STAGES + 4 * (_round4(t_y) * k + _round4(t_y) + 2 * WARPS + 1)
        per_frame = 4 * 2 * STAGES * 32 * k  # value and mask, every stage
        f = min((SMEM_BUDGET - fixed) // per_frame, MAX_TILE_F, _round4(t_y)) & ~3
        if f >= 4:
            return "warp", k, f, fixed + per_frame * f
    fixed = 4 * (2 * t_x + _round4(t_y))
    per_frame = 4 * (t_x + 1)
    fit = (SMEM_BUDGET - 4 * 2 * WIDE_THREADS // 32 - fixed) // per_frame
    if fit < 1:
        return "none", 0, 0, 0
    tile_y = min(fit, MAX_TILE_Y)
    return "wide", 0, tile_y, fixed + per_frame * tile_y


@functools.cache
def _library():
    """The loaded `csrc/mas.cu`, its entry points given their signatures."""
    from dex_tts_tpu_torch.ops.kernels import load_library

    lib = load_library("mas.cu")
    lib.maximum_path_mas.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.maximum_path_mas.restype = ctypes.c_int
    lib.maximum_path_mas_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.maximum_path_mas_plan.restype = None
    return lib


def kernel_plan(t_x: int, t_y: int) -> tuple[str, int, int, int]:
    """The compiled launcher's own plan for (Tx, Ty), in `plan`'s form
    (loads the library, so it needs the card)."""
    out = (ctypes.c_int * 4)()
    _library().maximum_path_mas_plan(t_x, t_y, out)
    return {0: "warp", 1: "wide"}.get(out[0], "none"), out[1], out[2], out[3]


def launch_plan(b: int, t_x: int, t_y: int) -> tuple[str, int, int, int]:
    """`plan` for a launch at (B, Tx, Ty), checked before any launch: a
    ValueError for an empty batch, and for a shape that neither route's
    shared memory fits (the launcher would refuse it)."""
    shape = f"(B, Tx, Ty) = ({b}, {t_x}, {t_y})"
    if b == 0:
        raise ValueError(f"maximum_path: the batch is empty, {shape}")
    if t_x <= 0 or t_y <= 0:
        raise ValueError(f"maximum_path: Tx and Ty must be positive, {shape}")
    route = plan(t_x, t_y)
    if route[0] == "none":
        raise ValueError(
            f"maximum_path: no K4 route for {shape}: the wide route's"
            f" {12 * t_x + 4 * _round4(t_y) + 68} bytes of shared memory exceed the"
            f" {SMEM_BUDGET}-byte limit, as does the warp route's (Tx <= {MAX_WARP_TX})"
        )
    return route


def _launch(value, mask):
    """One K4 launch: f32 contiguous (B, Tx, Ty) value and mask → the f32
    path, written in full (the wide route keeps its bits in the path's
    buffer until it writes the path; the warp route in shared memory)."""
    b, t_x, t_y = value.shape
    route = launch_plan(b, t_x, t_y)[0]
    value = value.float().contiguous()
    mask = mask.float().contiguous()
    path = torch.empty((b, t_x, t_y), dtype=torch.float32, device=value.device)
    with torch.cuda.device(value.device):
        err = _library().maximum_path_mas(
            value.data_ptr(), mask.data_ptr(), path.data_ptr(), b, t_x, t_y,
            torch.cuda.current_stream(value.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"maximum_path launch failed: CUDA error {err}")
    maximum_path.launches += 1
    maximum_path.launches_by_route[route] += 1
    return path


def maximum_path(value, mask, return_errors: bool = False):
    """Most-likely monotonic alignment path, (B, Tx, Ty) 0/1 in value's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel (on the current stream, no synchronisation) or raise. With the
    guard on, the kernel's path is checked (the plain version is the
    reference, as JAX's scan form is unguarded): at once, or, with
    ``return_errors``, not here: (path, `path_errors` count) comes back
    for the caller to read with its own results (0 where unguarded)."""
    if value.shape != mask.shape or value.dim() != 3:
        raise ValueError(f"value and mask must be (B, Tx, Ty) alike: {value.shape}, {mask.shape}")
    if value.device.type == "cpu":
        path = maximum_path_scan(value, mask)
    elif value.device.type != "cuda" or mask.device != value.device:
        raise ValueError(f"no maximum_path for devices {value.device}, {mask.device}")
    else:
        path = _launch(value, mask).to(value.dtype)
    guarded = _GUARD and path.device.type == "cuda"
    if return_errors:
        return path, (path_errors(path, mask) if guarded
                      else torch.zeros((), device=path.device))
    if guarded:
        check_mas_path(path, mask)
    return path


maximum_path.launches = 0  # all launches; by route below
maximum_path.launches_by_route = {"warp": 0, "wide": 0}
