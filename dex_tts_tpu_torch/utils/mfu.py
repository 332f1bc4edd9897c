"""Model-FLOPs utilization of the port's benches (port of
dex_tts_tpu/utils/mfu.py).

MFU = FLOPs of the call / its wall seconds / the card's dense bf16 peak.

The count is `torch.utils.flop_counter.FlopCounterMode` over a run of the
function: matrix products and convolutions at 2 FLOPs per multiply-add,
forward and backward. Elementwise work, reductions, norms, softmax and the
optimizer's updates (clip, Adam, EMA) count 0, so this MFU is a lower
bound, as the JAX package's is. What the counter cannot see gets a
formula here, the count of the matrix products its plain version makes,
so that a function counts the same on the card and on the CPU and on
every attention route:

- the port's hand-written kernels, launched through ctypes: each wrapper
  calls `note_kernel_flops` where it launches (flash attention
  4·B·H·T²·hd forward and 8·B·H·T²·hd backward, the einsum route's
  products; the snake's filters; MAS multiplies nothing);
- cuDNN's fused RNN (``aten._cudnn_rnn`` and its backward), which the CPU
  computes as separate matrix products.

Peaks are NVIDIA's dense bf16 tensor-core rates; f32 work is held against
the same peak, which keeps the MFU a lower bound.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import FlopCounterMode

# (a substring of torch.cuda.get_device_name(), dense bf16 FLOP/s)
PEAKS: tuple[tuple[str, float], ...] = (
    ("H100 80GB HBM3", 989.4e12),  # H100 SXM
    ("H100 PCIe", 756e12),
)


def peak_flops_per_chip(device: torch.device | str = "cuda") -> float | None:
    """Dense bf16 peak FLOP/s of ``device``'s card; None for the CPU and for
    a card not in `PEAKS` (an MFU without a known peak would be fiction)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for sub, peak in PEAKS:
        if sub in name:
            return peak
    return None


def mfu(flops: float | None, wall_seconds: float, device: torch.device | str = "cuda"
        ) -> float | None:
    """Fraction of the card's bf16 peak that ``flops`` in ``wall_seconds``
    reach; None without a peak or a count."""
    peak = peak_flops_per_chip(device)
    if flops is None or peak is None or wall_seconds <= 0:
        return None
    return flops / wall_seconds / peak


@torch.library.custom_op("dex_tts_torch::kernel_flops", mutates_args=())
def kernel_flops(anchor: torch.Tensor, flops: int) -> None:
    """Does nothing; under `count_flops` it counts ``flops`` FLOPs. A kernel
    wrapper calls it where it launches, with one of its tensors."""


def note_kernel_flops(anchor: torch.Tensor, flops: int) -> None:
    """A kernel launch's FLOPs: `kernel_flops` where a dispatch mode (the
    counter of `count_flops`) is active, nothing elsewhere, so a launch
    outside a count pays one thread-local lookup, not a custom-op call."""
    if _get_current_dispatch_mode() is not None:
        kernel_flops(anchor, flops)


def _kernel_flops_formula(anchor_shape, flops, *args, out_shape=None, **kwargs) -> int:
    return flops


# cuDNN RNN modes (cudnnRNNMode_t) → gates per hidden unit
_RNN_GATES = {0: 1, 1: 1, 2: 4, 3: 3}


def _rnn_layers(input_shape, mode, hidden_size, num_layers, batch_first, bidirectional,
                batch_sizes):
    """Per layer: (rows, rows of the first step, input width, gate width,
    directions) of a cuDNN RNN call."""
    if batch_sizes:
        rows, first = input_shape[0], batch_sizes[0]
    else:
        t, b = (input_shape[1], input_shape[0]) if batch_first else input_shape[:2]
        rows, first = t * b, b
    dirs = 2 if bidirectional else 1
    width = input_shape[-1]
    for _ in range(num_layers):
        yield rows, first, width, _RNN_GATES[mode] * hidden_size, dirs
        width = hidden_size * dirs


def _cudnn_rnn_formula(input_shape, weight, weight_stride0, weight_buf, hx, cx, mode,
                       hidden_size, proj_size, num_layers, batch_first, dropout, train,
                       bidirectional, batch_sizes, *args, out_shape=None, **kwargs) -> int:
    """The input and the hidden projections of every row, as the CPU's
    cells compute them."""
    return sum(2 * rows * (width + hidden_size) * gates * dirs for rows, _, width, gates, dirs
               in _rnn_layers(input_shape, mode, hidden_size, num_layers, batch_first,
                              bidirectional, batch_sizes))


def _cudnn_rnn_backward_formula(input_shape, weight, weight_stride0, weight_buf, hx, cx,
                                output, grad_output, grad_hy, grad_cy, mode, hidden_size,
                                proj_size, num_layers, batch_first, dropout, train,
                                bidirectional, batch_sizes, dropout_state, reserve,
                                output_mask, *args, out_shape=None, **kwargs) -> int:
    """What autograd through the CPU's cells computes: the weights'
    gradients (one product per forward product), the hidden state's
    gradient through every step but the first (unless ``hx`` wants one),
    and the input's gradient (the first layer's only if it wants one)."""
    want_x, want_hx, _, want_w = output_mask
    total = 0
    for i, (rows, first, width, gates, dirs) in enumerate(_rnn_layers(
            input_shape, mode, hidden_size, num_layers, batch_first, bidirectional,
            batch_sizes)):
        if want_w:
            total += 2 * rows * (width + hidden_size) * gates * dirs
        total += 2 * (rows if want_hx else rows - first) * hidden_size * gates * dirs
        if i > 0 or want_x:
            total += 2 * rows * width * gates * dirs
    return total


FORMULAS = {
    torch.ops.dex_tts_torch.kernel_flops: _kernel_flops_formula,
    torch.ops.aten._cudnn_rnn: _cudnn_rnn_formula,
    torch.ops.aten._cudnn_rnn_backward: _cudnn_rnn_backward_formula,
}


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one run of ``fn(*args, **kwargs)`` (which runs), by the
    module docstring's convention."""
    with FlopCounterMode(display=False, custom_mapping=FORMULAS) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def extrapolated_scan_flops(fn_at_steps, steps: int, *args, unit: int = 1, **kwargs) -> int:
    """FLOPs of a run whose one loop takes ``steps`` equal iterations,
    without running them all: ``fn_at_steps(n)`` is the function at ``n``
    iterations, F(n) = A + n·B, so two short runs give A + steps·B =
    F(2u) + (steps/u − 2)·(F(3u) − F(2u)), the JAX package's F(1) + (n −
    1)·(F(2) − F(1)) from runs of 2 and 3 units (a 1-step EDM schedule
    divides by zero). ``unit``: the iterations that repeat (a DiT-cache
    chunk of k steps). A loop of fewer than 3 units is counted whole."""
    if steps % unit:
        raise ValueError(f"{steps} steps are not whole units of {unit}")
    if steps < 3 * unit:
        return count_flops(fn_at_steps(steps), *args, **kwargs)
    f2 = count_flops(fn_at_steps(2 * unit), *args, **kwargs)
    f3 = count_flops(fn_at_steps(3 * unit), *args, **kwargs)
    if f3 <= f2:
        raise ValueError(f"the loop counts no FLOPs per iteration ({f2} then {f3})")
    return f2 + (steps // unit - 2) * (f3 - f2)
