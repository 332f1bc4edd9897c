"""BigVGAN's anti-aliased snake: the Hopper kernel (`csrc/snake.cu`) and
its plain PyTorch version.

Replaces the TPU kernels of dex_tts_tpu/ops/snake.py: `_snake_fold_kernel`
(reached through `snake_antialias_fold`, the bf16 generator's route) and
`_snake_kernel` (reached through `snake_antialias_pallas`, the f32
route). All of them compute one function per channel c of x (B, T, C):

    2× Kaiser-sinc upsample → s = u + inv_beta[c]·sin²(alpha[c]·u)
    → Kaiser-sinc low-pass and 2× decimate,

with the reference's edge clipping on the interleaved signal
(reference: DEX-TTS/bigvgan/alias_free_torch/{act,resample,filter}.py).
The upsample splits into two 6-tap polyphase branches (even/odd output
samples) and the downsample into two more, so everything stays at length
T (see `snake_antialias_reference`).

Numbers follow the TPU kernels: f32 arithmetic from the storage dtype,
`alpha`/`inv_beta` read in x's dtype, one rounding to the output dtype.
sin² is the degree-7 polynomial `_sin2_fast` where the JAX package's
route would be the fold kernel with bf16 storage (impl "auto", "fold",
"foldb"), exact `sin` everywhere else.

Under autograd (vocoder training) a CUDA launch goes through
`SnakeKernelFunction`: the kernel forward, and the backward of the plain
version with the exact sine, as the JAX package's ``_snake_bwd``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from dex_tts_tpu_torch.utils.mfu import note_kernel_flops

IMPLS = ("auto", "polyphase", "fold", "foldb", "pallas")
# the JAX routes that reach the fold kernel, which uses the polynomial
# sin² for bf16 storage (dex_tts_tpu/ops/snake.py:443-449, :647-648)
FAST_SIN_IMPLS = ("auto", "fold", "foldb")
KERNEL_SIZES = (8, 12, 16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HALF = 8  # taps per polyphase branch the kernel holds (k ≤ 16)
# the kernel's schedule (csrc/snake.cu): a warp walks a segment of at
# most SEGMENT_CHUNKS chunks of one (b, c) row, a chunk being 32 runs of
# RUN outputs, one run per lane
RUN = 8
CHUNK = 32 * RUN
SEGMENT_CHUNKS = 16


def kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int):
    """Kaiser-windowed sinc low-pass, sum-normalized.
    reference: bigvgan/alias_free_torch/filter.py:28-57."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * np.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def _phase_filters(k: int = 12):
    """Polyphase tap lists (f0, f1, ge, go) of the ratio-2 Kaiser filters
    of size k (k % 4 == 0). With q = k//4:
        up[2s]   = Σ_a f0[a]·x[clip(s+a-q)]
        up[2s+1] = Σ_a f1[a]·x[clip(s+a-q+1)]
        y[t]     = Σ_a ge[a]·s̃1[t+a-q] + go[a]·s̃0[t+a-q+1]."""
    assert k % 4 == 0, f"polyphase split needs k % 4 == 0, got {k}"
    f_up = kaiser_sinc_filter(0.25, 0.3, k) * 2.0
    g = kaiser_sinc_filter(0.25, 0.3, k)
    fr = f_up[::-1]
    f0 = [float(v) for v in fr[0::2]]
    f1 = [float(v) for v in fr[1::2]]
    ge = [float(v) for v in g[0::2]]
    go = [float(v) for v in g[1::2]]
    return f0, f1, ge, go


# sin²(t) = 0.5 − 0.5·cos(2t), cos(2πv) as a degree-7 polynomial in v²
# after range reduction v = t/π − round(t/π) ∈ [−½, ½]: max abs error
# 8.8e-6 evaluated in f32, far below bf16 output rounding (~4e-3).
_SIN2_COEF = (
    0.9999999999193508, -19.739208758208584, 64.93939011340913,
    -85.45668538180254, 60.24246470872289, -26.406761080377983,
    7.806608463960106, -1.4609479689305238,
)


def _sin2_fast(t: torch.Tensor) -> torch.Tensor:
    """Polynomial sin²(t) of an f32 tensor (see _SIN2_COEF)."""
    v = t * float(np.float32(1.0 / np.pi))
    v = v - torch.round(v)
    z = v * v
    c = torch.full_like(z, float(np.float32(_SIN2_COEF[-1])))
    for a in _SIN2_COEF[-2::-1]:
        c = c * z + float(np.float32(a))
    return 0.5 - 0.5 * c


def depthwise(x: torch.Tensor, taps, stride: int = 1) -> torch.Tensor:
    """Correlate every channel of (B, C, T) with one shared 1-D filter
    (no padding)."""
    c = x.shape[1]
    w = torch.tensor(taps, dtype=x.dtype, device=x.device).reshape(1, 1, -1)
    return F.conv1d(x, w.expand(c, 1, -1), stride=stride, groups=c)


def snake_antialias_reference(x, alpha, inv_beta, kernel_size: int = 12,
                              fast_sin: bool = False):
    """Plain version, (B, T, C) in and out: the polyphase form of
    dex_tts_tpu/ops/snake.py:110 computed in f32 from x's dtype, with
    ``alpha``/``inv_beta`` taken in x's dtype, and one rounding to x's
    dtype at the end. The result is a (B, T, C) view of a (B, C, T)
    tensor."""
    k = kernel_size
    q = k // 4
    f0, f1, ge, go = _phase_filters(k)
    t = x.shape[1]
    xf = x.transpose(1, 2).float()  # (B, C, T)
    al = alpha.to(x.dtype).float()[None, :, None]
    ib = inv_beta.to(x.dtype).float()[None, :, None]
    # replicate padding as a concatenation: its backward is a plain sum,
    # where F.pad's replicate backward accumulates with atomics on CUDA
    # (not bit-reproducible)
    xe = torch.cat([xf[..., :1].expand(-1, -1, q), xf, xf[..., -1:].expand(-1, -1, q)], dim=-1)
    p0 = depthwise(xe[..., : t + k // 2 - 1], f0)
    p1 = depthwise(xe[..., 1 : t + k // 2], f1)
    sin2 = _sin2_fast if fast_sin else (lambda v: torch.sin(v) ** 2)
    s0 = p0 + ib * sin2(p0 * al)
    s1 = p1 + ib * sin2(p1 * al)
    # the reference clips the interleaved signal: left of 0 both phases
    # read s0[0], right of T-1 both read s1[T-1]
    left = s0[..., :1].expand(-1, -1, q)
    right = s1[..., -1:].expand(-1, -1, q)
    s0p = torch.cat([left, s0, right], dim=-1)
    s1p = torch.cat([left, s1, right], dim=-1)
    y = depthwise(s1p[..., : t + k // 2 - 1], ge) + depthwise(s0p[..., 1 : t + k // 2], go)
    return y.to(x.dtype).transpose(1, 2)


def snake_flops(b: int, t: int, c: int, kernel_size: int = 12) -> int:
    """FLOPs of one call by the port's convention (utils/mfu.py): the
    plain version's four depthwise filters (the two phases of the
    upsampler, the two of the decimator), each k/2 taps over T outputs of
    every (b, c) row, 2 per tap."""
    return 4 * b * c * t * kernel_size


def _bind(lib: ctypes.CDLL):
    """The C entry point of a built snake.cu, with its signature."""
    fn = lib.snake_antialias_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
        + [ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    from dex_tts_tpu_torch.ops.kernels import load_library

    return _bind(load_library("snake.cu"))


@functools.cache
def _filter_array(k: int):
    """f0, f1, ge, go, each zero-padded to the kernel's 8 taps."""
    taps = []
    for branch in _phase_filters(k):
        taps += branch + [0.0] * (_MAX_HALF - len(branch))
    return (ctypes.c_float * len(taps))(*taps)


def _check(x, k):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the snake kernel takes bf16 or f32 x, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    if k not in KERNEL_SIZES:
        raise ValueError(f"the snake kernel takes kernel_size in {KERNEL_SIZES}, got {k}")
    if max(x.shape) > 2**31 - 1:  # B, T, C reach the launcher as C ints
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's int sizes")


def _launch(x, alpha, inv_beta, kernel_size: int, fast_sin: bool):
    """One launch of the kernel on x's card: y (B, T, C) in x's dtype, with
    the strides of a dense x. ``alpha``/``inv_beta``: (C,) contiguous in
    x's dtype."""
    _check(x, kernel_size)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    b, t, c = x.shape
    with torch.cuda.device(x.device):  # the C launcher uses the current device
        err = _kernel()(
            x.data_ptr(), alpha.data_ptr(), inv_beta.data_ptr(), y.data_ptr(),
            _DTYPE_CODE[x.dtype], kernel_size, int(bool(fast_sin)), b, t, c,
            *x.stride(), *y.stride(), ctypes.addressof(_filter_array(kernel_size)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        # 1 is also the launcher's refusal of a grid beyond its limits
        raise RuntimeError(f"snake_antialias launch failed: CUDA error {err}")
    snake_antialias.launches += 1
    note_kernel_flops(y, snake_flops(b, t, c, kernel_size))
    return y


class SnakeKernelFunction(torch.autograd.Function):
    """The kernel under autograd, as the JAX package's ``custom_vjp``
    around its snake kernels (dex_tts_tpu/ops/snake.py:576-597): the
    forward is one launch; the backward recomputes the plain version with
    the exact sine (``fast_sin=False``, even after the polynomial forward)
    on the saved inputs and differentiates it. The backward launches no
    kernel."""

    @staticmethod
    def forward(ctx, x, alpha, inv_beta, kernel_size: int, fast_sin: bool):
        ctx.save_for_backward(x, alpha, inv_beta)
        ctx.kernel_size = kernel_size
        return _launch(x, alpha, inv_beta, kernel_size, fast_sin)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [v.detach().requires_grad_(w) for v, w in zip(saved, wanted)]
            y = snake_antialias_reference(*inputs, ctx.kernel_size, fast_sin=False)
            grads = iter(torch.autograd.grad(y, [v for v, w in zip(inputs, wanted) if w], dy))
        return (*(next(grads) if w else None for w in wanted), None, None)


def per_channel(value, x) -> torch.Tensor:
    """``value`` (a tensor or number broadcastable to (C,)) as a contiguous
    (C,) tensor in x's dtype on x's device; differentiable, so a
    parameter's graph (BigVGAN's ``exp`` of its logscale alpha) reaches
    through it."""
    return torch.as_tensor(value, device=x.device).to(x.dtype).broadcast_to(
        (x.shape[-1],)).contiguous()


def snake_antialias(
    x,
    alpha,
    inv_beta,
    use_pallas: bool = False,
    kernel_size: int = 12,
    impl: str | None = None,
    fast_sin: bool | None = None,
):
    """2× anti-aliased snake. x: (B, T, C), any strides; alpha/inv_beta
    broadcastable to (C,). Returns (B, T, C) in x's dtype.

    ``impl`` and ``use_pallas`` chose among TPU lowerings of this one
    function in the JAX package; here they only decide, as there,
    whether sin² is the polynomial (``fast_sin=None``: bf16 x and impl
    "auto", "fold" or "foldb"). CPU tensors take the plain version; CUDA
    tensors launch the kernel for every impl (on the current stream, no
    synchronisation; the output keeps the strides of a dense x) or
    raise. Where grad is enabled and an input requires it, the launch
    goes through `SnakeKernelFunction` (backward: the plain version)."""
    if impl is None:
        impl = "pallas" if use_pallas else "polyphase"
    if impl not in IMPLS:
        raise ValueError(f"unknown snake impl {impl!r}; expected one of {IMPLS}")
    if fast_sin is None:
        fast_sin = x.dtype == torch.bfloat16 and impl in FAST_SIN_IMPLS
    alpha, inv_beta = per_channel(alpha, x), per_channel(inv_beta, x)
    if x.device.type == "cpu":
        return snake_antialias_reference(x, alpha, inv_beta, kernel_size, fast_sin)
    if x.device.type != "cuda":
        raise ValueError(f"no snake_antialias for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad
                                    or inv_beta.requires_grad):
        return SnakeKernelFunction.apply(x, alpha, inv_beta, kernel_size, bool(fast_sin))
    return _launch(x, alpha, inv_beta, kernel_size, fast_sin)


snake_antialias.launches = 0
