"""The U-Net Block's epilogue, GroupNorm → affine → Mish → mask (→ time
shift): the Hopper kernel K5 (`csrc/group_norm.cu`) and its plain PyTorch
version.

K5 replaces no TPU kernel: the JAX package leaves GroupNorm and Mish to
XLA, which fuses them. The plain version here is what `models/unet.Block`
runs after its convolution off the card: f32 per-group statistics, then
the normalisation, the affine, Mish and the mask as separate passes in
the compute dtype, about 11 full-size passes on the card. K5 makes two:
the per-chunk f32 sums, then the epilogue with f32 arithmetic and one
rounding, over `two_pass_chunks` chunks a slab; it reads the
convolution's output twice and writes the result once.

`group_norm_mish` launches K5 only where all of these hold: every tensor
on one CUDA device, h bf16 or f32 and NCHW contiguous, f32 affine
parameters, and nothing autograd would record (grad enabled and an input
that requires it). Everything else (CPU tensors, training, other dtypes
or layouts) takes the plain version, so training, CPU inference and the
JAX-parity tests keep their numerics. Under tracing each call counts
``blocks_fused`` or ``blocks_plain`` on the innermost open span;
``group_norm_mish.launches`` counts kernel launches (two per call).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dex_tts_tpu_torch.utils import profiling

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' fixed parameters (csrc/group_norm.cu `kThreads`, `kMaxDynamic`)
THREADS = 512
MAX_DYNAMIC_SMEM = 49152
MAX_SLAB = 2**31 - 17  # elements of one (batch, group) slab: int indices
MAX_SLABS = 65535  # B·G: the grid's second dimension


def mish(x):
    """reference: DEX-TTS/model/diffusion.py:11-13."""
    return x * torch.tanh(F.softplus(x))


def group_norm(x, groups: int, weight, bias, eps: float):
    """GroupNorm over (B, C, H, W) with f32 per-group statistics, applied
    in x's dtype (torch semantics: eps inside rsqrt, per-channel affine)."""
    b, c, h, w = x.shape
    xg = x.reshape(b, groups, c // groups, h * w)
    xf = xg.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf**2).mean(dim=(2, 3), keepdim=True) - mean**2
    inv = torch.rsqrt(var + eps)
    out = (xg * inv.to(x.dtype) - (mean * inv).to(x.dtype)).reshape(b, c, h, w)
    if profiling.TRACING:
        profiling.count_casts(x.dtype, weight, bias)
    return out * weight.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


def group_norm_mish_reference(h, weight, bias, mask, shift=None, groups: int = 8,
                              eps: float = 1e-5):
    """Plain version: mish(group_norm(h))·mask (+ shift[:, :, None, None]),
    each step in h's dtype. mask (B, 1, 1, W), shift (B, C)."""
    out = mish(group_norm(h, groups, weight, bias, eps)) * mask.to(h.dtype)
    return out if shift is None else out + shift[:, :, None, None].to(h.dtype)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def head_bytes(cpg: int, w: int) -> int:
    """gn_apply's dynamic shared memory: the per-channel coefficients (cpg
    float4) and the mask row (W floats, padded to 4)."""
    return cpg * 16 + _ceil(w, 4) * 16


def vector_width(shape, dtype: torch.dtype) -> int:
    """Elements per 16-byte load: 16 / element size where H·W is a
    multiple of it (a load then lies in one channel), else 1."""
    v = 16 // dtype.itemsize
    return v if shape[2] * shape[3] % v == 0 else 1


def two_pass_chunks(slabs: int, packs: int, sms: int) -> int:
    """Chunks per slab of ``packs`` loads: enough for two CTAs per SM, at
    most 8 loads per thread in each, at least one."""
    chunks = max(_ceil(2 * sms, slabs), _ceil(packs, 8 * THREADS))
    return max(1, min(chunks, _ceil(packs, THREADS)))


def fusable(h, weight, bias, mask, shift=None, groups: int = 8) -> bool:
    """Whether `group_norm_mish` launches K5 for these inputs (module
    docstring)."""
    tensors = (h, weight, bias, mask) if shift is None else (h, weight, bias, mask, shift)
    if h.device.type != "cuda" or any(t.device != h.device for t in tensors):
        return False
    if h.dtype not in _DTYPE_CODE or h.dim() != 4 or not h.is_contiguous() or h.numel() == 0:
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    b, c, hh, w = h.shape
    if c % groups or b * groups > MAX_SLABS or c // groups * hh * w > MAX_SLAB:
        return False
    if head_bytes(c // groups, w) > MAX_DYNAMIC_SMEM:
        return False
    if any(p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous()
           for p in (weight, bias)):
        return False
    return mask.shape == (b, 1, 1, w) and (shift is None or shift.shape == (b, c))


def _bind(lib: ctypes.CDLL):
    """The C entry point of a built group_norm.cu, with its signature."""
    fn = lib.group_norm_mish_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    from dex_tts_tpu_torch.ops.kernels import load_library

    return _bind(load_library("group_norm.cu"))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(h, weight, bias, mask, shift, groups: int, eps: float):
    """K5 on h's card: y (B, C, H, W) in h's dtype."""
    b, c, hh, w = h.shape
    y = torch.empty_like(h)
    mask = mask.to(h.dtype)
    if shift is not None:
        shift = shift.float()
    vec = vector_width(h.shape, h.dtype) if h.data_ptr() % 16 == 0 else 1
    chunks = two_pass_chunks(b * groups, c // groups * hh * w // vec, _sms(h.device.index))
    partial = torch.empty(2 * b * groups * chunks, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):  # the C launcher uses the current device
        err = _kernel()(
            h.data_ptr(), weight.data_ptr(), bias.data_ptr(), mask.data_ptr(),
            mask.stride(0), mask.stride(3),
            None if shift is None else shift.data_ptr(),
            *((0, 0) if shift is None else shift.stride()),
            y.data_ptr(), partial.data_ptr(),
            _DTYPE_CODE[h.dtype], vec, b, c, hh, w, groups, eps, chunks,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"group_norm_mish launch failed: CUDA error {err}")
    group_norm_mish.launches += 2
    return y


def group_norm_mish(h, weight, bias, mask, shift=None, groups: int = 8, eps: float = 1e-5):
    """mish(GroupNorm(groups)(h)·weight + bias)·mask (+ shift), the U-Net
    Block's epilogue. h (B, C, H, W) in the compute dtype, weight and bias
    (C,), mask (B, 1, 1, W) of any strides, shift (B, C) or None. K5 where
    `fusable`, else the plain version (module docstring); either way the
    result is in h's dtype."""
    if not fusable(h, weight, bias, mask, shift, groups):
        if profiling.TRACING:
            profiling.count("blocks_plain", 1)
        return group_norm_mish_reference(h, weight, bias, mask, shift, groups, eps)
    if profiling.TRACING:
        profiling.count("blocks_fused", 1)
    return _launch(h, weight, bias, mask, shift, groups, eps)


group_norm_mish.launches = 0
