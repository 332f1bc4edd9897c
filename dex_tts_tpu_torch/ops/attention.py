"""Exact non-causal attention for the DiT: the Hopper kernel
(`csrc/flash_attention.cu`) and its plain PyTorch version.

Replaces the TPU kernels reached from dex_tts_tpu/models/dit.py
MHSA._flash (library Pallas flash attention) and MHSA._splash.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 128


def attention_reference(q, k, v, scale: float, dtype=None):
    """Plain version: the JAX MHSA einsum branch (dit.py:356-362). q, k, v
    (B, T, H, hd); f32 scores and softmax, weights cast to ``dtype``,
    f32-accumulated P·V, result in ``dtype`` (default q.dtype)."""
    dtype = dtype or q.dtype
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    weights = scores.softmax(dim=-1).to(dtype)
    return torch.einsum("bhts,bshd->bthd", weights.float(), v.float()).to(dtype)


def _check(q, k, v):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"flash_attention takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, T, H, hd) alike, got {q.shape}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}, got {q.shape[-1]}")
    vec = 16 // q.element_size()  # elements per 16-byte vector load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"{name} must be 16-byte aligned in every stride")


@functools.cache
def _kernel():
    from dex_tts_tpu_torch.ops.kernels import load_library

    fn = load_library("flash_attention.cu").flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, scale: float):
    """softmax(q·kᵀ·scale)·v per (batch, head); q, k, v (B, T, H, 128),
    bf16 or f32, last dimension contiguous (other strides free). Returns a
    contiguous (B, T, H, 128) tensor of q's dtype.

    CPU tensors take the plain version (any head_dim); CUDA tensors launch
    the kernel (on the current stream, no synchronisation) or raise."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, q.dtype).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    _check(q, k, v)
    b, t, h, hd = q.shape
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):  # the C launcher uses the current device
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, t, h, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
