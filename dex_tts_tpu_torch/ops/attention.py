"""Exact non-causal attention for the DiT: the Hopper kernels
(`csrc/flash_attention.cu`: the forward and the backward) and their plain
PyTorch versions.

Replaces the TPU kernels reached from dex_tts_tpu/models/dit.py
MHSA._flash (library Pallas flash attention, forward and, in a train
step, its _flash_attention_bwd_dkv and _flash_attention_bwd_dq) and
MHSA._splash. `flash_attention_qkv` is what the DiT calls: with grad
enabled on CUDA it is a `torch.autograd.Function` whose forward saves the
f32 log-sum-exp and whose backward launches the backward; on the CPU
autograd runs through the plain forward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dex_tts_tpu_torch.utils.mfu import note_kernel_flops

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


def attention_reference_lse(q, k, v, scale: float):
    """The plain forward with its log-sum-exp: (o in q's dtype, lse (B, H,
    T) f32, natural log of Σ_s exp(q·k_s·scale))."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.exp(scores - lse[..., None]).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", weights.float(), v.float()).to(q.dtype)
    return out, lse


def attention_bwd_reference(q, k, v, o, lse, do, scale: float):
    """Plain backward of `attention_reference` from the saved f32
    log-sum-exp (B, H, T), as the library kernels compute it: P recomputed
    as exp(S·scale − lse), D = rowsum(dO∘O) and dS = P∘(dP − D) in f32; P
    rounded to the input dtype for dV = Pᵀ·dO, dS rounded to it for dK =
    scale·dSᵀ·Q and dQ = scale·dS·K, the scale applied to the f32 sums.
    q, k, v, o, do (B, T, H, hd) → (dq, dk, dv) in q's dtype."""
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.einsum("bthd,bshd->bhts", qf, kf) * scale - lse[..., None])
    dv = torch.einsum("bhts,bthd->bshd", p.to(dt).float(), dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    delta = attention_delta(o, do)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * scale
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_flops(b: int, t: int, h: int, hd: int) -> int:
    """FLOPs of one forward by the port's convention (utils/mfu.py): the
    products S = Q·Kᵀ and O = P·V, 2·B·H·T²·hd each. A backward counts
    twice this (dV, dP, dQ, dK), as autograd through the plain version
    does."""
    return 4 * b * h * t * t * hd


def attention_delta(o, do):
    """D = rowsum(dO∘O) in f32, (B, T, H, hd) → (B, H, T): a plain
    reduction, as the library computes it in XLA outside its kernels."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


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


def tensor_map_layout(x):
    """The 4-D tensor map the kernel reads a (B, T, H, hd) view through:
    its dims innermost first, (hd, H, T, B), and the byte strides of the
    H, T and B dims (the innermost is contiguous). Every entry point passes
    these byte strides; the f32 kernels divide them back into elements."""
    b, t, h, hd = x.shape
    e = x.element_size()
    return (hd, h, t, b), (x.stride(2) * e, x.stride(1) * e, x.stride(0) * e)


def _strides(*tensors):
    strides = [s for x in tensors for s in tensor_map_layout(x)[1]]
    return (ctypes.c_longlong * len(strides))(*strides)


@functools.cache
def _kernel():
    from dex_tts_tpu_torch.ops.kernels import load_library

    lib = load_library("flash_attention.cu")
    fwd = lib.flash_attention_fwd
    fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    )
    bwd = lib.flash_attention_bwd
    bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    )
    for fn in (fwd, bwd):
        fn.restype = ctypes.c_int
    return fwd, bwd


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention(q, k, v, scale: float, with_lse: bool = False):
    """softmax(q·kᵀ·scale)·v per (batch, head); q, k, v (B, T, H, 128),
    bf16 or f32, last dimension contiguous (other strides free). Returns a
    contiguous (B, T, H, 128) tensor of q's dtype, and with ``with_lse``
    also the f32 (B, H, T) log-sum-exp.

    CPU tensors take the plain version (any head_dim); CUDA tensors launch
    the kernel (on the current stream, no synchronisation) or raise: bf16
    on the tensor cores in bf16, f32 on them in 3xTF32 (f32 accuracy)."""
    if q.device.type == "cpu":
        if with_lse:
            out, lse = attention_reference_lse(q, k, v, scale)
            return out.contiguous(), lse
        return attention_reference(q, k, v, scale, q.dtype).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    _check(q, k, v)
    b, t, h, hd = q.shape
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    split = None
    if q.dtype == torch.float32:
        # the f32 kernel's pre-pass splits K and V into TF32 halves here:
        # four (B, H, ⌈T/32⌉·32, hd) planes of 32-bit values
        split = torch.empty((4, b, h, -(-t // 32) * 32, hd), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):  # the C launcher uses the current device
        err = _kernel()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), 0 if split is None else split.data_ptr(),
            _DTYPE_CODE[q.dtype], b, t, h, hd, _strides(q, k, v), float(scale), _stream(q),
        )
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_dtype[q.dtype] += 1
    note_kernel_flops(out, attention_flops(b, t, h, hd))
    return (out, lse) if with_lse else out


flash_attention.launches = 0  # all launches; by input dtype below
flash_attention.launches_by_dtype = dict.fromkeys(_DTYPE_CODE, 0)


def _check_bwd(q, k, v, do, lse, delta, dq, dk, dv):
    _check(q, k, v)
    _check(do, dq, dk)
    _check(do, dq, dv)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be q's shape and dtype, got {do.shape} {do.dtype}")
    b, t, h, _ = q.shape
    for name, a in (("lse", lse), ("delta", delta)):
        if a.dtype != torch.float32 or a.shape != (b, h, t) or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 (B, H, T) tensor")


def flash_attention_bwd(q, k, v, do, lse, delta, dq, dk, dv, scale: float):
    """The backward: writes dq = scale·dS·K, dk = scale·dSᵀ·Q and dv =
    Pᵀ·dO into ``dq``, ``dk``, ``dv`` ((B, T, H, 128) views of q's dtype).
    lse and delta f32 (B, H, T). bf16 launches the one-pass kernel, which
    sums dQ over 128-key blocks into a zeroed f32 accumulator by bulk
    reduce-adds (in an order that changes from run to run), and its
    convert kernel; f32 a pre-pass that splits K, V, Q and dO into TF32
    halves, then the dQ and dK/dV kernels (3xTF32 on the tensor cores, no
    atomics: the same inputs give the same bits). One call counts one
    launch. CUDA tensors only: the plain version is
    `attention_bwd_reference`."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd is a CUDA kernel, got {q.device}")
    _check_bwd(q, k, v, do, lse, delta, dq, dk, dv)
    b, t, h, hd = q.shape
    if q.dtype == torch.bfloat16:
        t_pad = -(-t // 64) * 64
        scratch = torch.zeros((b, h, t_pad, hd), dtype=torch.float32, device=q.device)
    else:
        # the f32 pre-pass splits K, V, Q and dO into TF32 halves here:
        # eight (B, H, ⌈T/32⌉·32, hd) planes of 32-bit values
        scratch = torch.empty((8, b, h, -(-t // 32) * 32, hd), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr(), _DTYPE_CODE[q.dtype], b, t, h, hd,
            _strides(q, k, v, do, dq, dk, dv), float(scale), _stream(q),
        )
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    note_kernel_flops(dq, 2 * attention_flops(b, t, h, hd))


flash_attention_bwd.launches = 0


class FlashAttentionQKV(torch.autograd.Function):
    """Differentiable K1 on the DiT's one (B, T, 3, H, hd) projection: the
    forward kernel with its log-sum-exp, saving qkv, o and the f32 lse; the
    backward launches `flash_attention_bwd`, which writes into one
    (B, T, 3, H, hd) gradient buffer."""

    @staticmethod
    def forward(ctx, qkv, scale):
        out, lse = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], scale, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        do = do.to(qkv.dtype).contiguous()
        delta = attention_delta(out, do)
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        flash_attention_bwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do, lse, delta,
                            dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2], ctx.scale)
        return dqkv, None


def flash_attention_qkv(qkv, scale: float):
    """Attention over the DiT's (B, T, 3, H, hd) projection → (B, T, H, hd)
    in qkv's dtype. CPU: the plain version, differentiated by autograd.
    CUDA: the kernel; through `FlashAttentionQKV` when grad is enabled."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if qkv.device.type == "cuda" and torch.is_grad_enabled() and qkv.requires_grad:
        return FlashAttentionQKV.apply(qkv, scale)
    return flash_attention(q, k, v, scale)
