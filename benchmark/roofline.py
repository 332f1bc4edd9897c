"""The yardstick's peaks and least-time arithmetic (copies of the
roofline, attention and snake bounds of the repository's chip smoke
test).

NVIDIA H100 SXM data-sheet peaks, dense: 989 TFLOP/s bf16 on the tensor
cores, 495 TFLOP/s TF32 (a product at float32 accuracy takes three:
3xTF32), 67 TFLOP/s float32 FMA on the CUDA cores, 3.35 TB/s of HBM.
`MFU_PEAK_FLOPS` (989.4 TFLOP/s) is the bf16 rate the model FLOP
utilisation is taken against.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
MFU_PEAK_FLOPS = 989.4e12
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def roofline_ms(n_bytes: float, ops: float, dtype: str) -> float:
    """Least time in ms for ``ops`` operations of matrix products in
    ``dtype`` over ``n_bytes`` moved: bf16 on the tensor cores; float32
    at the faster of FMA on the CUDA cores and 3xTF32."""
    t_bytes = n_bytes / PEAK_BYTES
    if dtype != "float32":
        t_ops = ops / PEAK_FLOPS[dtype]
    else:
        t_ops = min(3 * ops / PEAK_TF32_FLOPS, ops / PEAK_FLOPS["float32"])
    return max(t_bytes, t_ops) * 1e3


def attention_bound_ms(b: int, t: int, h: int, hd: int, dtype: str) -> float:
    """Exact attention over (B, T, H, hd): q, k and v read once and o
    written once, against 4·B·H·T²·hd operations."""
    n_bytes = 4 * b * t * h * hd * ELEMENT_BYTES[dtype]
    return roofline_ms(n_bytes, 4 * b * h * t * t * hd, dtype)


def snake_bound_ms(b: int, t: int, c: int, dtype: str, k: int = 12) -> float:
    """Least time of one 2× anti-aliased snake over (B, T, C): x read
    once and y written once at the memory rate, against (4k + 46) float32
    operations per output sample at the float32 CUDA-core peak (2k
    filter FMAs of the two upsample phases and the two-phase downsample,
    and two snake evaluations of 23 operations each); the larger of the
    two."""
    n = b * t * c
    t_bytes = 2 * n * ELEMENT_BYTES[dtype] / PEAK_BYTES
    t_ops = n * (4 * k + 46) / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3
