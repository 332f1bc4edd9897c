#!/usr/bin/env python3
"""Where the time of the f32 flash-attention forward goes, on the card.

    python3 scripts/ab_flash_f32.py

Builds `dex_tts_tpu_torch/csrc/flash_attention.cu` as it stands and three
variants of it, each into its own library under `build/ab_flash_f32/`:
  - "no P·V": the tile loop skips O += P·V;
  - "no S": the tile loop skips S = Q·Kᵀ (the scores are a copy of Q);
  - "pre-pass only": the main kernel is not launched, only the K/V split.
The variants' outputs are wrong and only the full kernel's is checked
(against the plain f32 attention, atol 1e-4). Each is timed with CUDA events
at the synthesis shape (16, 3840, 2, 128) in turns (in order, then reversed,
twice), beside SDPA's f32 call. Full minus "no P·V" is the time of P·V, full
minus "no S" that of S; the rest is the softmax, the splits of Q and P, the
loads, the barriers and the pre-pass. Prints the ptxas line of each build and
the card's name and power limit. Needs one card and nvcc.
"""

import ctypes
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dex_tts_tpu_torch.ops import kernels  # noqa: E402
from dex_tts_tpu_torch.ops.attention import _strides, attention_reference  # noqa: E402

SHAPE = (16, 3840, 2, 128)
OUT = os.path.join(os.path.dirname(kernels.BUILD_DIR), "ab_flash_f32")


def variants(src: str) -> dict[str, str]:
    def cut(old: str, new: str) -> str:
        assert src.count(old) == 1, old
        return src.replace(old, new)

    return {
        "full": src,
        "no P·V": cut("    f32_pv(acc, sc, stage, g, tq);\n", "    acc[0] += sc[0] + sc[15];\n"),
        "no S": cut("    f32_scores(sc, qr, stage, g, tq);\n",
                    "    for (int i = 0; i < 16; ++i) sc[i] = qr[i % 8][0][i % 4];\n"),
        "pre-pass only": cut("    kernel<<<dim3((T + kF32TileQ - 1) / kF32TileQ, B * H), kF32Threads,",
                             "    if (false) kernel<<<dim3((T + kF32TileQ - 1) / kF32TileQ, B * H),"
                             " kF32Threads,"),
    }


def build(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        path = os.path.join(OUT, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), path[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{err}")
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "flash_fwd_f32ILb0" in line:
                print(f"ptxas {name}: {lines[i + 2].strip()}; {lines[i + 3].strip()}")
        fn = ctypes.CDLL(so).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("ab_flash_f32: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    with open(kernels.CSRC / "flash_attention.cu") as f:
        libs = build(variants(f.read()))
    b, t, h, hd = SHAPE
    q, k, v = chip_smoke.qkv_views(*SHAPE, torch.float32, seed=0)
    out = torch.empty(SHAPE, device="cuda")
    split = torch.empty((4, b, h, -(-t // 32) * 32, hd), dtype=torch.int32, device="cuda")

    def run(fn):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, split.data_ptr(), 0,
                 b, t, h, hd, _strides(q, k, v), hd**-0.5, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    run(libs["full"])
    err = (out - attention_reference(q, k, v, hd**-0.5)).abs().max().item()
    print(f"full kernel at {SHAPE}: max_abs_err {err:.3e} against the plain version (bound 1e-4)")
    assert err <= 1e-4, err
    times = {name: [] for name in libs}
    for _ in range(2):
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(chip_smoke.time_ms(lambda: run(libs[name]), 10))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa_ms = chip_smoke.time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=hd**-0.5), 10)
    for name, ts in times.items():
        print(f"{name} at {SHAPE}: " + " ".join(f"{x:.4f}" for x in ts)
              + f" ms, median {statistics.median(ts):.4f} [{card}]")
    print(f"sdpa f32 at {SHAPE}: {sdpa_ms:.4f} ms [{card}]")


if __name__ == "__main__":
    main()
