#!/usr/bin/env python3
"""Monotonic alignment search (K4) on the card: versions side by side.

    python3 scripts/ab_mas.py [--earlier SRC] [--variant NAME=SRC ...]
                              [--stub-backtrace] [--sass DIR] [--phases]

Builds `dex_tts_tpu_torch/csrc/mas.cu` as it stands ("current") with
`ops.kernels.NVCC_FLAGS`, and each other version into its own library
under `build/ab_mas/`: --earlier SRC is another version of the source,
e.g. the parent commit's (`git show <commit>:dex_tts_tpu_torch/csrc/mas.cu`),
--variant NAME=SRC any further one (not checked if NAME ends in
"-unchecked"). A source whose entry point takes a
`bits` scratch (the design before the warp route) is given a (B, Ty, Tx)
byte buffer. --stub-backtrace adds, for each source whose backtrace reads
its bits from device memory (the design before the warp route), a
text-substituted variant that reads none (its paths are wrong and not
checked): the time those reads cost. Every other
version's paths are held against the plain version (exact equality) at
bench_train's (32, 96, 256) and ESD's (32, 256, 1024); then all are timed
in turns (in order, then reversed, twice) by device time from
torch.profiler at both shapes, with each build's ptxas lines. --sass DIR
writes each library's SASS (`cuobjdump -sass`) there. --phases builds a
copy of the current source whose warp route stamps %globaltimer at the
ends of its phases (the lengths, the DP forward, the backtrace, the path's
ones) into the path's first words, and prints each phase's µs for some
blocks at both shapes, with the SM clock over the block. Prints the card's
name and power limit. Needs one card and nvcc.
"""

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dex_tts_tpu_torch.ops import kernels  # noqa: E402
from dex_tts_tpu_torch.ops import mas  # noqa: E402

OUT = os.path.join(os.path.dirname(kernels.BUILD_DIR), "ab_mas")
SHAPES = chip_smoke.MAS_SHAPES
# the backtrace's read of one bit from device memory, in the design before the warp route
STUB = "bb[static_cast<long long>(y) * Tx + index]"


def build(srcs: dict[str, str]) -> dict:
    """name → (entry point, takes a bits scratch, library path, nvcc's
    report); one nvcc each, started together."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), so, "void* bits" in src)
    libs = {}
    for name, (proc, so, with_bits) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(so).maximum_path_mas
        fn.argtypes = [ctypes.c_void_p] * (4 if with_bits else 3) + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (fn, with_bits, so, err)
    return libs


# --phases: (anchor in csrc/mas.cu, text put after it); each anchor must
# occur once
STAMPS = (
    ("// ---------------------------------------------------------------- warp route\n",
     "__device__ __forceinline__ long long stamp() {\n  long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n  return t;\n}\n'),
    ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n",
     "  const long long T0 = stamp(), C0 = clock64();\n  long long T2 = 0, T3 = 0;\n"),
    ("  const int tiles = (fy + F - 1) / F;\n", "  const long long T1 = stamp();\n"),
    ("    __syncwarp();  // lane 0's words are in shared memory\n", "    T2 = stamp();\n"),
    ("      i += at - 31;\n    }\n", "    T3 = stamp();\n"),
    ("      pb[at] = mb[at];\n    }\n  }\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) {\n    long long* o = reinterpret_cast<long long*>(pb);\n"
     "    o[0] = T0, o[1] = T1, o[2] = T2, o[3] = T3, o[4] = stamp(), o[5] = clock64() - C0;\n  }\n"),
)
PHASES = ("lengths", "forward", "backtrace", "zeros wait + ones")


def stamped(src: str) -> str:
    for anchor, text in STAMPS:
        assert src.count(anchor) == 1, f"--phases: anchor not found once: {anchor!r}"
        src = src.replace(anchor, anchor + text)
    return src


def phases(lib):
    for shape in SHAPES:
        value, mask = chip_smoke.mas_inputs(*shape, [shape[1:]] * shape[0], seed=1)
        for _ in range(3):
            path = run(lib, value, mask)
        torch.cuda.synchronize()
        st = path.view(shape[0], -1)[:, :12].contiguous().view(torch.int64).cpu().tolist()
        for b in (0, shape[0] // 2, shape[0] - 1):
            t = st[b]
            print(f"phases {shape} block {b}: " + ", ".join(
                f"{name} {(t[i + 1] - t[i]) / 1e3:.3f} us" for i, name in enumerate(PHASES))
                + f"; all {(t[4] - t[0]) / 1e3:.3f} us, SM clock {t[5] / (t[4] - t[0]):.3f} GHz")


def run(lib, value, mask):
    """One launch of a library's entry point, as `ops.mas` makes it."""
    fn, with_bits = lib[:2]
    b, t_x, t_y = value.shape
    path = torch.empty_like(value)
    ptrs = [value.data_ptr(), mask.data_ptr(), path.data_ptr()]
    if with_bits:
        ptrs.append(torch.empty((b, t_y, t_x), dtype=torch.uint8, device="cuda").data_ptr())
    err = fn(*ptrs, b, t_x, t_y, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=SRC")
    ap.add_argument("--stub-backtrace", action="store_true")
    ap.add_argument("--sass", metavar="DIR", help="write each library's SASS there")
    ap.add_argument("--phases", action="store_true", help="time the warp route's phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_mas: CUDA is not available")
    srcs = {"current": (kernels.CSRC / "mas.cu").read_text()}
    if args.earlier:
        with open(args.earlier) as f:
            srcs["earlier"] = f.read()
    for spec in args.variant:
        name, path = spec.split("=", 1)
        with open(path) as f:
            srcs[name] = f.read()
    unchecked = {name for name in srcs if name.endswith("-unchecked")}
    if args.stub_backtrace:
        for name in [n for n, src in srcs.items() if STUB in src and "mas_warp" not in src]:
            srcs[f"{name}-nobt"] = srcs[name].replace(STUB, "0", 1)
            unchecked.add(f"{name}-nobt")
    if args.phases:
        srcs["current-stamped"] = stamped(srcs["current"])
        unchecked.add("current-stamped")
    print(f"card: {chip_smoke.card_line()}")
    libs = build(srcs)
    for name, (_, _, so, report) in libs.items():
        func = None
        for line in report.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                k = re.search(r"(mas_(?:warp|wide|kernel))(?:ILi(\d+)E)?", m.group(1))
                func = k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
            elif func and ("registers" in line or "spill" in line):
                print(f"ptxas {name} {func}: {line.split(' : ', 1)[-1].strip()}")
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
            text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                                  check=True).stdout
            with open(os.path.join(args.sass, f"{name}.sass"), "w") as f:
                f.write(text)
    if args.phases:
        phases(libs.pop("current-stamped"))
    inputs = {}
    for shape in SHAPES:
        value, mask = chip_smoke.mas_inputs(*shape, [shape[1:]] * shape[0], seed=1)
        want = mas.maximum_path_scan(value, mask)
        inputs[shape] = (value, mask)
        for name, lib in libs.items():
            if name in unchecked:
                continue
            got = run(lib, value, mask)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, shape)
            print(f"{name} {shape}: paths equal the plain version's")
    names = list(libs)
    for shape, (value, mask) in inputs.items():
        ms = {name: [] for name in names}
        for name in (names + names[::-1]) * 2:
            dev = chip_smoke.kernel_device_ms(lambda: run(libs[name], value, mask), ("mas",))
            if dev["mas"] is not None:  # a trace that missed the kernel
                ms[name].append(dev["mas"])
        for name in names:
            if not ms[name]:
                print(f"{shape} {name}: no device time in any trace")
                continue
            med = statistics.median(ms[name])
            print(f"{shape} {name}: device {med:.4f} ms (runs {min(ms[name]):.4f}-"
                  f"{max(ms[name]):.4f}), {med / shape[2] * 1e6:.1f} ns per frame"
                  f"{' (paths not checked)' if name in unchecked else ''}")
    print(f"card: {chip_smoke.card_line()}")


if __name__ == "__main__":
    main()
