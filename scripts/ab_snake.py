#!/usr/bin/env python3
"""The anti-aliased snake kernel on the card: versions side by side, and
its SASS instruction mix.

    python3 scripts/ab_snake.py [--earlier SRC] [--sass] [--sass-out DIR]
                                [--clock]

Builds `dex_tts_tpu_torch/csrc/snake.cu` as it stands ("current") with
`ops.kernels.NVCC_FLAGS`, and each other version into its own library
under `build/ab_snake/`: --earlier SRC is another version of the source,
e.g. the parent commit's (`git show <commit>:dex_tts_tpu_torch/csrc/snake.cu`).
Each library is held against the plain version at stage 1's shape and a
ragged shape (bf16 within 8e-3 × max|y|, f32 within 2e-5), then all are
timed with CUDA events at BigVGAN's six stage shapes of request 1, bf16
(polynomial sin²) and f32 (exact sine), in turns (in order, then
reversed, twice): each stage's ms, its bound and the share of it, and
one generator call (Σ ms × launches at the stage), with each build's
ptxas lines. --sass prints the instruction mix of the bf16 k = 12 kernel
from `cuobjdump -sass` of each library (whole kernel; per output sample,
the loop the branch-free chunks run), --sass-out keeps its text. --clock
samples the SM clock and power draw (nvidia-smi) while the current
kernel runs back to back. Prints the card's name and power limit. Needs
one card, nvcc and cuobjdump.
"""

import argparse
import collections
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
from dex_tts_tpu_torch.ops import snake as sk  # noqa: E402

OUT = os.path.join(os.path.dirname(kernels.BUILD_DIR), "ab_snake")
DTYPES = ((torch.bfloat16, "auto", True), (torch.float32, "pallas", False))


def build(srcs: dict[str, str]) -> dict[str, tuple[ctypes.CDLL, str, str]]:
    """name → (library, path, nvcc's report); one nvcc each, together."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        # one file per version: the loader would hand back a library already
        # loaded from the same path
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{err}")
        libs[name] = (sk._bind(ctypes.CDLL(so)), so, err)
    return libs


def run(fn, x, al, ib, k=12, fast=True):
    """One launch of a library's entry point, as `ops.snake` makes it."""
    y = torch.empty_like(x)
    b, t, c = x.shape
    err = fn(x.data_ptr(), al.data_ptr(), ib.data_ptr(), y.data_ptr(), sk._DTYPE_CODE[x.dtype],
             k, int(fast), b, t, c, *x.stride(), *y.stride(),
             ctypes.addressof(sk._filter_array(k)), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return y


def check(libs):
    for name, (fn, _, _) in libs.items():
        for dtype, _, fast in DTYPES:
            for shape in (chip_smoke.SNAKE_STAGES[1], (2, 4097, 3)):
                x, al, ib = chip_smoke.snake_inputs(*shape, dtype, seed=3)
                got = run(fn, x, al, ib, fast=fast)
                want = sk.snake_antialias_reference(x, al, ib, 12, fast)
                err = (got.float() - want.float()).abs().max().item()
                bound = (8e-3 * want.float().abs().max().item() if dtype == torch.bfloat16
                         else 2e-5)
                print(f"{name} {dtype} {shape}: max_abs_err {err:.3e} (bound {bound:.3e})")
                assert err <= bound, (name, dtype, shape, err)


def timings(libs, iters=20):
    names = list(libs)
    order = names + names[::-1]
    for dtype, _, fast in DTYPES:
        per_call = collections.defaultdict(float)
        for shape, n in zip(chip_smoke.SNAKE_STAGES, chip_smoke.SNAKE_STAGE_LAUNCHES):
            x, al, ib = chip_smoke.snake_inputs(*shape, dtype, seed=0)
            ms = collections.defaultdict(list)
            for name in order * 2:
                fn = libs[name][0]
                ms[name].append(chip_smoke.time_ms(lambda: run(fn, x, al, ib, fast=fast), iters))
            bound = max(chip_smoke.snake_bound_ms(*shape, dtype))
            for name in names:
                med = statistics.median(ms[name])
                per_call[name] += med * n
                print(f"{dtype} {shape} {name}: {med:.4f} ms (runs {min(ms[name]):.4f}-"
                      f"{max(ms[name]):.4f}), bound {bound:.4f} ms, {100 * bound / med:.1f}%"
                      " of the bound")
        for name in names:
            print(f"{dtype} one generator call ({chip_smoke.SNAKE_LAUNCHES} launches) {name}:"
                  f" {per_call[name]:.3f} ms")


CLASSES = (("FFMA", r"FFMA"), ("FMUL", r"FMUL"), ("FADD", r"FADD"), ("FRND", r"FRND"),
           ("FSEL/FSETP/FMNMX", r"FSEL|FSETP|FMNMX"), ("SHFL", r"SHFL"),
           ("control", r"BRA|BSSY|BSYNC|EXIT|WARPSYNC|NOP|BAR|DEPBAR|LDGDEPBAR"),
           ("LDGSTS", r"LDGSTS"), ("LDG", r"LDG"), ("STG", r"STG"), ("LDS/STS", r"LDS|STS"),
           ("MUFU", r"MUFU"), ("conversion", r"F2F|F2I|I2F"), ("PRMT/LOP3/SHF", r"PRMT|LOP3|SHF"),
           ("integer", r"IMAD|IADD3|LEA|ISETP|IABS|SEL|VIADD|VIMNMX"), ("MOV", r"MOV"))


def sass_mix(so: str, out_dir=None):
    """The instruction mix of the bf16 k = 12 polynomial-sine kernel in the
    library `so`: the whole kernel's, and per output sample that of its
    branch-free loop (the conditional backward branch around the cp.async
    copies, LDGSTS; one 16-byte store per lane and step is RUN outputs)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s+Function : ", text)
    body = next(f for f in funcs if re.match(r"\S*snake_fwdI13__nv_bfloat16Li12ELb1E", f))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, os.path.basename(so) + ".sass"), "w") as f:
            f.write(body)
    ins = []
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body):
        ins.append((int(m.group(1), 16), m.group(2), m.group(3), m.group(4)))
    total = collections.Counter(op.split(".")[0] for _, _, op, _ in ins)
    print(f"  SASS of {so}, bf16 k=12 kernel: {len(ins)} instructions; "
          + ", ".join(f"{k} {v}" for k, v in total.most_common(16)))
    loops = []
    for addr, pred, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and pred and t and int(t.group(1), 16) < addr:
            region = [op for a, _, op, _ in ins if int(t.group(1), 16) <= a <= addr]
            if any(op.startswith("LDGSTS") for op in region):
                loops.append((len(region), int(t.group(1), 16), addr, region))
    if not loops:
        return
    _, lo, hi, region = min(loops)  # the innermost such loop
    steps = max(1, sum(1 for op in region if op.startswith("STG") and ".128" in op))
    samples = steps * sk.RUN
    counts = collections.Counter()
    for op in region:
        for name, pat in CLASSES:
            if re.match(pat, op):
                counts[name] += 1
                break
        else:
            counts["other"] += 1
    print(f"  branch-free loop {hex(lo)}-{hex(hi)}: {len(region)} instructions, {steps} chunk"
          " step(s); per output sample: " + ", ".join(
              f"{name} {counts[name] / samples:.2f}" for name, _ in CLASSES + (("other", ""),)
              if counts[name]) + f"; all {len(region) / samples:.2f}")


def clocks(fn, seconds=3.0):
    """The SM clock and power draw while `fn` (bf16, the last stage shape)
    runs back to back for about `seconds`: nvidia-smi sampled every 100 ms."""
    x, al, ib = chip_smoke.snake_inputs(*chip_smoke.SNAKE_STAGES[-1], torch.bfloat16, seed=0)
    ms = chip_smoke.time_ms(lambda: run(fn, x, al, ib), 20)
    n = int(seconds * 1e3 / ms)
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        chip_smoke.time_ms(lambda: run(fn, x, al, ib), n, warmup=0)
    finally:
        smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines() if "," in line]
    mhz = sorted(float(r[0]) for r in rows)
    watts = sorted(float(r[1]) for r in rows)
    print(f"bf16 {chip_smoke.SNAKE_STAGES[-1]} back to back for {n} launches ({ms:.4f} ms each):"
          f" SM clock median {mhz[len(mhz) // 2]:.0f} MHz ({mhz[0]:.0f}-{mhz[-1]:.0f}),"
          f" power median {watts[len(watts) // 2]:.1f} W, {len(rows)} samples")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sass-out", help="directory for each library's bf16 k=12 SASS")
    ap.add_argument("--clock", action="store_true", help="the SM clock under the current kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_snake: CUDA is not available")
    with open(kernels.CSRC / "snake.cu") as f:
        src = f.read()
    srcs = {"current": src}
    if args.earlier:
        with open(args.earlier) as f:
            srcs["earlier"] = f.read()
    print(f"card: {chip_smoke.card_line()}")
    libs = build(srcs)
    for name, (_, so, report) in libs.items():
        func = None
        for line in report.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                func = m.group(1)
            elif func and ("registers" in line or "spill" in line):
                inst = re.search(r"snake_fwdI(13__nv_bfloat16|f)Li(\d+)ELb(\d)", func)
                label = (f"{'bf16' if inst.group(1) != 'f' else 'f32'} k={inst.group(2)}"
                         f" {'poly' if inst.group(3) == '1' else 'sinf'}")
                print(f"ptxas {name} {label}: {line.split(' : ', 1)[-1].strip()}")
        if args.sass:
            sass_mix(so, args.sass_out)
    check(libs)
    timings(libs)
    if args.clock:
        clocks(libs["current"][0])
    print(f"card: {chip_smoke.card_line()}")


if __name__ == "__main__":
    main()
