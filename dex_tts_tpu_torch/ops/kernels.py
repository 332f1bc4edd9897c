"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled by ``nvcc`` for Hopper (sm_90a) into a shared
library with a plain C interface, loaded with ctypes. Libraries go to
``build/kernels/`` at the repository root, named by a hash of the source,
so a changed source rebuilds and an unchanged one is reused; nvcc's
report (ptxas's registers, spills and shared memory per kernel) is kept
beside the library. Nothing is built at import time: the first launch
builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from dex_tts_tpu_torch.utils.device import resolve_device

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("flash_attention.cu", "snake.cu", "mas.cu")


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all(sources=SOURCES) -> dict[str, Path]:
    """Compile each of ``csrc/<source>`` whose hashed library is missing,
    one nvcc process per source, all started together; return the
    library paths. A failed compile raises with nvcc's stderr."""
    outs = {s: _library_path(s) for s in sources}
    running = {}
    for source, out in outs.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running[source] = (proc, tmp)
    errors = []
    for source, (proc, tmp) in running.items():
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {source}:\n{stderr}")
        else:
            outs[source].with_suffix(".log").write_text(stderr)
            os.replace(tmp, outs[source])  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def resource_usage(source: str) -> list[str]:
    """ptxas's report of each kernel in the built ``csrc/<source>``, one
    line per kernel: "<mangled name>: <stack and spills>; <registers,
    barriers, constant memory>" (empty if the build left no report)."""
    log = _library_path(source).with_suffix(".log")
    usage, name = {}, None
    for line in (log.read_text().splitlines() if log.exists() else []):
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
            usage[name] = []
        elif name and ("spill" in line or "Used" in line):
            usage[name].append(line.split(" : ", 1)[-1].strip())
    return [f"{n}: {'; '.join(v)}" for n, v in usage.items()]


def build(source: str) -> Path:
    """The library of ``csrc/<source>``, compiled unless it exists."""
    return build_all((source,))[source]


@functools.cache
def _load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))


def load_library(source: str, device=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use. Needs a
    CUDA device: with none given and no card visible it raises."""
    if resolve_device(device).type != "cuda":
        raise RuntimeError(f"{source} is a CUDA kernel; it needs a CUDA device")
    return _load(source)
