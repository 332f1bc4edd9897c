"""Training-throughput benchmark of the port: the DeX-TTS train step at the
ESD preset on one card (counterpart of the repo's bench_train.py).

    python -m dex_tts_tpu_torch.bench_train [--batch 32] [--frames 256]
        [--steps 20] [--dtype float32] [--attention flash_bf16] [--profile DIR]
        [--device cuda]

Prints ONE JSON line with bench_train.py's keys, plus ``peak_mem_gib``,
``card`` and the kernel launches of the timed steps: one warm-up step, then ``--steps`` steps through
`make_train_step` and one host read at the end, on bench_train.py's
synthetic batch. After them, ``--profile DIR`` traces 3 steps into DIR
(`utils.profiling.trace`), and one more step is counted (`utils.mfu`:
the forward's and the backward's matrix products and convolutions; the
clip, Adam and EMA updates are elementwise and count 0):
``tflops_per_step`` and, on a card with a known peak, ``mfu`` and
``peak_tflops``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from dex_tts_tpu_torch.config import build_model, load_preset
from dex_tts_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
from dex_tts_tpu_torch.ops.mas import maximum_path
from dex_tts_tpu_torch.train import create_train_state, make_train_step
from dex_tts_tpu_torch.train.trainer import metrics_to_host
from dex_tts_tpu_torch.utils.device import card_line, resolve_device
from dex_tts_tpu_torch.utils.mfu import count_flops, mfu, peak_flops_per_chip
from dex_tts_tpu_torch.utils.profiling import trace


def synthetic_batch(b: int = 32, frames: int = 256, n_feats: int = 80, tx: int = 96) -> dict:
    """bench_train.py's synthetic batch (`bench_train.synthetic_batch`):
    one seed, every item full length; ref, sty and y share the mel."""
    rng = np.random.default_rng(0)
    lens = np.full((b,), frames, np.int32)
    mel = rng.standard_normal((b, n_feats, frames)).astype(np.float32)
    return {"x": rng.integers(1, 148, (b, tx)).astype(np.int32),
            "x_lengths": np.full((b,), tx, np.int32), "y": mel, "y_lengths": lens,
            "ref": mel, "ref_lengths": lens, "sty": mel, "sty_lengths": lens,
            "lf0": rng.standard_normal((b, frames)).astype(np.float32), "lf0_lengths": lens}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="denoiser compute dtype")
    p.add_argument("--attention", default=None, help="DiT attention override (e.g. flash_bf16)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace 3 steps after the timed ones into DIR (torch.profiler, Chrome"
                        " trace)")
    p.add_argument("--device", default="cuda", help="'cpu' runs on the CPU (no card numbers)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def main(argv=None) -> dict:
    """Run the bench; print its JSON line and return it as a dict."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    preset = load_preset("esd")
    dit = preset.model.dit
    if args.attention:
        dit = dataclasses.replace(dit, attention=args.attention)
    cfg = dataclasses.replace(preset.model, compute_dtype=args.dtype, dit=dit)
    out_size = preset.out_size()
    torch.manual_seed(0)
    state = create_train_state(build_model(cfg, device=device), seed=100, lr=preset.train.lr,
                               max_grad=preset.train.max_grad)
    step = make_train_step(out_size=out_size, ema_decay=preset.train.ema_decay)
    batch = synthetic_batch(args.batch, args.frames, n_feats=cfg.n_feats)

    metrics_to_host(step(state, batch))  # warm-up
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    counters = (flash_attention, flash_attention_bwd, maximum_path)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = step(state, batch)
    total = metrics_to_host(metrics)["total_loss"]  # the one host read
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    steps_per_sec = args.steps / elapsed
    peak_mem = torch.cuda.max_memory_allocated(device) / 2**30 if on_card else None
    if args.profile:
        with trace(args.profile):
            for _ in range(3):
                metrics = step(state, batch)
            metrics_to_host(metrics)
    flops_step = count_flops(lambda: metrics_to_host(step(state, batch)))
    peak = peak_flops_per_chip(device)
    line = {
        "metric": (
            f"DeX-TTS ESD train step throughput (batch {args.batch}, {args.frames}-frame bucket,"
            f" out_size {out_size})"
        ),
        "value": round(steps_per_sec, 4),
        "unit": "steps/s",
        "items_per_sec": round(steps_per_sec * args.batch, 2),
        "final_loss": round(total, 4),
        "n_devices": 1,  # the step runs on one device
        "compute_dtype": args.dtype,
        "tflops_per_step": flops_step / 1e12,
        "mfu": mfu(flops_step, elapsed / args.steps, device),
        "peak_tflops": peak / 1e12 if peak else None,
        "peak_mem_gib": peak_mem,
        "device": device.type,
        "card": card_line() if on_card else None,
        "launches": launches,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
