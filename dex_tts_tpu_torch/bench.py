"""Synthesis benchmark of the port: end-to-end text→WAV RTF on one card
(counterpart of the repo's bench.py, which measures the JAX package).

    python -m dex_tts_tpu_torch.bench [--vocoder hifigan|bigvgan]
        [--family dex|gedex] [--batch 16] [--solver euler|heun|dpmpp2m]
        [--steps 50] [--dit_cache 1] [--vocoder_dtype auto] [--profile DIR]
        [--device cuda]

Prints ONE JSON line with bench.py's keys. The model is the benchmark's
(`vctk_bench` DeX or `gedex_bench` GeDEX, bf16) with HiFi-GAN or BigVGAN,
random weights from fixed seeds (wall-clock does not depend on them), run
through `model.synthesize` and the vocoder directly, not `Synthesizer`:
b × 96 tokens from bench.py's seed, every item at the 768-frame bucket
(~8.9 s of audio), temperature 1.5, DeX style from bench.py's seeded
features. Each of text→mel and text→WAV is timed as bench.py's `time_fn`
does: one warm-up call, then the mean of 3, each ending with a host read
of the output's sum. ``vs_baseline`` is null: BASELINE.md's 0.02 is a TPU
target. After the timed calls, ``--profile DIR`` traces one text→WAV call
into DIR (`utils.profiling.trace`), and the FLOPs are counted once
(`utils.mfu`: matrix products and convolutions, the text→mel loop
extrapolated from runs of two and three sampler units, plus one vocoder
call): ``tflops_per_dispatch`` and, on a card with a known peak, ``mfu``,
``mfu_text_to_mel`` and ``peak_tflops``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from dex_tts_tpu_torch.config import build_model, build_vocoder, load_preset
from dex_tts_tpu_torch.models.edm import SamplerConfig
from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, HiFiGANConfig
from dex_tts_tpu_torch.ops.attention import flash_attention
from dex_tts_tpu_torch.ops.group_norm import group_norm_mish
from dex_tts_tpu_torch.ops.snake import snake_antialias
from dex_tts_tpu_torch.utils.device import card_line, resolve_device
from dex_tts_tpu_torch.utils.mfu import count_flops, extrapolated_scan_flops, mfu, peak_flops_per_chip
from dex_tts_tpu_torch.utils.profiling import trace

SAMPLE_RATE = 22050
HOP = 256
N_STEPS = 50
TX, TY, T_REF = 96, 768, 256  # tokens, frame bucket, reference frames per item
TEMPERATURE = 1.5
PRESETS = {"dex": "vctk_bench", "gedex": "gedex_bench"}
COUNTERS = {"flash_attention": flash_attention, "snake": snake_antialias,
            "group_norm": group_norm_mish}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--vocoder", choices=["hifigan", "bigvgan"], default="hifigan")
    p.add_argument("--family", choices=["dex", "gedex"], default="dex")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--dit_cache", type=int, default=1, metavar="K",
                   help="approximate DiT-cache sampling (the DiT's output reused for K-1 of"
                        " every K steps); 1 = exact")
    p.add_argument("--solver", default="euler", choices=["euler", "heun", "dpmpp2m"])
    p.add_argument("--steps", type=int, default=N_STEPS, help="sampler steps")
    # TPU lowerings of one function each in the JAX package: every value
    # runs the port's one implementation (the snake kernel on CUDA)
    p.add_argument("--snake_impl", default="auto",
                   choices=["auto", "polyphase", "fold", "pallas"])
    p.add_argument("--upsample_impl", default="conv_transpose",
                   choices=["conv_transpose", "subpixel"])
    p.add_argument("--conv_impl", default="auto", choices=["auto", "plain", "packed"])
    p.add_argument("--vocoder_dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="'auto': bfloat16 for BigVGAN, float32 for HiFi-GAN")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace one timed text-to-WAV call into DIR (torch.profiler, Chrome trace)")
    p.add_argument("--device", default="cuda", help="'cpu' runs on the CPU (no card numbers)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    if args.dit_cache > 1 and args.steps % args.dit_cache:
        p.error(f"--dit_cache {args.dit_cache} must divide {args.steps} steps")
    if args.solver != "euler" and args.dit_cache > 1:
        p.error("--dit_cache requires the euler solver")
    return args


def style_inputs(b: int, n_feats: int = 80, t_ref: int = T_REF, seed: int = 0) -> dict:
    """bench.py's reference-style features (`__graft_entry__._style_inputs`)
    as numpy: random values, every item t_ref frames long."""
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((b, n_feats, t_ref)).astype(np.float32)
    lens = np.full((b,), t_ref, np.int32)
    return {"ref": ref, "ref_lengths": lens, "sty": ref, "sty_lengths": lens,
            "lf0": rng.standard_normal((b, t_ref)).astype(np.float32), "lf0_lengths": lens}


def bench_inputs(b: int, family: str) -> dict:
    """bench.py's inputs as numpy: b × 96 tokens from seed 1, full
    lengths, and for DeX the style features from seed 0."""
    x = np.random.default_rng(1).integers(1, 148, (b, TX)).astype(np.int32)
    inputs = {"x": x, "x_lengths": np.full((b,), TX, np.int32)}
    if family == "dex":
        inputs.update(style_inputs(b))
    return inputs


def vocoder_config(args):
    """The vocoder preset of bench.py's flags."""
    dtype = args.vocoder_dtype
    if dtype == "auto":
        dtype = "bfloat16" if args.vocoder == "bigvgan" else "float32"
    if args.vocoder == "bigvgan":
        return BigVGANConfig(num_mels=80, snake_impl=args.snake_impl, dtype=dtype,
                             upsample_impl=args.upsample_impl, conv_impl=args.conv_impl)
    return HiFiGANConfig(num_mels=80, dtype=dtype, upsample_impl=args.upsample_impl)


def time_call(fn, iters: int = 3) -> tuple[float, dict]:
    """Mean wall seconds of ``fn()`` after one warm-up call, each call
    ending with a host read of its output's sum (asserted finite), and
    the kernel launches of the first timed call (the counts are set to 0
    just before it and read just after)."""

    def call():
        s = float(fn().float().sum())
        if not math.isfinite(s):
            raise FloatingPointError(f"non-finite output (sum {s})")

    call()
    for counter in COUNTERS.values():
        counter.launches = 0
    t0 = time.perf_counter()
    call()
    launches = {name: counter.launches for name, counter in COUNTERS.items()}
    for _ in range(iters - 1):
        call()
    return (time.perf_counter() - t0) / iters, launches


def main(argv=None) -> dict:
    """Run the bench; print its JSON line and return it as a dict."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    b = args.batch
    preset = load_preset(PRESETS[args.family])
    torch.manual_seed(0)
    model = build_model(preset.model, device=device)
    torch.manual_seed(3)
    vocoder = build_vocoder(vocoder_config(args), device=device)
    inputs = {k: torch.from_numpy(v).to(device) for k, v in bench_inputs(b, args.family).items()}
    inputs = {k: v.long() if k.endswith("lengths") or k == "x" else v for k, v in inputs.items()}

    def text_to_mel_at(steps):
        sampler = SamplerConfig(num_steps=steps, solver=args.solver,
                                dit_cache_interval=args.dit_cache)

        @torch.no_grad()
        def text_to_mel():
            return model.synthesize(
                y_max_length=TY, sampler=sampler, temperature=TEMPERATURE, length_scale=1.0,
                generator=torch.Generator(device).manual_seed(4), **inputs,
            )[1]
        return text_to_mel

    text_to_mel = text_to_mel_at(args.steps)

    @torch.no_grad()
    def text_to_wav():
        return vocoder(text_to_mel())

    audio_seconds = b * TY * HOP / SAMPLE_RATE
    mel_s, _ = time_call(text_to_mel)
    wav_s, launches = time_call(text_to_wav)
    rtf_mel, rtf_e2e = mel_s / audio_seconds, wav_s / audio_seconds
    if args.profile:
        with trace(args.profile):
            float(text_to_wav().float().sum())
    # the DiT cache repeats in chunks of k steps
    flops_mel = extrapolated_scan_flops(text_to_mel_at, args.steps, unit=args.dit_cache)
    with torch.no_grad():
        flops_e2e = flops_mel + count_flops(vocoder, text_to_mel())
    peak = peak_flops_per_chip(device)
    line = {
        "metric": (
            f"end-to-end {args.family} text-to-WAV synthesis RTF on one card"
            f" ({args.steps}-step {args.solver} EDM + {args.vocoder}, batch {b}, {TY} frames/item"
            + (f", APPROX dit-cache {args.dit_cache}" if args.dit_cache > 1 else "") + ")"
        ),
        "value": round(rtf_e2e, 6),
        "unit": "RTF (wall s / audio s)",
        "vs_baseline": None,  # BASELINE.md's 0.02 is a TPU v5e target
        "text_to_mel_rtf": round(rtf_mel, 6),
        "vocoder_overhead_rtf": round(rtf_e2e - rtf_mel, 6),
        "tflops_per_dispatch": flops_e2e / 1e12,
        "mfu": mfu(flops_e2e, wav_s, device),
        "mfu_text_to_mel": mfu(flops_mel, mel_s, device),
        "peak_tflops": peak / 1e12 if peak else None,
        "device": device.type,
        "card": card_line() if device.type == "cuda" else None,
        "launches": launches,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
