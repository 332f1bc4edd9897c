#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. build every kernel of `dex_tts_tpu_torch/csrc/` with nvcc (sm_90a),
     one nvcc per source, all started together;
  2. hold each kernel against its plain PyTorch version on the card, and
     time kernel, plain version and the library yardstick (where one
     PyTorch call computes the same function) with CUDA events:
     flash attention at the main path's shape and at ragged lengths; the
     anti-aliased snake in bf16 (polynomial sin², the TPU's fold kernel)
     and f32 (exact sine, the TPU's tiled kernel) at BigVGAN's six stage
     shapes of request 1, at ragged T and C, at T on the kernel's
     schedule boundaries, at k = 8 and 16, and on contiguous, offset
     (unaligned) and gapped (not dense) inputs; the library yardstick pinned to the SDPA
     backend the default dispatch picks, with its error against the plain
     version; f32 bounds at the faster of FMA and 3xTF32;
  2a. the f32 route: a bf16 MHSA under attention "flash" launches the f32
     forward, as the JAX package runs "flash" in f32;
  3. run a small-depth DeX (full widths, every parameter perturbed,
     attention "flash", ≥ 768 DiT tokens) once on the CPU (plain version)
     and once on the card (kernel), f32 with TF32 off, same noise; a CPU
     run with the attention output zeroed shows that the bound separates
     a broken kernel; the same under DPM-Solver++(2M) (4 steps) and the
     DiT cache (4 steps, k = 2), whose mel differs from the exact one;
  3b. the same for the full-width BigVGAN in f32 on a short mel: CPU
     (plain snake) against the card (snake kernel), and a CPU run with
     every snake replaced by its input;
  4. drive the main path through `Synthesizer.tts` like a server answering
     requests: the benchmark's DeX (VCTK width, bf16, attention "auto") +
     HiFi-GAN, 50 euler steps at temperature 1.5, first 16 sentences in
     the 768-frame bucket (warm-up call, then one timed), then 3 sentences
     (padded to 4) with their own reference features (warm-up call, then
     five timed); then, per call, request 1 under dpmpp2m at 16 steps and
     under the DiT cache at k = 5, and request 2 with vocode=False;
  4b. the same two requests through the same DeX + BigVGAN (bf16, full
     width), with reference WAV files that the script writes itself
     (`tts(ref_wavs=...)`: trim, resample, log-mel, lf0).
Training (the third slice) adds:
  2b. monotonic alignment search (K4) against its plain version: exactly
     equal paths and sum(path) == t_y per item, at bench_train's batch,
     ESD's long buckets, ragged lengths and on each side of every route
     boundary of the kernel (warp route | wide route: Tx = 512 | 513, Ty
     whose bits fit shared memory or not, Ty % 4 ≠ 0 on each), with its
     device and wall times and no ptxas spills; the flash-attention backward
     (bf16: one pass and the dQ convert; f32: the split pre-pass, dQ
     and dK/dV kernels) and the forward's log-sum-exp against the plain
     backward, bf16 and f32, at the train step's and the synthesis shape
     and ragged T, timed against SDPA's forward alone, backward alone and
     forward + backward; the f32 kernels' device times from
     torch.profiler, and two f32 calls on the same inputs bit-identical;
  3c. one train step (losses and every gradient) of a depth-cut DeX at
     full width, card against CPU, f32, attention "flash", with the same
     draws and a planted alignment; CPU controls with the MAS path
     shifted and with dQ zeroed land far outside the bounds;
  5. the training main path: the ESD preset at full width on
     bench_train's batch through `make_train_step`, attention "auto"
     (einsum at 880 tokens) and "flash_bf16", launch counts asserted;
  6. `Trainer.fit` through the train entry point on a dataset the script
     writes, checkpoints, and a resume that repeats the next step.
The port's benches add:
  7. `dex_tts_tpu_torch.bench` (in-process, PyTorch's TF32 defaults) at
     its defaults, `--solver dpmpp2m --steps 16`, `--dit_cache 5` and
     `--family gedex --vocoder bigvgan`, and `dex_tts_tpu_torch.bench_train`
     at its defaults: each JSON line logged, the launches of each asserted.
The last two lines are the `kernels` JSON line and the device JSON line.
Needs one card; exits non-zero without CUDA.
"""

import contextlib
import io
import json
import math
import os
import sys
import time

import numpy as np
import torch

from dex_tts_tpu_torch.bench_train import synthetic_batch
from dex_tts_tpu_torch.utils.device import card_line

# H100 SXM data-sheet peaks (dense); f32 is FMA on the CUDA cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the tensor cores in TF32; a product at f32 accuracy takes three of them
# (3xTF32), so f32 work on them runs at a third of this rate
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
MAIN_SHAPE = (16, 3840, 2, 128)  # (B, T, H, hd): 16 × 768 frames, 20 × 192 patches
TRAIN_ATTN_SHAPE = (32, 880, 2, 128)  # the ESD train step: 32 × 172-frame crops, 20 × 44 patches
MAS_SHAPES = [(32, 96, 256), (32, 256, 1024)]  # (B, Tx, Ty): bench_train's batch, ESD's long buckets
MEL_ATOL = 1e-3  # card vs CPU, f32 with TF32 off
WAV_ATOL = 1e-4  # BigVGAN card vs CPU, f32 with TF32 off
# BigVGAN's snake inputs (B, T, C) at request 1 (16 × 768 frames), and the
# snake launches per generator call at each: 3 AMP blocks × 6 snakes per
# stage, plus activation_post at the last
SNAKE_STAGES = [(16, 3072, 768), (16, 12288, 384), (16, 24576, 192),
                (16, 49152, 96), (16, 98304, 48), (16, 196608, 24)]
SNAKE_STAGE_LAUNCHES = [18, 18, 18, 18, 18, 19]
SNAKE_LAUNCHES = sum(SNAKE_STAGE_LAUNCHES)  # 109
# random weights: the duration predictor is pinned to 4 frames per token
# (blanks included, so 8 frames ≈ 93 ms per phoneme); the longest of
# SENTENCES then lands in the 768-frame bucket and none is cut
FRAMES_PER_TOKEN = 3.5  # exp of the pinned log-duration; each token takes ceil(·) = 4
SENTENCES = [
    "The quick brown fox jumps over the lazy dog, and then it runs back into the quiet woods.",
    "In the middle of the journey of our life I found myself within a dark woods where the straight way was lost.",
    "Weather forecasts predict rain for the next three days across the northern region of the country.",
    "She sells seashells by the seashore, and the shells she sells are surely seashells from the bay.",
    "Please call Stella and ask her to bring these things with her from the store on her way home.",
    "Printing, in the only sense with which we are at present concerned, differs from most if not all arts.",
    "The committee will meet again next Thursday to review the budget and the plans for the new library.",
    "Every morning the old fisherman rowed out past the harbour lights before the sun had fully risen.",
    "A gentle breeze carried the scent of pine and wood smoke down from the hills into the sleeping valley.",
    "Researchers measured the temperature of the lake every hour for three weeks during the dry summer.",
    "When the concert ended, the audience rose to its feet and applauded for nearly ten full minutes.",
    "The train to the coast leaves at half past seven, so we should be at the station before seven.",
    "He opened the letter slowly, read it twice, and then folded it carefully back into its envelope.",
    "Children played in the park while their parents talked quietly on the benches beneath the tall trees.",
    "The museum's new exhibition brings together paintings, maps and letters from the early colonial period.",
    "After the storm passed, the streets were covered with leaves, branches and puddles of muddy water.",
]
REQUEST_2 = ["Good morning.", "See you at noon, then.", "Thank you very much."]
REF_SR = 16000  # reference recordings at 16 kHz: the front end resamples to 22.05 kHz


def write_reference_wavs(directory: str, n: int, seed: int = 7) -> list[str]:
    """``n`` speech-like reference recordings as 16 kHz int16 WAV files:
    2.6-3.0 s of eight harmonics (amplitude 1/h) whose F0 glides between
    100 and 250 Hz, under a 4 Hz syllable envelope, with 0.3 s of
    near-silence (-50 dB) on each side for the trim. → the file paths."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        tt = np.arange(int((2.6 + 0.4 * rng.random()) * REF_SR)) / REF_SR
        f0 = 175.0 + 75.0 * np.sin(2 * np.pi * (0.3 + 0.4 * rng.random()) * tt
                                   + rng.uniform(0, 2 * np.pi))
        phase = 2 * np.pi * np.cumsum(f0) / REF_SR
        voice = sum(np.sin(h * phase) / h for h in range(1, 9))
        env = 0.2 + 0.8 * (0.5 - 0.5 * np.cos(2 * np.pi * 4.0 * tt))
        margin = int(0.3 * REF_SR)
        wav = np.concatenate([
            1e-3 * rng.standard_normal(margin),
            0.3 * voice * env + 3e-3 * rng.standard_normal(len(tt)),
            1e-3 * rng.standard_normal(margin),
        ])
        path = os.path.join(directory, f"ref_{i}.wav")
        wavfile.write(path, REF_SR, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        paths.append(path)
    return paths


TRAIN_TEXTS = ["Printing, in the only sense with which we are at present concerned.",
               "She sells seashells by the seashore.", "Good morning.",
               "The committee will meet again next Thursday to review the budget."]


def write_training_set(directory: str, n_items: int, n_mels: int = 80, seed: int = 8,
                       frames=(60, 300)) -> tuple[str, str]:
    """A dataset on disk in the preprocessing layout, from a seed: mel
    ``mel/spk-mel-NNN.npy`` (T, n_mels) and lf0 ``lf0/spk-lf0-NNN.npy`` (T,)
    with every fourth frame unvoiced, T in ``frames``, and two filelists
    ``mel_path|text|speaker`` (train: every item; valid: the first
    quarter). → (train filelist, valid filelist)."""
    rng = np.random.default_rng(seed)
    for sub in ("mel", "lf0"):
        os.makedirs(os.path.join(directory, sub), exist_ok=True)
    lines = []
    for i in range(n_items):
        n = int(rng.integers(*frames))
        mel = rng.standard_normal((n, n_mels)).astype(np.float32)
        lf0 = (5.0 + 0.3 * rng.standard_normal(n)).astype(np.float32)
        lf0[::4] = 0.0
        path = os.path.join(directory, "mel", f"spk-mel-{i:03d}.npy")
        np.save(path, mel)
        np.save(os.path.join(directory, "lf0", f"spk-lf0-{i:03d}.npy"), lf0)
        lines.append(f"{path}|{TRAIN_TEXTS[i % len(TRAIN_TEXTS)]}|{i % 2}")
    files = []
    for name, chosen in (("train.txt", lines), ("valid.txt", lines[:max(1, n_items // 4)])):
        files.append(os.path.join(directory, name))
        with open(files[-1], "w") as f:
            f.write("\n".join(chosen) + "\n")
    return files[0], files[1]


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline_ms(n_bytes, ops, dtype) -> tuple[float, str, str]:
    """Least time for matrix products of ``ops`` operations in ``dtype``
    over ``n_bytes`` moved: (bound ms, "bytes" or "operations", the rate
    of the operations: bf16 on the tensor cores; f32 the faster of FMA on
    the CUDA cores and 3xTF32 on the tensor cores)."""
    t_bytes = n_bytes / PEAK_BYTES
    if dtype != torch.float32:
        t_ops, rate = ops / PEAK_FLOPS[dtype], "bf16 tensor cores"
    elif 3 * ops / PEAK_TF32_FLOPS < ops / PEAK_FLOPS[torch.float32]:
        t_ops, rate = 3 * ops / PEAK_TF32_FLOPS, "3xTF32 tensor cores"
    else:
        t_ops, rate = ops / PEAK_FLOPS[torch.float32], "f32 FMA"
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), rate


def attention_bound_ms(b, t, h, hd, dtype, lse=False) -> tuple[float, str, str]:
    """Least time for exact attention: each of q, k, v read once, o (and
    with ``lse`` the f32 log-sum-exp) written once, against 4·B·H·T²·hd
    operations."""
    elem = torch.tensor([], dtype=dtype).element_size()
    n_bytes = 4 * b * t * h * hd * elem + (4 * b * h * t if lse else 0)
    return roofline_ms(n_bytes, 4 * b * h * t * t * hd, dtype)


def sdpa_backend(qt, kt, vt, scale):
    """The `SDPBackend` that SDPA's default dispatch picks for these
    (B, H, T, hd) inputs (and their requires_grad): the one whose pinned
    output equals the default call's bit for bit."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    want = sdpa(qt, kt, vt, scale=scale)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                got = sdpa(qt, kt, vt, scale=scale)
        except RuntimeError:  # the backend does not take these inputs
            continue
        if torch.equal(got, want):
            return backend
    raise RuntimeError("no SDPA backend reproduces the default dispatch")


def qkv_views(b, t, h, hd, dtype, seed):
    """q, k, v as the DiT hands them over: strided views of one
    (B, T, 3, H, hd) projection output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3, h, hd), generator=g, device="cuda", dtype=dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def phase_kernels():
    """Kernel vs plain version on the card; returns the per-type report."""
    from torch.nn.attention import sdpa_kernel

    from dex_tts_tpu_torch.ops.attention import attention_reference, flash_attention

    report = {}
    for dtype, tol_name in ((torch.bfloat16, "2e-2 x max|o|"), (torch.float32, "atol 1e-4")):
        worst = 0.0
        for shape in [MAIN_SHAPE, (2, 1, 2, 128), (2, 63, 2, 128), (2, 777, 2, 128)]:
            q, k, v = qkv_views(*shape, dtype, seed=shape[1])
            scale = shape[3] ** -0.5
            got = flash_attention(q, k, v, scale)
            want = attention_reference(q, k, v, scale, dtype)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            bound = 2e-2 * want.float().abs().max().item() if dtype == torch.bfloat16 else 1e-4
            log(f"flash_attention {dtype} {tuple(shape)}: max_abs_err {err:.3e} (bound {bound:.3e})")
            assert got.shape == want.shape and got.is_contiguous()
            assert math.isfinite(err) and err <= bound, (dtype, shape, err, bound)
            worst = max(worst, err)
        q, k, v = qkv_views(*MAIN_SHAPE, dtype, seed=0)
        scale = MAIN_SHAPE[3] ** -0.5
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        ms = time_ms(lambda: flash_attention(q, k, v, scale), 20)
        plain_ms = time_ms(lambda: attention_reference(q, k, v, scale, dtype), 5)
        # the library yardstick, pinned to the backend the default dispatch
        # picks, and its error against the plain version
        backend = sdpa_backend(qt, kt, vt, scale)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with sdpa_kernel(backend):
            library_ms = time_ms(lambda: sdpa(qt, kt, vt, scale=scale), 20)
            sdpa_out = sdpa(qt, kt, vt, scale=scale).transpose(1, 2)
        want = attention_reference(q, k, v, scale, dtype)
        sdpa_err = (sdpa_out.float() - want.float()).abs().max().item()
        del sdpa_out, want
        bound_ms, bound_by, rate = attention_bound_ms(*MAIN_SHAPE, dtype)
        report[dtype] = dict(max_abs_err=worst, tolerance=tol_name, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, library_backend=backend.name,
                             library_max_abs_err=sdpa_err, bound_ms=bound_ms, bound_by=bound_by,
                             bound_rate=rate, bound_share=bound_ms / ms)
        log(f"flash_attention {dtype} at {MAIN_SHAPE}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
            f" sdpa ({backend.name}) {library_ms:.4f} ms with max_abs_err {sdpa_err:.3e} against the"
            f" plain version, bound {bound_ms:.4f} ms ({bound_by}, {rate}); the kernel reaches"
            f" {100 * bound_ms / ms:.1f}% of the bound")
    return report


def phase_route():
    """A bf16 DiT under attention "flash" runs the f32 kernel, as the JAX
    package runs "flash" in f32 whatever the compute dtype
    (dex_tts_tpu/models/dit.py:421): one bf16 MHSA at the DiT's width
    (256 wide, 2 heads of 128) over 880 tokens launches the f32 forward
    once and the bf16 one never, and its output agrees with the same MHSA
    computing the plain attention in f32, cast to bf16, within 2e-2 ×
    max|out|. → (launches by dtype, max_abs_err)."""
    from dex_tts_tpu_torch.models.dit import MHSA, DiTConfig
    from dex_tts_tpu_torch.models.layers import run_in
    from dex_tts_tpu_torch.ops.attention import attention_reference, flash_attention

    b, t, d, h = 2, 880, 256, 2
    torch.manual_seed(31)
    mhsa = MHSA(DiTConfig(hidden_size=d, num_heads=h, dtype="bfloat16", attention="flash")).cuda()
    g = torch.Generator(device="cuda").manual_seed(32)
    x = torch.randn((b, t, d), generator=g, device="cuda")
    flash_attention.launches = 0
    flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
    with torch.no_grad():
        got = mhsa(x)
        torch.cuda.synchronize()
        launches = {str(k).removeprefix("torch."): n
                    for k, n in flash_attention.launches_by_dtype.items()}
        qkv = run_in(mhsa.qkv, x, torch.bfloat16).reshape(b, t, 3, h, d // h).float()
        att = attention_reference(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], (d // h) ** -0.5)
        want = run_in(mhsa.proj, att.to(torch.bfloat16).reshape(b, t, d), torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    bound = 2e-2 * want.float().abs().max().item()
    log(f"route: bf16 MHSA under attention flash ({b}, {t}, {d}): launches {launches}, out"
        f" {got.dtype}, max_abs_err {err:.3e} against the plain f32 attention cast to bf16"
        f" (bound {bound:.3e})")
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, d)
    assert launches == {"float32": 1, "bfloat16": 0}, launches
    assert math.isfinite(err) and err <= bound, (err, bound)
    return dict(launches_by_dtype=launches, max_abs_err=err)


def attention_bwd_bound_ms(b, t, h, hd, dtype) -> tuple[float, str, str]:
    """Least time for the attention backward: q, k, v, o, dO read once,
    dq, dk, dv written once (plus the f32 lse and D), against 10·B·H·T²·hd
    operations (S and dP recomputed, dV, dK, dQ)."""
    elem = torch.tensor([], dtype=dtype).element_size()
    n_bytes = 8 * b * t * h * hd * elem + 2 * 4 * b * h * t
    return roofline_ms(n_bytes, 10 * b * h * t * t * hd, dtype)


def attention_fwd_bwd_bound_ms(b, t, h, hd, dtype) -> tuple[float, str, str]:
    """Least time for forward + backward: q, k, v, dO read and o, dq, dk,
    dv written once each (the forward's o and lse read back counted as
    well), against 14·B·H·T²·hd operations."""
    elem = torch.tensor([], dtype=dtype).element_size()
    n_bytes = 9 * b * t * h * hd * elem + 3 * 4 * b * h * t
    return roofline_ms(n_bytes, 14 * b * h * t * t * hd, dtype)


F32_BWD_KERNELS = ("flash_split_rows_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")


def kernel_device_ms(fn, names, iters: int = 10) -> dict:
    """Device time per call of ``fn`` of each kernel whose name holds one of
    ``names``, from torch.profiler over ``iters`` calls after one warm-up
    (None where the trace shows no device time for it)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        for name in names:
            if name in e.key and dev > 0:
                out[name] = (out[name] or 0.0) + dev / 1e3 / iters
    return out


def phase_attention_backward():
    """K1's forward with its log-sum-exp (the instantiation a train step
    runs) and backward kernels against the plain versions on the card: bf16
    at the train step's shape under flash_bf16, the synthesis shape and
    ragged T, and f32. The forward's o at its tolerance (bf16 2e-2 ×
    max|o|, f32 1e-4), the lse within 1e-3, then dq, dk, dv each within
    2e-2 (bf16) or 1e-4 (f32) × its max |grad|, floored at a tenth of
    max |dv| (bf16's dQ sums its 128-key blocks with atomics, in an order
    that changes from run to run, inside the same bound); max_abs_err is
    the worst of o, dq, dk and dv. Then backward and forward + backward
    times at the train shape against the plain versions and SDPA (forward
    alone, backward alone, forward + backward). → per-type report."""
    from torch.nn.attention import sdpa_kernel

    from dex_tts_tpu_torch.ops.attention import (
        FlashAttentionQKV,
        attention_bwd_reference,
        attention_delta,
        attention_reference_lse,
        flash_attention,
        flash_attention_bwd,
    )

    report = {}
    for dtype, rel, fwd_tol in ((torch.bfloat16, 2e-2, "2e-2 x max|o|"),
                                (torch.float32, 1e-4, "atol 1e-4")):
        worst, worst_lse = 0.0, 0.0
        shapes = [TRAIN_ATTN_SHAPE, MAIN_SHAPE] + [(2, t, 2, 128) for t in (1, 63, 777)]
        for shape in shapes:
            b, t, h, hd = shape
            g = torch.Generator(device="cuda").manual_seed(t)
            qkv = torch.randn((b, t, 3, h, hd), generator=g, device="cuda").to(dtype)
            qkv.requires_grad_(True)
            do = torch.randn((b, t, h, hd), generator=g, device="cuda").to(dtype)
            scale = hd**-0.5
            FlashAttentionQKV.apply(qkv, scale).backward(do)
            q, k, v = (qkv.detach()[:, :, i] for i in range(3))
            out, lse = flash_attention(q, k, v, scale, with_lse=True)  # what the Function saved
            out_ref, lse_ref = attention_reference_lse(q, k, v, scale)
            torch.cuda.synchronize()
            # the training instantiation's o, at the forward's tolerance
            fwd_err = (out.float() - out_ref.float()).abs().max().item()
            fwd_bound = (2e-2 * out_ref.float().abs().max().item() if dtype == torch.bfloat16
                         else 1e-4)
            lse_err = (lse - lse_ref).abs().max().item()
            log(f"flash forward with lse {dtype} {shape}: o max_abs_err {fwd_err:.3e} (bound"
                f" {fwd_bound:.3e}), lse max_abs_err {lse_err:.3e} (bound 1e-3)")
            assert math.isfinite(fwd_err) and fwd_err <= fwd_bound, (dtype, shape, fwd_err, fwd_bound)
            assert math.isfinite(lse_err) and lse_err <= 1e-3, (dtype, shape, lse_err)
            worst = max(worst, fwd_err)
            worst_lse = max(worst_lse, lse_err)
            del out_ref, lse_ref
            want = attention_bwd_reference(q, k, v, out, lse, do, scale)
            # at T = 1, dq and dk are 0 in exact arithmetic and what is left
            # is the rounding of D − dP, terms of dv's size: the bound is
            # floored at rel × max|dv| / 10
            floor = 0.1 * want[2].float().abs().max().item()
            for i, name in enumerate("qkv"):
                got_g, want_g = qkv.grad[:, :, i].float(), want[i].float()
                err = (got_g - want_g).abs().max().item()
                bound = rel * max(want_g.abs().max().item(), floor)
                log(f"flash backward {dtype} {shape} d{name}: max_abs_err {err:.3e} (bound {bound:.3e})")
                assert math.isfinite(err) and err <= bound, (dtype, shape, name, err, bound)
                worst = max(worst, err)
            del qkv, do, out, want
        # times at the train step's flash_bf16 shape
        b, t, h, hd = TRAIN_ATTN_SHAPE
        g = torch.Generator(device="cuda").manual_seed(0)
        qkv = torch.randn((b, t, 3, h, hd), generator=g, device="cuda").to(dtype)
        do = torch.randn((b, t, h, hd), generator=g, device="cuda").to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scale = hd**-0.5
        out, lse = flash_attention(q, k, v, scale, with_lse=True)
        delta = attention_delta(out, do)
        dqkv = torch.empty_like(qkv)

        def kernels_bwd():
            flash_attention_bwd(q, k, v, do, lse, delta, dqkv[:, :, 0], dqkv[:, :, 1],
                                dqkv[:, :, 2], scale)

        leaf = qkv.clone().requires_grad_(True)

        def kernel_fwd_bwd():
            FlashAttentionQKV.apply(leaf, scale).backward(do)

        extra = {}
        if dtype == torch.float32:
            # per-kernel device time (which one sets the pace), and two
            # calls on the same inputs must give the same bits (no atomics)
            extra["kernel_device_ms"] = kernel_device_ms(kernels_bwd, F32_BWD_KERNELS)
            kernels_bwd()
            first = dqkv.clone()
            dqkv.fill_(float("nan"))
            kernels_bwd()
            torch.cuda.synchronize()
            extra["bit_identical"] = torch.equal(first, dqkv)
            log(f"flash backward f32 at {TRAIN_ATTN_SHAPE}: device ms per kernel"
                f" {extra['kernel_device_ms']}; two calls bit-identical: {extra['bit_identical']}")
            assert extra["bit_identical"], "two f32 backward calls differ"
            del first
        fwd_ms = time_ms(lambda: flash_attention(q, k, v, scale), 20)
        fwd_lse_ms = time_ms(lambda: flash_attention(q, k, v, scale, with_lse=True), 20)
        ms = time_ms(kernels_bwd, 20)
        fwd_bwd_ms = time_ms(kernel_fwd_bwd, 10)
        plain_ms = time_ms(lambda: attention_bwd_reference(q, k, v, out, lse, do, scale), 3)
        plain_fwd_bwd_ms = time_ms(lambda: attention_bwd_reference(
            q, k, v, *attention_reference_lse(q, k, v, scale), do, scale), 3)
        qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v))
        dot = do.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # SDPA pinned to the backend its default dispatch picks for inputs
        # that require grad: forward + backward; its forward alone (it keeps
        # its log-sum-exp, as a train step's forward does) and that
        # forward's error against the plain version; its backward alone on
        # one retained graph
        backend = sdpa_backend(qt, kt, vt, scale)
        with sdpa_kernel(backend):
            library_ms = time_ms(lambda: sdpa(qt, kt, vt, scale=scale).backward(dot), 10)
            library_fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, scale=scale), 20)
            sdpa_out = sdpa(qt, kt, vt, scale=scale)
            library_bwd_ms = time_ms(
                lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True), 20)
        want_out = attention_reference_lse(q, k, v, scale)[0]
        sdpa_err = (sdpa_out.detach().transpose(1, 2).float() - want_out.float()).abs().max().item()
        del sdpa_out, want_out
        bound_ms, bound_by, rate = attention_bwd_bound_ms(*TRAIN_ATTN_SHAPE, dtype)
        fb_bound_ms, fb_bound_by, _ = attention_fwd_bwd_bound_ms(*TRAIN_ATTN_SHAPE, dtype)
        fl_bound_ms, fl_bound_by, _ = attention_bound_ms(*TRAIN_ATTN_SHAPE, dtype, lse=True)
        report[dtype] = dict(max_abs_err=worst, max_lse_err=worst_lse,
                             tolerance=f"o: {fwd_tol}; grads: {rel} x max(max|grad|, max|dv| / 10)",
                             fwd_ms=fwd_ms, fwd_lse_ms=fwd_lse_ms, fwd_lse_bound_ms=fl_bound_ms,
                             fwd_lse_bound_by=fl_bound_by,
                             library_fwd_lse_shape_ms=library_fwd_ms,
                             library_fwd_max_abs_err=sdpa_err, library_backend=backend.name,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             bound_rate=rate,
                             library_bwd_ms=library_bwd_ms, fwd_bwd_ms=fwd_bwd_ms,
                             plain_fwd_bwd_ms=plain_fwd_bwd_ms, fwd_bwd_bound_ms=fb_bound_ms,
                             fwd_bwd_bound_by=fb_bound_by, library_ms=library_ms, **extra)
        log(f"flash forward {dtype} at {TRAIN_ATTN_SHAPE}: {fwd_ms:.4f} ms, with log-sum-exp"
            f" {fwd_lse_ms:.4f} ms (bound {fl_bound_ms:.4f} ms, {fl_bound_by}, {rate}); sdpa"
            f" ({backend.name}) forward {library_fwd_ms:.4f} ms with max_abs_err {sdpa_err:.3e} against"
            f" the plain version")
        log(f"flash backward {dtype} at {TRAIN_ATTN_SHAPE}: {ms:.4f} ms, plain bwd"
            f" {plain_ms:.4f} ms, sdpa bwd {library_bwd_ms:.4f} ms, bound {bound_ms:.4f} ms"
            f" ({bound_by}, {rate}); fwd+bwd {fwd_bwd_ms:.4f} ms, plain {plain_fwd_bwd_ms:.4f} ms,"
            f" sdpa {library_ms:.4f} ms, bound {fb_bound_ms:.4f} ms ({fb_bound_by})")
        del qkv, do, out, dqkv, leaf, qt, kt, vt
    return report


def mas_inputs(b, t_x, t_y, lengths, seed):
    """A log-prior-like value (B, Tx, Ty) and the text × mel mask for
    per-item (t_x, t_y) lengths, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    value = torch.randn((b, t_x, t_y), generator=g, device="cuda") - 40.0
    mask = torch.zeros((b, t_x, t_y), device="cuda")
    for i, (lx, ly) in enumerate(lengths):
        mask[i, :lx, :ly] = 1.0
    return value, mask


def phase_mas():
    """K4 against its plain version on the card: exactly equal paths and
    sum(path) == t_y per item (checked on the host) at bench_train's
    shape, at ESD's longest buckets, at ragged lengths (t_x = 1,
    t_x = t_y, t_y < Ty), and on each side of every route boundary
    (csrc/mas.cu: Tx = 512 | 513; Ty whose bits fit shared memory or not;
    Ty % 4 ≠ 0 on each route), the launcher's route checked against
    `ops.mas.plan`. Each case's device time (torch.profiler) beside the
    wrapper's wall time (CUDA events; the guard off: a direct call with it
    on reads its check to the host, which a train step does not) and the
    bound; the plain version's time at MAS_SHAPES. → (report by shape,
    largest |path − plain path| over the cases)."""
    from dex_tts_tpu_torch.ops.mas import (kernel_plan, maximum_path, maximum_path_scan, plan,
                                           set_mas_guard)

    rng = np.random.default_rng(9)
    long_lengths = [(int(rng.integers(1, 257)), 0) for _ in range(32)]
    long_lengths = [(lx, int(rng.integers(lx, 1025))) for lx, _ in long_lengths]
    ragged = [(1, 1), (1, 40), (9, 9), (20, 20), (5, 37), (20, 60), (13, 64), (2, 3)]
    cases = [((32, 96, 256), [(96, 256)] * 32), ((32, 256, 1024), long_lengths),
             ((8, 20, 64), ragged), ((3, 300, 700), [(300, 700), (1, 5), (299, 300)]),
             # route boundaries: tokens (K ≤ 16), shared memory, Ty % 4 ≠ 0
             ((2, 512, 700), [(512, 700), (300, 650)]), ((2, 513, 700), [(513, 700), (400, 699)]),
             ((2, 256, 5000), [(256, 5000), (200, 4001)]),
             ((2, 256, 6000), [(256, 6000), (255, 5999)]),
             ((4, 96, 257), [(96, 257), (95, 256), (1, 3), (96, 96)]),
             ((2, 600, 1401), [(600, 1401), (333, 1000)])]
    max_abs_err = 0.0
    report = {}
    for (b, t_x, t_y), lengths in cases:
        route = plan(t_x, t_y)
        assert kernel_plan(t_x, t_y) == route, (kernel_plan(t_x, t_y), route)
        value, mask = mas_inputs(b, t_x, t_y, lengths, seed=t_y)
        counted = dict(maximum_path.launches_by_route)
        got = maximum_path(value, mask)
        counted[route[0]] += 1
        assert maximum_path.launches_by_route == counted, (maximum_path.launches_by_route, route)
        want = maximum_path_scan(value, mask)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        max_abs_err = max(max_abs_err, (got - want).abs().max().item())
        counts = got.sum((1, 2)).cpu().tolist()
        log(f"mas {(b, t_x, t_y)} route {route[0]} (K {route[1]}, tile {route[2]} frames,"
            f" {route[3]} bytes of shared memory): paths equal {same}, sum(path) == t_y"
            f" {counts == [float(ly) for _, ly in lengths]}")
        assert same, (b, t_x, t_y)
        assert counts == [float(ly) for _, ly in lengths], (counts, lengths)
        set_mas_guard(False)
        try:
            ms = time_ms(lambda: maximum_path(value, mask), 20)
            for _ in range(3):  # a trace now and then holds no device activity
                device = kernel_device_ms(lambda: maximum_path(value, mask),
                                          ("mas_warp", "mas_wide"))
                device_ms = device[f"mas_{route[0]}"]
                if device_ms is not None:
                    break
        finally:
            set_mas_guard(True)
        assert device_ms is not None, device
        bound_ms = 3 * 4 * value.numel() / PEAK_BYTES * 1e3  # value, mask read; path written
        report[(b, t_x, t_y)] = dict(ms=ms, device_ms=device_ms, bound_ms=bound_ms,
                                     bound_by="bytes", library_ms=None, route=route[0])
        log(f"mas at {(b, t_x, t_y)}: device {device_ms:.4f} ms ({device_ms / t_y * 1e6:.1f} ns"
            f" per frame), wrapper {ms:.4f} ms per call, bound {bound_ms:.4f} ms (bytes),"
            f" route {route[0]}")
    for shape in MAS_SHAPES:
        value, mask = mas_inputs(*shape, [shape[1:]] * shape[0], seed=1)
        r = report[shape]
        r["plain_ms"] = time_ms(lambda: maximum_path_scan(value, mask), 2, warmup=1)
        log(f"mas at {shape}: device {r['device_ms']:.4f} ms, wrapper {r['ms']:.4f} ms,"
            f" plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes)")
    return report, max_abs_err


def snake_bound_ms(b, t, c, dtype, k=12) -> tuple[float, float]:
    """Least times (bytes, operations) in ms of one anti-aliased snake
    over (B, T, C): x read once and y written once at the memory rate,
    against (4k + 46) f32 operations per output sample at the f32
    CUDA-core peak: 2k filter FMAs (two upsample branches of k/2 taps,
    the two-branch downsample of k) and two snake evaluations of 23
    operations each with the polynomial sine (the exact sine costs more;
    it is counted as the polynomial)."""
    elem = torch.tensor([], dtype=dtype).element_size()
    n = b * t * c
    return 2 * n * elem / PEAK_BYTES * 1e3, n * (4 * k + 46) / PEAK_FLOPS[torch.float32] * 1e3


def snake_inputs(b, t, c, dtype, seed, layout="bct"):
    """x as BigVGAN hands it over, a (B, T, C) transpose of a (B, C, T)
    buffer, with alpha and inv_beta as logscale snakebeta parameters near
    the reference's, in x's dtype. Other layouts: "contiguous", a
    (B, T, C) tensor; "offset", the (B, C, T) buffer one element into its
    storage (dense, rows not 16-byte aligned); "gapped", rows of T taken
    one element into rows of T + 1 (not dense, not aligned)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "contiguous":
        x = 2 * torch.randn((b, t, c), generator=g, device="cuda").to(dtype)
    elif layout == "offset":
        x = (2 * torch.randn(b * c * t + 1, generator=g, device="cuda")).to(dtype)
        x = x[1:].view(b, c, t).transpose(1, 2)
    elif layout == "gapped":
        x = (2 * torch.randn((b, c, t + 1), generator=g, device="cuda")).to(dtype)
        x = x[..., 1:].transpose(1, 2)
    else:
        x = (2 * torch.randn((b, c, t), generator=g, device="cuda")).to(dtype).transpose(1, 2)
    alpha = torch.exp(0.3 * torch.randn(c, generator=g, device="cuda"))
    inv_beta = 1.0 / (torch.exp(0.3 * torch.randn(c, generator=g, device="cuda")) + 1e-9)
    return x, alpha.to(dtype), inv_beta.to(dtype)


def phase_snake():
    """The snake kernel against its plain version on the card (bf16 with
    the polynomial sin² as the bf16 generator runs it; f32 with the exact
    sine), then kernel, plain and bound times at the six stage shapes."""
    from dex_tts_tpu_torch.ops.snake import snake_antialias, snake_antialias_reference

    ragged = [(2, t, c) for t in (1, 2, 17, 777) for c in (3, 24)]
    # T on the kernel's schedule boundaries (csrc/snake.cu): q, a run of 8
    # outputs ± 1, a warp's chunk of 256 ± 1, a segment of 4096 ± 1, two
    # segments ± 1
    boundary = [(2, t, 3) for t in (3, 7, 8, 9, 255, 256, 257, 4095, 4096, 4097, 8191, 8193)]
    report = {}
    for dtype, impl, fast, tol_name in ((torch.bfloat16, "auto", True, "8e-3 x max|y|"),
                                        (torch.float32, "pallas", False, "atol 2e-5")):
        worst = 0.0
        cases = ([(shape, 12, "bct") for shape in SNAKE_STAGES + ragged]
                 + [((2, 777, 24), k, "bct") for k in (8, 16)]
                 + [((2, 777, 24), 12, "contiguous"), ((4, 4096, 96), 12, "contiguous")]
                 + [(shape, 12, "bct") for shape in boundary]
                 + [((2, 4097, 3), k, "bct") for k in (8, 16)]
                 + [((2, 777, 24), 12, "offset"), ((4, 4096, 96), 12, "offset"),
                    ((2, 4097, 3), 12, "gapped")])
        for i, (shape, k, layout) in enumerate(cases):
            x, al, ib = snake_inputs(*shape, dtype, seed=i, layout=layout)
            got = snake_antialias(x, al, ib, kernel_size=k, impl=impl)
            want = snake_antialias_reference(x, al, ib, k, fast)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            bound = 8e-3 * want.float().abs().max().item() if dtype == torch.bfloat16 else 2e-5
            log(f"snake {dtype} {shape} k={k}{'' if layout == 'bct' else ' ' + layout}:"
                f" max_abs_err {err:.3e} (bound {bound:.3e})")
            assert got.dtype == x.dtype and got.shape == x.shape, (got.dtype, got.shape)
            if layout != "gapped":  # a dense x: the output keeps its strides
                assert got.stride() == x.stride(), (got.stride(), x.stride())
            assert math.isfinite(err) and err <= bound, (dtype, shape, k, err, bound)
            worst = max(worst, err)
        stages = []
        for shape, n in zip(SNAKE_STAGES, SNAKE_STAGE_LAUNCHES):
            x, al, ib = snake_inputs(*shape, dtype, seed=0)
            ms = time_ms(lambda: snake_antialias(x, al, ib, impl=impl), 20)
            plain_ms = time_ms(lambda: snake_antialias_reference(x, al, ib, 12, fast), 3)
            t_bytes, t_ops = snake_bound_ms(*shape, dtype)
            stages.append(dict(shape=list(shape), launches=n, ms=ms, plain_ms=plain_ms,
                               bound_ms=max(t_bytes, t_ops),
                               bound_by="operations" if t_ops >= t_bytes else "bytes"))
            stages[-1]["bound_share"] = stages[-1]["bound_ms"] / ms
            log(f"snake {dtype} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                f" bound {max(t_bytes, t_ops):.4f} ms ({stages[-1]['bound_by']}),"
                f" {100 * stages[-1]['bound_share']:.1f}% of the bound")
        # one generator call: each stage's time × its launches
        per_call = {key: sum(st[key] * st["launches"] for st in stages)
                    for key in ("ms", "plain_ms", "bound_ms")}
        bytes_ms, ops_ms = (sum(snake_bound_ms(*sh, dtype)[i] * n
                                for sh, n in zip(SNAKE_STAGES, SNAKE_STAGE_LAUNCHES))
                            for i in (0, 1))
        report[dtype] = dict(max_abs_err=worst, tolerance=tol_name, library_ms=None,
                             bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                             stages=stages, **per_call)
        log(f"snake {dtype}, one generator call ({SNAKE_LAUNCHES} launches): kernel"
            f" {per_call['ms']:.3f} ms, plain {per_call['plain_ms']:.3f} ms,"
            f" bound {per_call['bound_ms']:.3f} ms,"
            f" {100 * per_call['bound_ms'] / per_call['ms']:.1f}% of the bound")
    return report


def perturb_(model, seed, scale=0.02):
    """Move every parameter by seeded noise (the JAX package zero-inits the
    DiT's adaLN and final linear and the Rezero gates, which would hide the
    attention from the output) and give BatchNorms non-trivial statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g).to(p.device))
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
            elif name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))


def phase_card_vs_cpu():
    """Same port, same weights and noise: CPU (plain attention) vs card
    (kernel), f32, TF32 off."""
    import copy
    import dataclasses
    from unittest import mock

    from dex_tts_tpu_torch.config import load_preset
    from dex_tts_tpu_torch.models import dit
    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.models.tts import build_tts
    from dex_tts_tpu_torch.ops.attention import flash_attention

    cfg = load_preset("vctk").model
    cfg = dataclasses.replace(
        cfg, enc_layers=2, tv_layers=2, tiv_layers=2,
        dit=dataclasses.replace(cfg.dit, depth=1, attention="flash"),
    )
    torch.manual_seed(1)  # default init, before the perturbation
    cpu_model = build_tts(cfg)
    perturb_(cpu_model, seed=1)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    g = torch.Generator().manual_seed(2)
    b, tx, t_ref, y_max = 2, 48, 96, 160  # 20 × 41 = 820 DiT tokens
    x = torch.randint(1, cfg.n_vocab, (b, tx), generator=g)
    lens = torch.tensor([tx, 37])
    ref = torch.randn(b, cfg.n_feats, t_ref, generator=g)
    ref_len = torch.tensor([t_ref, 70])
    lf0 = torch.randn(b, t_ref, generator=g)
    noise = torch.randn(b, cfg.n_feats, y_max, generator=g)
    inputs = dict(x=x, x_lengths=lens, ref=ref, ref_lengths=ref_len, sty=ref,
                  sty_lengths=ref_len, lf0=lf0, lf0_lengths=ref_len, latents_noise=noise)

    def run(model, device, sampler):
        with torch.no_grad():
            return model.synthesize(
                y_max_length=y_max, sampler=sampler, temperature=1.5,
                **{k: v.to(device) for k, v in inputs.items()},
            )

    def card_vs_cpu(label, sampler, n_launches):
        want = run(cpu_model, "cpu", sampler)
        flash_attention.launches = 0
        got = run(gpu_model, "cuda", sampler)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        err = (got[1].cpu() - want[1]).abs().max().item()
        log(f"card vs CPU (f32, depth-cut DeX, 820 tokens, {label}): mel max_abs_err {err:.3e}"
            f" (bound {MEL_ATOL:.0e}), launches {launches}")
        assert torch.equal(got[3].cpu(), want[3]), "y_lengths differ"
        assert launches == n_launches, (label, launches)
        assert math.isfinite(err) and err <= MEL_ATOL, (label, err)
        return want

    depth = cfg.dit.depth
    euler = SamplerConfig(num_steps=2)
    want = card_vs_cpu("euler, 2 steps", euler, depth * 2)
    # the bound must separate a broken kernel: the same run with the
    # attention output zeroed lands far outside it
    with mock.patch.object(dit, "flash_attention_qkv",
                           lambda qkv, scale: torch.zeros_like(qkv[:, :, 0])):
        zeroed = run(cpu_model, "cpu", euler)
    zeroed_err = (zeroed[1] - want[1]).abs().max().item()
    log(f"card vs CPU, euler: attention zeroed on the CPU {zeroed_err:.3e} off")
    assert zeroed_err > 10 * MEL_ATOL, zeroed_err
    card_vs_cpu("dpmpp2m, 4 steps", SamplerConfig(num_steps=4, solver="dpmpp2m"), depth * 4)
    cached = card_vs_cpu("DiT cache k = 2, 4 steps",
                         SamplerConfig(num_steps=4, dit_cache_interval=2), depth * 2)
    exact = run(cpu_model, "cpu", SamplerConfig(num_steps=4))
    cache_off = (cached[1] - exact[1]).abs().max().item()
    log(f"card vs CPU, DiT cache: the cached mel is {cache_off:.3e} off the exact 4-step one")
    assert not torch.equal(cached[1], exact[1]), "the DiT cache ran exact steps"


def phase_bigvgan_card_vs_cpu():
    """The full-width BigVGAN (six stages, 1536 channels), f32 with TF32
    off, same weights: CPU (plain snake) against the card (snake kernel,
    exact sine). Under the reference init normal(0, 0.01) the activations
    shrink to ~1e-5 and sin² hardly moves them, so the convs (except
    conv_pre) are drawn at normal(0, 0.02) and the logscale snake
    parameters at normal(0, 0.5): the output stays unsaturated and a CPU
    run with every snake replaced by its input lands far outside the
    bound. → the kernel's launches in the card run."""
    import copy
    from unittest import mock

    from dex_tts_tpu_torch.config import build_vocoder
    from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, bigvgan
    from dex_tts_tpu_torch.ops.snake import snake_antialias

    torch.manual_seed(11)
    cpu_model = build_vocoder(BigVGANConfig(num_mels=80, dtype="float32"), device="cpu")
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.endswith((".alpha", ".beta")):
                p.add_(0.5 * torch.randn(p.shape, generator=g))
            elif name.endswith("weight") and not name.startswith("conv_pre"):
                p.mul_(2.0)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    mel = torch.randn(2, 80, 32, generator=g)
    with torch.no_grad():
        want = cpu_model(mel)
        with mock.patch.object(bigvgan, "snake_antialias", lambda x, *a, **kw: x):
            identity = cpu_model(mel)
        snake_antialias.launches = 0
        got = gpu_model(mel.cuda())
        torch.cuda.synchronize()
    launches = snake_antialias.launches
    err = (got.cpu() - want).abs().max().item()
    identity_err = (identity - want).abs().max().item()
    log(f"BigVGAN card vs CPU (f32, full width, 2 x 32 frames): wav max_abs_err {err:.3e}"
        f" (bound {WAV_ATOL:.0e}; snakes removed: {identity_err:.3e}; wav std"
        f" {want.std().item():.3e}, |wav|>0.99 share {(want.abs() > 0.99).float().mean().item():.3f}),"
        f" snake launches {launches}")
    assert got.shape == want.shape == (2, 32 * 256)
    assert launches == SNAKE_LAUNCHES, launches
    assert math.isfinite(err) and err <= WAV_ATOL, err
    assert identity_err > 10 * WAV_ATOL, identity_err
    return dict(launches=launches, max_abs_err=err, snakes_removed_err=identity_err)


TRAIN_OUT_SIZE = 172  # esd: 2 s of mel (22050 Hz, hop 256) → 172 frames
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU train step, f32 with TF32 off
TRAIN_GRAD_REL = 1e-3  # × (max|g| + 1e-3 × the model's largest gradient), per tensor


class _PlainAttentionBrokenDq(torch.autograd.Function):
    """The plain forward with `flash_attention_bwd`'s plain counterpart
    (`attention_bwd_reference`), dQ zeroed: a broken backward kernel, for
    the card-vs-CPU control."""

    @staticmethod
    def forward(ctx, qkv, scale):
        from dex_tts_tpu_torch.ops.attention import attention_reference_lse

        out, lse = attention_reference_lse(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        from dex_tts_tpu_torch.ops.attention import attention_bwd_reference

        qkv, out, lse = ctx.saved_tensors
        _, dk, dv = attention_bwd_reference(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], out, lse,
                                            do, ctx.scale)
        return torch.stack([torch.zeros_like(dk), dk, dv], dim=2), None


def phase_train_card_vs_cpu():
    """One DeX train step's losses and gradients, card against CPU: a
    depth-cut DeX at full width (every parameter perturbed, attention
    "flash", 880 DiT tokens), f32 with TF32 off, the same weights and the
    same draws (segment offsets, σ, noise), train=False so no dropout. The
    mel follows the encoder's mu_x along a planted alignment plus noise so
    MAS is decisive; both devices' paths must be equal first. Two CPU
    controls must land more than 10× outside the bounds: the path shifted
    by one frame, and the plain attention backward with dQ zeroed. → report."""
    import copy
    import dataclasses
    from unittest import mock

    from dex_tts_tpu_torch.config import load_preset
    from dex_tts_tpu_torch.models import dit, tts
    from dex_tts_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from dex_tts_tpu_torch.ops.mas import MAS_ERRORS, maximum_path
    from dex_tts_tpu_torch.ops.masks import sequence_mask

    cfg = load_preset("esd").model
    cfg = dataclasses.replace(cfg, enc_layers=2, tv_layers=2, tiv_layers=2,
                              dit=dataclasses.replace(cfg.dit, depth=1, attention="flash"))
    torch.manual_seed(21)
    cpu_model = tts.build_tts(cfg)
    perturb_(cpu_model, seed=21)
    with torch.no_grad():
        # sharper attention: near-uniform weights would leave dQ too small
        # for the zeroed-dQ control to show
        for blk in cpu_model.decoder.denoise_fn.vit.blocks:
            blk.attn.qkv.weight[:2 * cfg.dit.hidden_size] *= 8.0
    # module train mode: cuDNN's GRU runs its backward only in it (the
    # losses stay train=False: no dropout, running BatchNorm statistics)
    gpu_model = copy.deepcopy(cpu_model).cuda().train()
    rng = np.random.default_rng(22)
    b, tx, ty = 2, 64, 256
    x = torch.from_numpy(rng.integers(1, cfg.n_vocab, (b, tx)))
    x_lengths = torch.tensor([tx, 50])
    y_lengths = torch.tensor([ty, 230])
    mel = torch.from_numpy(rng.standard_normal((b, cfg.n_feats, 200)).astype(np.float32))
    style = dict(ref=mel, ref_lengths=torch.tensor([200, 150]), sty=mel,
                 sty_lengths=torch.tensor([200, 150]),
                 lf0=torch.from_numpy(rng.standard_normal((b, 200)).astype(np.float32)),
                 lf0_lengths=torch.tensor([200, 150]))
    with torch.no_grad():
        cond = cpu_model._cond_from_inputs(**style)
        mu_x, _, x_mask = cpu_model._encode(x, x_lengths, sty=cond["sty_enc"])
    planted = torch.zeros(b, tx, ty)
    for i in range(b):
        ends = np.round(np.linspace(0, int(y_lengths[i]), int(x_lengths[i]) + 1)).astype(int)
        for j in range(int(x_lengths[i])):
            planted[i, j, ends[j]:ends[j + 1]] = 1.0
    y = torch.einsum("bxt,bxf->bft", planted, mu_x)
    y = (y + 0.05 * torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32)))
    y = y * sequence_mask(y_lengths, ty)[:, None, :]
    draws = {"u": torch.from_numpy(rng.random(b).astype(np.float32)),
             "sigma": torch.from_numpy(rng.standard_normal((b, 1, 1)).astype(np.float32)),
             "noise": torch.from_numpy(
                 rng.standard_normal((b, cfg.n_feats, TRAIN_OUT_SIZE)).astype(np.float32))}
    inputs = dict(x=x, x_lengths=x_lengths, y=y, y_lengths=y_lengths, **style)

    def mas_path(model, device):
        kw = {k: v.to(device) for k, v in inputs.items()}
        with torch.no_grad():
            c = model._cond_from_inputs(**{k: kw[k] for k in style})
            m, _, xm = model._encode(kw["x"], kw["x_lengths"], sty=c["sty_enc"])
            ym = sequence_mask(kw["y_lengths"], ty).float()
            return maximum_path(tts._log_prior(kw["y"], m, cfg.n_feats),
                                xm[:, :, 0][:, :, None] * ym[:, None, :]).cpu()

    def run(model, device):
        model.zero_grad(set_to_none=True)
        losses = model.compute_loss(**{k: v.to(device) for k, v in inputs.items()},
                                    out_size=TRAIN_OUT_SIZE, train=False,
                                    draws={k: v.to(device) for k, v in draws.items()})
        assert losses.pop(MAS_ERRORS).item() == 0, "the MAS guard counted a broken path"
        sum(losses.values()).backward()
        return ({k: v.item() for k, v in losses.items()},
                {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                 if p.grad is not None})

    def worst_ratio(got, want):
        """max over loss terms and gradients of error / bound, and where."""
        losses, grads = want
        top = max(g.abs().max().item() for g in grads.values())
        rows = [(abs(got[0][k] - v) / (TRAIN_LOSS_RTOL * abs(v)), k) for k, v in losses.items()]
        for n, g in grads.items():
            bound = TRAIN_GRAD_REL * (g.abs().max().item() + 1e-3 * top)
            rows.append(((got[1][n] - g).abs().max().item() / bound, n))
        assert sorted(got[1]) == sorted(grads)
        return max(rows)

    cpu_path = mas_path(cpu_model, "cpu")
    assert torch.equal(cpu_path, planted), "the plain MAS did not recover the planted path"
    assert torch.equal(mas_path(gpu_model, "cuda"), cpu_path), "card and CPU MAS paths differ"
    want = run(cpu_model, "cpu")
    with mock.patch.object(tts, "maximum_path", lambda v, m, return_errors: (
            torch.roll(maximum_path(v, m), 1, dims=2) * m, torch.zeros(()))):
        shifted = worst_ratio(run(cpu_model, "cpu"), want)
    with mock.patch.object(dit, "flash_attention_qkv", _PlainAttentionBrokenDq.apply):
        no_dq = worst_ratio(run(cpu_model, "cpu"), want)
    flash_attention.launches = flash_attention_bwd.launches = maximum_path.launches = 0
    got = run(gpu_model, "cuda")
    launches = dict(fwd=flash_attention.launches, bwd=flash_attention_bwd.launches,
                    mas=maximum_path.launches)
    ratio = worst_ratio(got, want)
    log(f"train step card vs CPU (f32, depth-cut DeX, 880 DiT tokens, attention flash):"
        f" losses {got[0]} vs {want[0]}; worst error/bound {ratio[0]:.3e} ({ratio[1]});"
        f" controls: path shifted {shifted[0]:.3e} ({shifted[1]}), dQ zeroed {no_dq[0]:.3e}"
        f" ({no_dq[1]}); launches {launches} (bounds: losses rtol {TRAIN_LOSS_RTOL},"
        f" grads {TRAIN_GRAD_REL} x (max|g| + 1e-3 x top))")
    assert ratio[0] <= 1.0, ratio
    assert shifted[0] > 10 and no_dq[0] > 10, (shifted, no_dq)
    assert launches == dict(fwd=1, bwd=1, mas=1), launches
    return dict(worst_ratio=ratio[0], shifted_ratio=shifted[0], no_dq_ratio=no_dq[0])


@contextlib.contextmanager
def torch_tf32_defaults():
    """PyTorch's own TF32 flags (cuDNN convolutions in TF32, matmuls in
    full f32), which the port leaves alone, inside a run whose parity
    phases turned TF32 off."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def build_train_path(attention: str):
    """The training main path on the card: the ESD preset at full width
    with DiT attention ``attention``, its train state (seed 100) and step,
    and bench_train's batch → (model config, resolved attention mode,
    state, step, batch)."""
    import dataclasses

    from dex_tts_tpu_torch.config import build_model, load_preset
    from dex_tts_tpu_torch.models.dit import resolve_attention_mode, token_count
    from dex_tts_tpu_torch.train import create_train_state, make_train_step

    preset = load_preset("esd")
    cfg = dataclasses.replace(preset.model,
                              dit=dataclasses.replace(preset.model.dit, attention=attention))
    out_size = preset.out_size()
    assert out_size == TRAIN_OUT_SIZE
    mode = resolve_attention_mode(cfg.dit_config(), token_count(cfg.dit_config(), out_size // 2),
                                  train=True)
    torch.manual_seed(0)
    state = create_train_state(build_model(cfg, device="cuda"), seed=100, lr=preset.train.lr,
                               max_grad=preset.train.max_grad)
    step = make_train_step(out_size=out_size, ema_decay=preset.train.ema_decay)
    return cfg, mode, state, step, synthetic_batch()


def phase_train_main_path(card: str, attention: str, steps: int = 10) -> dict:
    """The training main path: the ESD preset at full width, f32 at
    PyTorch's TF32 defaults, on bench_train's synthetic batch (32 × 256
    frames, 96 tokens, 172-frame crops), through `make_train_step`: one
    warm-up step, then ``steps`` timed ones, the counts set to 0 just
    before them and read just after. → launches per kernel, steps/s, peak
    memory, last metrics."""
    from dex_tts_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from dex_tts_tpu_torch.ops.mas import maximum_path
    from dex_tts_tpu_torch.train.trainer import metrics_to_host

    cfg, mode, state, step, batch = build_train_path(attention)
    metrics_to_host(step(state, batch))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (flash_attention, flash_attention_bwd, maximum_path)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(state, batch)
    last = metrics_to_host(metrics)  # the one host read: synchronises and checks the MAS paths
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"[esd train, attention {attention} → {mode}] {steps} steps in {wall:.3f} s:"
        f" {steps / wall:.4f} steps/s, {steps * 32 / wall:.2f} items/s, peak memory"
        f" {peak_gb:.2f} GiB, last {last}, launches {launches} [{card}]")
    assert all(math.isfinite(v) for v in last.values()), last
    flash = steps * cfg.dit.depth if mode.startswith("flash") else 0
    assert launches == dict(flash_attention=flash, flash_attention_bwd=flash,
                            maximum_path=steps), launches
    del state
    torch.cuda.empty_cache()
    return dict(mode=mode, launches=launches, steps_per_s=steps / wall,
                items_per_s=steps * 32 / wall, peak_gib=peak_gb, last=last)


def phase_trainer_fit(card: str, directory: str) -> dict:
    """`Trainer.fit` through the train entry point: the ESD preset at full
    width, batch 4, two epochs over 16 utterances written to disk from a
    seed; the checkpoint files appear, and a resume from "last" repeats
    the next step (same weights, optimizer, EMA and generator; same
    losses)."""
    import dataclasses

    from dex_tts_tpu_torch import main as port_main
    from dex_tts_tpu_torch.config import build_model, load_preset
    from dex_tts_tpu_torch.train import create_train_state, make_train_step
    from dex_tts_tpu_torch.train.trainer import metrics_to_host

    train_path, val_path = write_training_set(os.path.join(directory, "data"), 16)
    preset = load_preset("esd")
    preset = dataclasses.replace(preset, train_path=train_path, val_path=val_path,
                                 train=dataclasses.replace(preset.train, epoch=2, batch_size=4))
    exp = os.path.join(directory, "exp")
    t0 = time.perf_counter()
    trainer = port_main.train(preset, exp, seed=1, device="cuda")
    wall = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(exp, "ckpt")))
    assert {"last.pth", "best-train.pth", "best-val.pth"} <= set(names), names
    state = trainer.state
    assert state.step == 8, state.step
    torch.manual_seed(5)
    fresh = create_train_state(build_model(preset.model, device="cuda"), seed=5)
    trainer.ckpt.restore(fresh, "last")
    assert fresh.step == state.step
    for (n, p), q in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(p, q), n
    assert all(torch.equal(state.ema[n], fresh.ema[n]) for n in state.ema)
    assert torch.equal(state.generator.get_state(), fresh.generator.get_state())
    batch = next(iter(port_main.make_loaders(preset, seed=1)[0]()))
    step = make_train_step(out_size=preset.out_size(), ema_decay=preset.train.ema_decay)
    want = metrics_to_host(step(state, batch))
    got = metrics_to_host(step(fresh, batch))
    log(f"Trainer.fit (esd width, batch 4, 2 epochs x 4 steps) {wall:.1f} s, checkpoints"
        f" {names}; next step live {want}, resumed {got} [{card}]")
    for k in want:
        if k == "grad_norm":  # reductions in the backward need not repeat bit for bit
            assert math.isclose(got[k], want[k], rel_tol=1e-4), (k, got[k], want[k])
        else:
            assert got[k] == want[k], (k, got[k], want[k])
    return dict(checkpoints=names, wall_s=wall, next_step=want)


def build_main_path(preset_name: str = "vctk_bench"):
    """The benchmark's DeX (VCTK width, bf16, attention "auto") + the
    preset's vocoder (HiFi-GAN for "vctk_bench", the bf16 BigVGAN for
    "vctk_bench_bigvgan") on the card, random weights from fixed seeds →
    (preset, Synthesizer)."""
    from dex_tts_tpu_torch.config import build_model, build_vocoder, load_preset
    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.pipeline import Synthesizer

    preset = load_preset(preset_name)
    torch.manual_seed(0)
    model = build_model(preset.model, device="cuda")
    perturb_(model, seed=3)
    with torch.no_grad():
        model.encoder.proj_w.proj.weight.zero_()
        model.encoder.proj_w.proj.bias.fill_(math.log(FRAMES_PER_TOKEN))
    vocoder = build_vocoder(preset.vocoder, device="cuda")
    perturb_(vocoder, seed=4, scale=0.002)
    synth = Synthesizer(model, vocoder, cmu_path=preset.cmu_path,
                        sampler=SamplerConfig(num_steps=preset.n_timesteps), device="cuda")
    return preset, synth


def random_ref_feats(n, seed=5, t_ref=256):
    """Pre-extracted style features (mel (80, T), lf0 (T,)) from a seed."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((80, t_ref)).astype(np.float32),
             rng.standard_normal(t_ref).astype(np.float32)) for _ in range(n)]


def phase_main_path(card: str, preset_name: str, refs_1: dict, refs_2: dict,
                    sampler_options: bool = False) -> dict:
    """One main path through Synthesizer.tts: request 1 (16 long
    sentences, warm-up then one timed call) and request 2 (3 short ones,
    warm-up then five timed calls). ``refs_*``: the style keyword of
    `tts` (``ref_feats`` or ``ref_wavs``). With ``sampler_options``, one
    call each of request 1 under dpmpp2m at 16 steps and under the DiT
    cache at k = 5, and of request 2 with vocode=False. Each kernel's
    count is set to 0 just before each call and read just after. →
    request 1's launches per kernel, wall and RTF, request 2's walls, and
    the option calls' launches, walls and RTFs."""
    from dex_tts_tpu_torch.models.dit import resolve_attention_mode, token_count
    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.models.vocoder import BigVGANGenerator
    from dex_tts_tpu_torch.ops.attention import flash_attention
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.pipeline import SAMPLE_RATE

    preset, synth = build_main_path(preset_name)
    dit_cfg = preset.model.dit_config()
    n_snakes = SNAKE_LAUNCHES if isinstance(synth.vocoder, BigVGANGenerator) else 0

    def request(texts, refs, label, n_steps=preset.n_timesteps, **options):
        feats = refs.get("ref_feats") or [synth.prepare_reference(p) for p in refs["ref_wavs"]]
        inputs, b = synth.prepare_batch(texts, ref_feats=feats)
        y_len = synth.frame_bucket(inputs, max_frames=768)
        assert synth.predict_frames(inputs) <= y_len, "an item would be cut at the bucket"
        tokens = token_count(dit_cfg, y_len // 2)
        torch.cuda.synchronize()
        flash_attention.launches = snake_antialias.launches = 0
        t0 = time.perf_counter()
        out = synth.tts(texts, temperature=preset.temperature, max_frames=768,
                        generator=torch.Generator("cuda").manual_seed(6), **refs, **options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": flash_attention.launches,
                    "snake": snake_antialias.launches}
        audio_s = sum(r["n_frames"] for r in out) * synth.hop / SAMPLE_RATE
        bucket_s = inputs["x"].shape[0] * y_len * synth.hop / SAMPLE_RATE
        log(f"[{preset_name}] {label}: batch {b} (padded {inputs['x'].shape[0]}), bucket"
            f" {y_len} frames, {tokens} DiT tokens, wall {wall:.3f} s, RTF"
            f" {wall / audio_s:.6f} over {audio_s:.2f} s audio ({wall / bucket_s:.6f} over"
            f" the padded bucket), launches {launches} [{card}]")
        assert len(out) == len(texts)
        vocoded = options.get("vocode", True)
        for r in out:
            assert ("wav" in r) == vocoded, sorted(r)
            assert np.isfinite(r["mel"]).all()
            if vocoded:
                assert r["wav"].shape == (r["n_frames"] * synth.hop,)
                assert np.isfinite(r["wav"]).all()
        if resolve_attention_mode(dit_cfg, tokens) == "flash_bf16":
            # a DiT-cache chunk of k steps runs the DiT once
            dit_steps = n_steps // options.get("dit_cache_interval", 1)
            assert launches["flash_attention"] == dit_cfg.depth * dit_steps, launches
        assert launches["snake"] == (n_snakes if vocoded else 0), launches
        return dict(frames=y_len, launches=launches, wall_s=wall, rtf=wall / audio_s,
                    audio_s=audio_s)

    request(SENTENCES, refs_1, "warm-up 16 x long")
    first = request(SENTENCES, refs_1, "request 1: 16 x long")
    assert first["frames"] == 768, first
    # latency of a short request, warm: one untimed call at its bucket first
    request(REQUEST_2, refs_2, "warm-up 3 x short")
    walls = sorted(request(REQUEST_2, refs_2, f"request 2.{i}: 3 x short")["wall_s"]
                   for i in range(5))
    log(f"[{preset_name}] request 2 latency over 5 warm calls: min {walls[0]:.4f} s,"
        f" median {walls[2]:.4f} s, max {walls[-1]:.4f} s [{card}]")
    if not sampler_options:
        return dict(request_1=first, request_2_walls_s=walls)
    options = {
        "dpmpp2m_16": request(SENTENCES, refs_1, "request 1, dpmpp2m 16 steps", n_steps=16,
                              solver="dpmpp2m", n_timesteps=16),
        "dit_cache_5": request(SENTENCES, refs_1, "request 1, DiT cache k = 5",
                               dit_cache_interval=5),
        "no_vocode": request(REQUEST_2, refs_2, "request 2, vocode=False", vocode=False),
    }
    # the options were per call: the synthesizer's own sampler is unchanged
    assert synth.sampler == SamplerConfig(num_steps=preset.n_timesteps), synth.sampler
    return dict(request_1=first, request_2_walls_s=walls, options=options)


# the port bench's runs: (label, argv, K1 launches, K2 launches) per
# text→WAV call: K1 4 per DiT evaluation (depth 4), K2 109 per BigVGAN call
BENCH_RUNS = [
    ("default", [], 200, 0),
    ("dpmpp2m_16", ["--solver", "dpmpp2m", "--steps", "16"], 64, 0),
    ("dit_cache_5", ["--dit_cache", "5"], 40, 0),
    ("gedex_bigvgan", ["--family", "gedex", "--vocoder", "bigvgan"], 200, SNAKE_LAUNCHES),
]


def phase_bench(card: str) -> dict:
    """The port's benches in this process, as `python -m
    dex_tts_tpu_torch.bench ...` and `python -m dex_tts_tpu_torch.bench_train`
    run them: each JSON line logged behind its label (so that the kernels
    and device lines stay the only bare JSON lines), the launches of one
    timed call (of the timed train steps) asserted. → {label: JSON line}."""
    from dex_tts_tpu_torch import bench, bench_train

    lines = {}
    for label, argv, k1, k2 in BENCH_RUNS:
        with contextlib.redirect_stdout(io.StringIO()):
            line = bench.main(argv)
        log(f"[bench {label}] {json.dumps(line)}")
        assert line["launches"] == {"flash_attention": k1, "snake": k2}, (label, line["launches"])
        assert math.isfinite(line["value"]) and line["card"] == card, line
        lines[label] = line
        torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        line = bench_train.main([])
    log(f"[bench_train default] {json.dumps(line)}")
    steps = bench_train.parse_args([]).steps
    assert line["launches"] == dict(flash_attention=0, flash_attention_bwd=0,
                                    maximum_path=steps), line["launches"]
    assert math.isfinite(line["final_loss"]) and line["card"] == card, line
    lines["train_default"] = line
    torch.cuda.empty_cache()
    return lines


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import tempfile

    from dex_tts_tpu_torch.ops.kernels import build_all, load_library, resource_usage

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for source in sorted(built):
        for line in resource_usage(source):
            log(f"ptxas {source} {line}")
    fwd_f32_build = [line for line in resource_usage("flash_attention.cu")
                     if any(n in line.split(":")[0] for n in ("flash_fwd_f32", "flash_split_kv_f32"))]
    smem = load_library("flash_attention.cu").flash_attention_fwd_smem(0)
    for line in fwd_f32_build:
        log(f"f32 forward (3xTF32) build: {line}; dynamic shared memory {smem} bytes")
    bwd_f32_build = [line for line in resource_usage("flash_attention.cu")
                     if any(n in line.split(":")[0] for n in F32_BWD_KERNELS)]
    bwd_smem = {n: load_library("flash_attention.cu").flash_attention_bwd_f32_smem(i)
                for i, n in enumerate(F32_BWD_KERNELS)}
    for line in bwd_f32_build:
        log(f"f32 backward (3xTF32) build: {line}")
    log(f"f32 backward dynamic shared memory (bytes): {bwd_smem}")
    mas_build = resource_usage("mas.cu")
    assert mas_build and all("0 bytes spill stores" in line and "0 bytes spill loads" in line
                             for line in mas_build), mas_build
    log(f"mas.cu (K4): no spills in any of its {len(mas_build)} kernels")

    report = phase_kernels()
    route = phase_route()
    snake = phase_snake()
    mas, mas_err = phase_mas()
    bwd = phase_attention_backward()
    phase_card_vs_cpu()
    snake_f32_run = phase_bigvgan_card_vs_cpu()
    train_parity = phase_train_card_vs_cpu()
    with torch_tf32_defaults():
        train = {attention: phase_train_main_path(card, attention)
                 for attention in ("auto", "flash_bf16")}
        with tempfile.TemporaryDirectory() as tmp:
            fit = phase_trainer_fit(card, tmp)
    hifigan = phase_main_path(card, "vctk_bench", {"ref_feats": random_ref_feats(16)},
                              {"ref_feats": random_ref_feats(3, seed=6)}, sampler_options=True)
    with tempfile.TemporaryDirectory() as tmp:
        wavs = write_reference_wavs(tmp, 16)
        bigvgan = phase_main_path(card, "vctk_bench_bigvgan", {"ref_wavs": wavs},
                                  {"ref_wavs": wavs[:3]})
    with torch_tf32_defaults():
        benches = phase_bench(card)
    paths = {"hifigan": hifigan["request_1"]["launches"], "bigvgan": bigvgan["request_1"]["launches"],
             **{f"hifigan_{k}": v["launches"] for k, v in hifigan["options"].items()},
             **{f"bench_{run[0]}": benches[run[0]]["launches"] for run in BENCH_RUNS}}
    train_launches = {**{f"train_{k}": v["launches"] for k, v in train.items()},
                      "bench_train": benches["train_default"]["launches"]}

    bf16, f32 = report[torch.bfloat16], report[torch.float32]
    sb, sf = snake[torch.bfloat16], snake[torch.float32]
    timing_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "dex_tts_tpu_torch/csrc/flash_attention.cu",
        "replaces": "dex_tts_tpu/models/dit.py:410",
        "replaces_also": "dex_tts_tpu/models/dit.py:367",
        "launches": paths["hifigan"]["flash_attention"],
        "launches_by_path": {**{k: v["flash_attention"] for k, v in paths.items()},
                             **{k: v["flash_attention"] for k, v in train_launches.items()}},
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
        "shape": list(MAIN_SHAPE),
        "dtype": "bfloat16",
        "max_abs_err_f32": f32["max_abs_err"],
        "bound_rate": bf16["bound_rate"],
        "library_backend": bf16["library_backend"],
        "library_max_abs_err": bf16["library_max_abs_err"],
        "f32": {**{k: f32[k] for k in timing_keys},
                **{k: f32[k] for k in ("bound_rate", "bound_share", "library_backend",
                                       "library_max_abs_err")},
                "build": fwd_f32_build, "dynamic_smem_bytes": smem},
        # a bf16 DiT under attention "flash" (phase_route)
        "f32_route": route,
        "card": card,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "dex_tts_tpu_torch/csrc/flash_attention.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
        "replaces_also": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
        "reached_from": "dex_tts_tpu/models/dit.py:410",
        # one count per backward call (bf16: the one-pass kernel and its
        # dQ convert)
        "launches": train["flash_bf16"]["launches"]["flash_attention_bwd"],
        "launches_by_path": {k: v["flash_attention_bwd"] for k, v in train_launches.items()},
        "max_abs_err": bwd[torch.bfloat16]["max_abs_err"],
        # every time covers one FlashAttentionQKV forward (with the
        # log-sum-exp) and backward, the call a train step makes, as the
        # library's (SDPA forward + backward on the same views) does; the
        # backward alone and the forward alone, each beside SDPA's, are the
        # two keys below and under "bf16" and "f32"
        "ms": bwd[torch.bfloat16]["fwd_bwd_ms"],
        "plain_ms": bwd[torch.bfloat16]["plain_fwd_bwd_ms"],
        "bound_ms": bwd[torch.bfloat16]["fwd_bwd_bound_ms"],
        "bound_by": bwd[torch.bfloat16]["fwd_bwd_bound_by"],
        "library_ms": bwd[torch.bfloat16]["library_ms"],
        "library_bwd_ms": bwd[torch.bfloat16]["library_bwd_ms"],
        "library_fwd_lse_shape_ms": bwd[torch.bfloat16]["library_fwd_lse_shape_ms"],
        "covers": "forward with log-sum-exp + backward",
        "shape": list(TRAIN_ATTN_SHAPE),
        "dtype": "bfloat16",
        "bf16": {k: v for k, v in bwd[torch.bfloat16].items()},
        "f32": {**bwd[torch.float32], "build": bwd_f32_build, "dynamic_smem_bytes": bwd_smem},
        "card": card,
    }, {
        "name": "mas",
        "route": "cuda",
        "source": "dex_tts_tpu_torch/csrc/mas.cu",
        "replaces": "dex_tts_tpu/ops/mas.py:247",
        "launches": train["flash_bf16"]["launches"]["maximum_path"],
        "launches_by_path": {k: v["maximum_path"] for k, v in train_launches.items()},
        "max_abs_err": mas_err,
        "ms": mas[MAS_SHAPES[0]]["ms"],  # the wrapper's wall time per call
        "device_ms": mas[MAS_SHAPES[0]]["device_ms"],  # the kernel's, torch.profiler
        "mas_route": mas[MAS_SHAPES[0]]["route"],  # K4's own route (warp or wide)
        "plain_ms": mas[MAS_SHAPES[0]]["plain_ms"],
        "bound_ms": mas[MAS_SHAPES[0]]["bound_ms"],
        "bound_by": mas[MAS_SHAPES[0]]["bound_by"],
        "library_ms": None,  # no PyTorch call computes MAS
        "shape": list(MAS_SHAPES[0]),
        "by_shape": {str(k): v for k, v in mas.items()},
        "card": card,
    }, {
        "name": "snake",
        "route": "cuda",
        "source": "dex_tts_tpu_torch/csrc/snake.cu",
        "replaces": "dex_tts_tpu/ops/snake.py:309",
        "replaces_also": "dex_tts_tpu/ops/snake.py:152",
        "launches": paths["bigvgan"]["snake"],
        "launches_by_path": {k: v["snake"] for k, v in paths.items()},
        "max_abs_err": sb["max_abs_err"],
        # times: one generator call at request 1's shapes, Σ over the six
        # stage shapes of (time at the shape × launches at the shape)
        "ms": sb["ms"],
        "plain_ms": sb["plain_ms"],
        "bound_ms": sb["bound_ms"],
        "bound_by": sb["bound_by"],
        "library_ms": None,  # no single PyTorch call computes up → snake → down
        "per": f"generator call ({SNAKE_LAUNCHES} launches at request 1's stage shapes)",
        "dtype": "bfloat16",
        "stages": sb["stages"],
        "max_abs_err_f32": sf["max_abs_err"],
        "f32": {**{k: sf[k] for k in timing_keys}, "stages": sf["stages"],
                "launches_card_vs_cpu": snake_f32_run["launches"],
                "card_vs_cpu_wav_err": snake_f32_run["max_abs_err"]},
        "card": card,
    }]
    log(f"main paths: HiFi-GAN request 1 RTF {hifigan['request_1']['rtf']:.6f}, BigVGAN request 1"
        f" RTF {bigvgan['request_1']['rtf']:.6f}; esd train steps/s "
        + ", ".join(f"{k} {v['steps_per_s']:.4f}" for k, v in train.items())
        + f"; train card vs CPU worst error/bound {train_parity['worst_ratio']:.3e};"
        f" Trainer.fit {fit['wall_s']:.1f} s")
    log("port bench: e2e RTF " + ", ".join(f"{k} {v['value']}" for k, v in benches.items()
                                          if k != "train_default")
        + f"; train {benches['train_default']['value']} steps/s, peak"
        f" {benches['train_default']['peak_mem_gib']:.3f} GiB [{card}]")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
