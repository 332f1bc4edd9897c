#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. build every kernel of `dex_tts_tpu_torch/csrc/` with nvcc (sm_90a),
     one nvcc per source, all started together;
  2. hold each kernel against its plain PyTorch version on the card, and
     time kernel, plain version and the library yardstick (where one
     PyTorch call computes the same function) with CUDA events:
     flash attention at the main path's shape, at the 44.1 kHz cell's
     6144 tokens and at ragged lengths; the anti-aliased snake in bf16
     (polynomial sin², the TPU's fold kernel) and f32 (exact sine, the
     TPU's tiled kernel) at BigVGAN's six stage shapes of request 1 and
     BigVGAN-v2's six of the 44.1 kHz cell, at ragged T and C, at T on
     the kernel's schedule boundaries, at k = 8 and 16, and on contiguous, offset
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
     writes (attention "flash_bf16"), checkpoints, and a resume that
     repeats the next step.
The port's benches add:
  7. `dex_tts_tpu_torch.bench` (in-process, PyTorch's TF32 defaults) at
     its defaults, `--solver dpmpp2m --steps 16`, `--dit_cache 5` and
     `--family gedex --vocoder bigvgan`, and `dex_tts_tpu_torch.bench_train`
     at its defaults: each JSON line logged, the launches of each asserted.
Loading and serving add:
  8. the serving path from disk (`phase_serve`): the main path's DeX
     saved through `CheckpointManager` and its HiFi-GAN in the
     reference's weight-normed, zipped layout with a config.json, loaded
     by `load_synthesizer` (no random init); `python -m
     dex_tts_tpu_torch.synthesize` in-process (a sentence, and a
     paragraph with --long), the sentence held against a direct `tts`
     with the same seed within 1e-4 × max|wav|; then
     `dex_tts_tpu_torch.serve`'s server on 127.0.0.1 after its warm-up,
     16 concurrent /tts requests and 4 concurrent /tts_stream requests
     of 6 sentences, every WAV's length, the streams' order, coalescing
     and K1's launches asserted; /tts latency and the streams' time to
     first audio (p50, p95) logged.
Vocoder training and the DeX trainer's hooks add:
  2c. the snake under autograd (`SnakeKernelFunction`: kernel forward,
     plain backward) against autograd through the plain version, bf16 and
     f32, at the vocoder train step's six stage shapes (16 × 8192) and a
     ragged one: gradients bit-equal, forward within K2's / K3's bounds,
     one launch per forward and none per backward; its time per step;
  3d. one vocoder GAN step, card against CPU: the full-width f32 BigVGAN
     with the default MPD/MRD on 2 × 2048 samples, the critics' loss and
     gradients, then the generator's loss parts and gradients against the
     same updated critics; a CPU control without snakes far outside;
  6. (extended) `--init_from` a reference-layout checkpoint, synthesis
     every epoch (K1 launches counted), a SIGTERM inside the loader;
  9. the vocoder training main path, `python -m
     dex_tts_tpu_torch.train_vocoder --vocoder bigvgan` in-process at its
     defaults (109 K3 launches per step, every generator gradient finite
     and non-zero in the first step, steps/s, peak memory), `gen_last.pth`
     through `load_vocoder`, a resume from ``last``, then `--vocoder
     hifigan` (no snake).
Evaluation and preprocessing add:
 10. `phase_eval`: a seeded VCTK-layout corpus preprocessed by `python -m
     dex_tts_tpu_torch.preprocess` with the mels on the card, held against
     a CPU run (mels within 1e-5 of the largest value, linear domain;
     lf0, WAVs and filelists equal); `python -m dex_tts_tpu_torch.main
     test` on the held-out speaker's 8 items with the main path's DeX and
     HiFi-GAN from disk and a seeded GE2E (K1 200 per item, finite mel
     MAE, MCD > 0, cos in [-1, 1]) and on 2 items with the bf16 BigVGAN
     (K2 109 per item); GE2E card vs CPU, cuDNN TF32 off and on; the
     time per item by stage and per preprocessed utterance.
Data and tensor parallelism add:
 11. `phase_parallel`: two gloo ranks sharing the card (NCCL refuses two
     ranks on one device) run the ESD train step at full width, global
     batch 32, against the one-process step on the same rows, under
     attention "auto" and "flash_bf16", with a plain-DDP control outside
     the bound and K1/K4 launches per rank; one step over nccl at world
     size 1 equal to the plain step bit for bit; the BigVGAN GAN step
     over dp2 against one process (K3 per rank); `Synthesizer.tts` over
     dp2 and dp1×tp2 against one process (K1 per rank); and `main train`
     on two ranks with a resume, its checkpoint loaded by a one-process
     `load_synthesizer`.
The model variants and the bench tooling add:
 12. `phase_variants`: the depth-cut DeX with the DiT's conv1d time
     position, its decoder and decayed retention, card against CPU (a CPU
     control with the decoder's attention zeroed outside the bound);
     request 1 through the full-width `vctk_bench` variant beside the
     plain model, in turns (K1 400 against 200 per call); one ESD train
     step with the decoder under "flash_bf16" (K1 8 + 8, every
     decoder-block gradient non-zero);
  7. (extended) the default runs of both benches with ``--profile``
     (their traces name `flash_fwd_bf16` and `mas_warp`), the FLOP count
     and 0 < MFU < 1 on every bench line;
 13. `phase_flop_count`: `entry()`'s full-size function counted on the
     card and on the CPU (`utils.mfu`), equal to 1e-6; the LF0 GRU's
     forward + backward (cuDNN's fused RNN on the card) and a DiT block's
     under flash_bf16 (K1 and its backward on the card) equal.
The YAML configs and the export add:
 14. `phase_config_export`, right after phase 9 on the BigVGAN it
     trained: `python -m dex_tts_tpu_torch.export --config <yaml>
     --vocoder` on its ``gen_last.pth`` (weight norm split, folded back
     within 1e-6 × max|W|, a scaled-``weight_g`` control outside); the
     exported file through a second YAML, bf16 (K2, 109 per call) and f32
     (K3) against the trained file loaded the same way; `python -m
     dex_tts_tpu_torch.synthesize --config` with vctk.yaml's full-width
     DeX from a checkpoint on disk (K1 200 and K2 109 per call).
The 44.1 kHz pipeline adds:
 15. `phase_44k`: configs/dex_vctk_bigvgan_v2_44k.yaml equal to its
     preset, its vocoder read from the release's config.json beside
     ``gen_last.pth``; `python -m dex_tts_tpu_torch.synthesize --config`
     on it with a seeded 128-band DeX from a checkpoint on disk and a
     seeded BigVGAN-v2 (no ``conv_post.bias``, clamp head),
     from text and reference WAVs at 16 kHz and 44.1 kHz, and a paragraph
     with --long: 44,100 Hz WAVs of 512 samples a frame (and 0.2 s pauses
     at 44.1 kHz), K1 64, K2 109 and K5 416 per call at 16 dpmpp2m steps.
The last two lines are the `kernels` JSON line and the device JSON line.
Needs one card; exits non-zero without CUDA.
"""

import contextlib
import io
import json
import math
import os
import re
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
V2_44K_SHAPE = (16, 6144, 2, 128)  # the 128-band DeX of the 44.1 kHz cell: 32 × 192 patches
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
# BigVGAN-v2 44 kHz 512x at 16 × 768 frames (rates 8, 4, 2, 2, 2, 2), the
# same launches per stage
SNAKE_STAGES_V2_44K = [(16, 6144, 768), (16, 24576, 384), (16, 49152, 192),
                       (16, 98304, 96), (16, 196608, 48), (16, 393216, 24)]
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


def speech_like(rng, sr: int) -> np.ndarray:
    """One speech-like recording at ``sr`` from ``rng``: 2.6-3.0 s of eight
    harmonics (amplitude 1/h) whose F0 glides between 100 and 250 Hz,
    under a 4 Hz syllable envelope, with 0.3 s of near-silence (-50 dB) on
    each side for the trim."""
    tt = np.arange(int((2.6 + 0.4 * rng.random()) * sr)) / sr
    f0 = 175.0 + 75.0 * np.sin(2 * np.pi * (0.3 + 0.4 * rng.random()) * tt
                               + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(np.sin(h * phase) / h for h in range(1, 9))
    env = 0.2 + 0.8 * (0.5 - 0.5 * np.cos(2 * np.pi * 4.0 * tt))
    margin = int(0.3 * sr)
    return np.concatenate([
        1e-3 * rng.standard_normal(margin),
        0.3 * voice * env + 3e-3 * rng.standard_normal(len(tt)),
        1e-3 * rng.standard_normal(margin),
    ])


def write_int16_wav(path: str, wav: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile

    wavfile.write(path, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))


def write_reference_wavs(directory: str, n: int, seed: int = 7) -> list[str]:
    """``n`` speech-like reference recordings (`speech_like`) as 16 kHz
    int16 WAV files. → the file paths."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        paths.append(os.path.join(directory, f"ref_{i}.wav"))
        write_int16_wav(paths[-1], speech_like(rng, REF_SR), REF_SR)
    return paths


VCTK_SR = 48000  # VCTK's recording rate


def write_vctk_corpus(root: str, n_speakers: int = 2, n_utts: int = 8, seed: int = 12) -> list[str]:
    """A corpus in VCTK's layout from a seed: ``wav48/pNNN/pNNN_00k.wav``
    (`speech_like` at 48 kHz, int16) and ``txt/pNNN/pNNN_00k.txt``, the
    transcripts taken from SENTENCES in turn. → the speaker names."""
    rng = np.random.default_rng(seed)
    speakers = [f"p{225 + s}" for s in range(n_speakers)]
    for s, spk in enumerate(speakers):
        for sub in ("wav48", "txt"):
            os.makedirs(os.path.join(root, sub, spk), exist_ok=True)
        for k in range(n_utts):
            base = f"{spk}_{k + 1:03d}"
            write_int16_wav(os.path.join(root, "wav48", spk, base + ".wav"),
                            speech_like(rng, VCTK_SR), VCTK_SR)
            with open(os.path.join(root, "txt", spk, base + ".txt"), "w") as f:
                f.write(SENTENCES[(s * n_utts + k) % len(SENTENCES)] + "\n")
    return speakers


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
        for shape in [MAIN_SHAPE, (2, 1, 2, 128), (2, 63, 2, 128), (2, 777, 2, 128),
                      V2_44K_SHAPE]:
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
                    ((2, 4097, 3), 12, "gapped")]
                 + [(shape, 12, "bct") for shape in SNAKE_STAGES_V2_44K])
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


# K5: the U-Net Block epilogues of one denoiser call in both benchmark
# cells (batch 16, 768-frame bucket, dec_dim 64, dim_mults (1, 2)): shape
# → Blocks at it (13 in all)
GN_CELL_BLOCKS = {(16, 64, 80, 768): 5, (16, 128, 40, 384): 4, (16, 64, 40, 384): 4}
# the same Blocks of the 44.1 kHz cell's 128-band denoiser
GN_V2_44K_BLOCKS = {(16, 64, 128, 768): 5, (16, 128, 64, 384): 4, (16, 64, 64, 384): 4}
GN_MORE_SHAPES = [
    (1, 64, 80, 64),     # a 64-frame bucket at batch 1: 8 slabs
    (4, 64, 80, 64),     # batch 4: 32 slabs
    (16, 64, 80, 2048),  # a 2048-frame bucket
    (3, 64, 80, 77),     # W not a multiple of a load: loads cross frame rows
    (2, 16, 5, 7),       # H·W odd: one element per load
]


def gn_inputs(shape, dtype, seed, shift=True, strided_mask=False):
    """h as a convolution leaves it, f32 affine parameters near the
    trained ones, a mask with a masked tail on every item but the first
    (a strided view, as the U-Net's lower resolutions take it, if asked),
    and the time MLP's f32 shift or None."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, c, _, w = shape
    x = (1.5 * torch.randn(shape, generator=g, device="cuda") + 0.3).to(dtype)
    weight = 1 + 0.2 * torch.randn(c, generator=g, device="cuda")
    bias = 0.2 * torch.randn(c, generator=g, device="cuda")
    wide = 2 * w if strided_mask else w
    lengths = torch.randint(wide // 2, wide + 1, (b,), generator=g, device="cuda")
    lengths[0] = wide
    mask = (torch.arange(wide, device="cuda")[None] < lengths[:, None]).to(dtype)[:, None, None]
    if strided_mask:
        mask = mask[..., ::2]
    return x, weight, bias, mask, (torch.randn(b, c, generator=g, device="cuda") if shift else None)


def phase_group_norm():
    """K5 (`ops/group_norm.group_norm_mish`) against the plain version on
    the card, in bf16 and f32: the cells' Block shapes (80 and 128 bands),
    a 64-frame bucket at batch 1 and 4, a 2048-frame bucket, loads across frame rows and
    single-element loads; masked tails, contiguous and strided masks, with
    and without the shift. The truth is the plain version in f32 on the
    same inputs; the plain version in the input dtype (the earlier design)
    is measured against it too. Then times at every shape: K5, the plain
    version, and the bound (h read once, y written once)."""
    from dex_tts_tpu_torch.ops import group_norm as gn
    from dex_tts_tpu_torch.ops.kernels import resource_usage

    gn._kernel()  # builds group_norm.cu
    build = resource_usage("group_norm.cu")
    for line in build:
        log(f"K5 ptxas {line}")
    spilled = [line for line in build
               if "0 bytes spill stores" not in line or "0 bytes spill loads" not in line]
    shapes = list(GN_CELL_BLOCKS) + GN_MORE_SHAPES + list(GN_V2_44K_BLOCKS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report = {}
    # bf16: one rounding of the result, ≤ 2^-8 of it, over the f32 truth;
    # f32: the sums' order, rsqrtf and __expf (a few ulp)
    tolerances = {torch.bfloat16: (2**-8, 1e-5), torch.float32: (2e-5, 2e-5)}
    for dtype, (rtol, atol) in tolerances.items():
        worst = plain_worst = 0.0
        timings = []
        for i, shape in enumerate(shapes):
            x, weight, bias, mask, shift = gn_inputs(shape, dtype, seed=i, shift=i % 2 == 0,
                                                     strided_mask=i % 3 == 1)
            want = gn.group_norm_mish_reference(x.float(), weight, bias, mask.float(), shift)
            plain = gn.group_norm_mish_reference(x, weight, bias, mask, shift)
            masked = (mask == 0).expand_as(x)
            tail = torch.zeros_like(x) if shift is None else shift[:, :, None, None].expand_as(x)
            b, c, h, w = shape
            chunks = gn.two_pass_chunks(b * 8, c // 8 * h * w // gn.vector_width(shape, dtype),
                                        sms)
            before = gn.group_norm_mish.launches
            got = gn.group_norm_mish(x, weight, bias, mask, shift)
            torch.cuda.synchronize()
            assert gn.group_norm_mish.launches - before == 2
            err = (got.float() - want).abs()
            ratio = (err / (rtol * want.abs() + atol)).max().item()
            assert got.dtype == dtype and math.isfinite(ratio) and ratio <= 1, (
                dtype, shape, ratio)
            assert torch.equal(got[masked], tail.to(dtype)[masked]), (dtype, shape)
            worst = max(worst, err.max().item())
            plain_err = (plain.float() - want).abs().max().item()
            plain_worst = max(plain_worst, plain_err)
            row = dict(shape=list(shape), chunks=chunks)
            row["ms"] = time_ms(lambda: gn.group_norm_mish(x, weight, bias, mask, shift), 20)
            row["plain_ms"] = time_ms(lambda: gn.group_norm_mish_reference(x, weight, bias, mask,
                                                                           shift), 5)
            row["bound_ms"] = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
            row["bound_share"] = row["bound_ms"] / row["ms"]
            timings.append(row)
            log(f"K5 {dtype} {shape} ({chunks} chunks a slab): max_abs_err"
                f" {err.max().item():.3e} (plain {plain_err:.3e}); {row['ms']:.4f} ms, plain"
                f" {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms,"
                f" {100 * row['bound_share']:.1f}% of the bound")
        # one denoiser call of the cells: each Block shape's time × its Blocks
        per_step = {key: sum(r[key] * GN_CELL_BLOCKS[tuple(r["shape"])] for r in timings
                             if tuple(r["shape"]) in GN_CELL_BLOCKS)
                    for key in ("ms", "plain_ms", "bound_ms")}
        report[dtype] = dict(max_abs_err=worst, plain_max_abs_err=plain_worst,
                             tolerance=f"rtol {rtol:.3g} atol {atol:.3g} against plain f32",
                             shapes=timings, build=build, bound_by="bytes", library_ms=None,
                             **per_step)
        log(f"K5 {dtype}, one denoiser call of the cells (13 Blocks): kernel {per_step['ms']:.4f}"
            f" ms, plain {per_step['plain_ms']:.4f} ms, bound {per_step['bound_ms']:.4f} ms,"
            f" {100 * per_step['bound_ms'] / per_step['ms']:.1f}% of the bound; largest error"
            f" {worst:.3e} (plain {plain_worst:.3e})")
    assert build and not spilled, spilled
    return report


# BigVGAN's snake inputs (B, T, C) in a vocoder train step at the CLI's
# batch 16 × segment 8192 (32 mel frames), with the same launches per stage
SNAKE_TRAIN_STAGES = [(16, 128, 768), (16, 512, 384), (16, 1024, 192),
                      (16, 2048, 96), (16, 4096, 48), (16, 8192, 24)]


def phase_snake_grad():
    """The snake under autograd on the card (`SnakeKernelFunction`: the
    kernel forward, the plain backward with the exact sine) against
    autograd through the plain version, bf16 (polynomial forward) and f32,
    at the vocoder train step's six stage shapes and one ragged shape: the
    gradients for x, alpha and inv_beta bit-equal (cuDNN in its
    deterministic mode; the plain version's replicate padding sums without
    atomics), the forward within K2's / K3's bounds, one launch per forward
    and none in the backward. Then, per stage shape × its launches, the
    device time of kernel forward + plain backward (what one train step
    spends in the snakes), of the kernel forward alone and of the plain
    forward + backward. → report per dtype."""
    from dex_tts_tpu_torch.ops.snake import snake_antialias, snake_antialias_reference

    report = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dtype, impl, fast in ((torch.bfloat16, "auto", True), (torch.float32, "pallas", False)):
            worst = 0.0
            g = torch.Generator(device="cuda").manual_seed(41)
            for i, shape in enumerate(SNAKE_TRAIN_STAGES + [(3, 777, 24)]):
                x, al, ib = snake_inputs(*shape, dtype, seed=200 + i)
                dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
                ins = [v.clone().requires_grad_(True) for v in (x, al, ib)]
                snake_antialias.launches = 0
                y = snake_antialias(*ins, impl=impl)
                fwd_launches = snake_antialias.launches
                y.backward(dy)
                torch.cuda.synchronize()
                assert (fwd_launches, snake_antialias.launches) == (1, 1), (
                    fwd_launches, snake_antialias.launches)
                plain = [v.clone().requires_grad_(True) for v in (x, al, ib)]
                snake_antialias_reference(*plain, 12, False).backward(dy)
                for name, a, b in zip(("x", "alpha", "inv_beta"), ins, plain):
                    assert a.grad.dtype == b.grad.dtype == dtype, (name, a.grad.dtype)
                    assert torch.equal(a.grad, b.grad), (dtype, shape, name)
                want = snake_antialias_reference(x, al, ib, 12, fast)
                err = (y.detach().float() - want.float()).abs().max().item()
                bound = (8e-3 * want.float().abs().max().item() if dtype == torch.bfloat16
                         else 2e-5)
                assert math.isfinite(err) and err <= bound, (dtype, shape, err, bound)
                worst = max(worst, err)
            stages = []
            for shape, n in zip(SNAKE_TRAIN_STAGES, SNAKE_STAGE_LAUNCHES):
                x, al, ib = snake_inputs(*shape, dtype, seed=0)
                dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
                ins = [v.clone().requires_grad_(True) for v in (x, al, ib)]

                def kernel_fwd_bwd():
                    snake_antialias(*ins, impl=impl).backward(dy)

                def plain_fwd_bwd():
                    snake_antialias_reference(*ins, 12, False).backward(dy)

                stages.append(dict(
                    shape=list(shape), launches=n,
                    fwd_bwd_ms=time_ms(kernel_fwd_bwd, 5),
                    fwd_ms=time_ms(lambda: snake_antialias(x, al, ib, impl=impl), 10),
                    plain_fwd_bwd_ms=time_ms(plain_fwd_bwd, 5)))
            per_step = {k: sum(st[k] * st["launches"] for st in stages)
                        for k in ("fwd_bwd_ms", "fwd_ms", "plain_fwd_bwd_ms")}
            per_step["plain_bwd_ms"] = per_step["fwd_bwd_ms"] - per_step["fwd_ms"]
            report[dtype] = dict(max_abs_err_fwd=worst, grads_bit_equal=True, stages=stages,
                                 per_train_step=per_step)
            log(f"snake under autograd, {dtype}: gradients bit-equal to the plain version's at"
                f" {len(SNAKE_TRAIN_STAGES) + 1} shapes, forward max_abs_err {worst:.3e}, launches"
                f" 1 per forward / 0 per backward; per vocoder train step ({SNAKE_LAUNCHES}"
                f" snakes at 16 x 8192): kernel fwd + plain bwd {per_step['fwd_bwd_ms']:.3f} ms"
                f" (kernel fwd {per_step['fwd_ms']:.3f}, plain bwd {per_step['plain_bwd_ms']:.3f}),"
                f" plain fwd + bwd {per_step['plain_fwd_bwd_ms']:.3f} ms")
    finally:
        torch.backends.cudnn.deterministic = saved
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


def depth_cut_dex(use_decay: bool = False, **dit_overrides):
    """The card-vs-CPU DeX: the VCTK preset with 2 text-encoder, TV and
    TIV layers and a 1-block DiT (attention "flash", ``dit_overrides``),
    every parameter perturbed, on the CPU and a copy on the card, and
    inputs from a seed for 820 DiT tokens → (config, CPU model, card
    model, run(model, device, sampler) → `synthesize`'s outputs)."""
    import copy
    import dataclasses

    from dex_tts_tpu_torch.config import load_preset
    from dex_tts_tpu_torch.models.tts import build_tts

    cfg = load_preset("vctk").model
    cfg = dataclasses.replace(
        cfg, enc_layers=2, tv_layers=2, tiv_layers=2, use_decay=use_decay,
        dit=dataclasses.replace(cfg.dit, depth=1, attention="flash", **dit_overrides),
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

    return cfg, cpu_model, gpu_model, run


def phase_card_vs_cpu():
    """Same port, same weights and noise: CPU (plain attention) vs card
    (kernel), f32, TF32 off."""
    from unittest import mock

    from dex_tts_tpu_torch.models import dit
    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.ops.attention import flash_attention

    cfg, cpu_model, gpu_model, run = depth_cut_dex()

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


VOCODER_LOSS_RTOL = 1e-4  # card vs CPU vocoder step, f32 with TF32 off
# per tensor, error ≤ rel × (max|g| + 1e-3 × the largest): the critics'
# gradients as the DeX train step's; the generator's looser. The two
# generators' outputs already differ (4.0e-5 at a std of 0.3: 109 snakes
# with the kernel's sinf, in a net whose perturbed weights amplify), the
# critics' leaky ReLUs turn that into 1.3-5.7e-3 (relative) in the
# gradient that reaches the waveform, and sums with cancellation (snake
# alpha, biases, ups.0) carry it to 6.7e-3 of the scale in the worst
# tensors, 2e-4 in the median one (measured on an H100). A
# wrong backward moves most tensors, so the median has the DeX bound.
VOCODER_GRAD_REL = {"critic": 1e-3, "generator": 5e-2}
VOCODER_GRAD_MEDIAN_REL = 1e-3


def phase_vocoder_card_vs_cpu():
    """One vocoder GAN step's losses and gradients, card against CPU: the
    full-width BigVGAN (`BigVGANConfig()`: 1536 channels, rates (4, 4, 2,
    2, 2, 2), f32, TF32 off) with the default MPD/MRD on 2 × 2048
    samples, the same weights on both sides (the generator moved off the
    reference init as in `phase_bigvgan_card_vs_cpu`, so the snakes shape
    the output). The critics' loss and every critic gradient on each
    side's generator output (the card's through the snake kernel); then
    the CPU's critic update is copied to the card and the generator's loss
    parts and every generator gradient (of the total, as a step takes it)
    are compared against those same updated critics (bounds at
    `VOCODER_GRAD_REL`, the median generator tensor at the DeX step's).
    A CPU control with every snake replaced by its input must land more
    than 10× outside the bounds. → report."""
    import copy
    from unittest import mock

    from dex_tts_tpu_torch.audio.stft import MelSpectrogram
    from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, bigvgan
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.train import vocoder as tv

    cpu = tv.create_vocoder_train_state(BigVGANConfig(), seed=31, device="cpu")
    mel_input, mel_loss = MelSpectrogram(), MelSpectrogram(fmax=11025.0)
    rng = np.random.default_rng(33)
    tt = np.arange(2048) / 22050.0
    wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (2, 1)) * tt * (1 + 2 * tt))
    wav = torch.from_numpy((wav + 0.01 * rng.standard_normal(wav.shape)).astype(np.float32))
    g = torch.Generator().manual_seed(32)
    with torch.no_grad():
        for name, p in cpu.generator.named_parameters():
            if name.endswith((".alpha", ".beta")):
                p.add_(0.5 * torch.randn(p.shape, generator=g))
            elif name.endswith("weight") and not name.startswith("conv_pre"):
                p.mul_(2.0)
        # conv_post scaled so the generated waveform has a std near 0.3:
        # unsaturated, and its log-mel above the 1e-5 floor, where the L1
        # mel term has a gradient
        post = cpu.generator.conv_post
        scale = 0.3 / cpu.generator(tv.vocoder_mels(wav, mel_input, mel_loss)[0]).std()
        post.weight.mul_(scale)
        post.bias.mul_(scale)
    generator = copy.deepcopy(cpu.generator).cuda()
    critics = copy.deepcopy(cpu.critics).cuda()

    def critic_side(gen, crit, device):
        w = wav.to(device)
        mel_in, target = tv.vocoder_mels(w, mel_input, mel_loss)
        fake = gen(mel_in)
        crit.zero_grad(set_to_none=True)
        loss_d = tv.critic_loss(crit, w, fake.detach())
        loss_d.backward()
        return ({"loss_disc": loss_d.item()},
                {n: p.grad.detach().cpu() for n, p in crit.named_parameters()}, fake, target)

    def generator_side(gen, crit, fake, target, device):
        crit.requires_grad_(False)
        try:
            losses = tv.generator_losses(crit, wav.to(device), fake, target, mel_loss, 45.0)
            names, params = zip(*gen.named_parameters())
            # unused: alpha and beta in the control without snakes
            got = torch.autograd.grad(losses["loss_gen"], params, allow_unused=True)
            grads = {n: torch.zeros(p.shape) if v is None else v.detach().cpu()
                     for n, p, v in zip(names, params, got)}
        finally:
            crit.requires_grad_(True)
        return {k: v.item() for k, v in losses.items()}, grads

    def worst_ratio(got, want):
        """(max of error / bound over the losses and every gradient, where,
        the median generator tensor's error / (max|g| + 1e-3 × top))."""
        rows = [(abs(got[0][k] - v) / (VOCODER_LOSS_RTOL * abs(v)), k) for k, v in want[0].items()]
        median = None
        for i, part in ((1, "critic"), (2, "generator")):
            top = max(v.abs().max().item() for v in want[i].values())
            assert top > 0, f"every {part} gradient is 0: the comparison would be empty"
            assert sorted(got[i]) == sorted(want[i])
            scaled = [((got[i][n] - v).abs().max().item() / (v.abs().max().item() + 1e-3 * top),
                       f"{part} {n}") for n, v in want[i].items()]
            rows += [(e / VOCODER_GRAD_REL[part], n) for e, n in scaled]
            if part == "generator":
                median = sorted(e for e, _ in scaled)[len(scaled) // 2]
        return (*max(rows), median)

    def cpu_run():
        losses_d, grads_d, fake, target = critic_side(cpu.generator, cpu.critics, "cpu")
        losses_g, grads_g = generator_side(cpu.generator, updated, fake, target, "cpu")
        return {**losses_d, **losses_g}, grads_d, grads_g

    # the critics after the CPU's update: both sides' generator objective
    # runs against these
    losses_d, grads_d, fake, target = critic_side(cpu.generator, cpu.critics, "cpu")
    updated = copy.deepcopy(cpu.critics)
    for p, grad in zip(updated.parameters(), grads_d.values()):
        p.grad = grad.clone()
    tv.make_vocoder_optimizer(updated).step()
    losses_g, grads_g = generator_side(cpu.generator, updated, fake, target, "cpu")
    want = ({**losses_d, **losses_g}, grads_d, grads_g)
    with mock.patch.object(bigvgan, "snake_antialias", lambda x, *a, **kw: x):
        control = worst_ratio(cpu_run(), want)
    snake_antialias.launches = 0
    got_d, got_grads_d, fake, target = critic_side(generator, critics, "cuda")
    fwd_launches = snake_antialias.launches
    got_g, got_grads_g = generator_side(generator, copy.deepcopy(updated).cuda(), fake, target,
                                        "cuda")
    torch.cuda.synchronize()
    assert (fwd_launches, snake_antialias.launches) == (SNAKE_LAUNCHES, SNAKE_LAUNCHES), (
        fwd_launches, snake_antialias.launches)
    ratio = worst_ratio(({**got_d, **got_g}, got_grads_d, got_grads_g), want)
    log(f"vocoder GAN step card vs CPU (f32, full-width BigVGAN + MPD/MRD, 2 x 2048 samples):"
        f" losses {dict(got_d, **got_g)} vs {want[0]}; worst error/bound {ratio[0]:.3e}"
        f" ({ratio[1]}), median generator tensor {ratio[2]:.3e} x (max|g| + 1e-3 x top);"
        f" control, snakes removed on the CPU: {control[0]:.3e} ({control[1]}); snake launches"
        f" {snake_antialias.launches} (bounds: losses rtol {VOCODER_LOSS_RTOL}, grads"
        f" {VOCODER_GRAD_REL} x (max|g| + 1e-3 x top), generator median"
        f" {VOCODER_GRAD_MEDIAN_REL})")
    assert ratio[0] <= 1.0 and ratio[2] <= VOCODER_GRAD_MEDIAN_REL, ratio
    assert control[0] > 10, control
    return dict(worst_ratio=ratio[0], generator_median=ratio[2], control_ratio=control[0],
                launches=snake_antialias.launches)


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


def build_train_path(attention: str, **dit_overrides):
    """The training main path on the card: the ESD preset at full width
    with DiT attention ``attention`` (and ``dit_overrides``: a DiT
    variant), its train state (seed 100) and step, and bench_train's
    batch → (model config, resolved attention mode, state, step, batch)."""
    from dex_tts_tpu_torch.config import build_model, load_preset
    from dex_tts_tpu_torch.models.dit import resolve_attention_mode, token_count
    from dex_tts_tpu_torch.train import create_train_state, make_train_step

    preset = with_dit(load_preset("esd"), attention=attention, **dit_overrides)
    cfg = preset.model
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
    width under attention "flash_bf16", batch 4, two epochs over 16
    utterances written to disk from a seed.
      * ``--init_from`` a reference-layout DeX checkpoint the phase writes
        (``model-last.pth`` with a distinct EMA): a fresh state's weights,
        buffers and EMA equal the file's, and the fit starts from it;
      * synthesis every epoch (``syn_every=1``) with a HiFi-GAN written as
        the reference ships it: the sample WAVs appear, each mel MAE is
        finite, and K1 launches 2 samples × depth × 50 steps per call;
      * the checkpoint files appear, and a resume from "last" repeats the
        next step (same weights, optimizer, EMA and generator; same losses);
      * a SIGTERM raised inside the train loader: ``last`` and ``preempt``
        are written, `fit` returns early, the signal handlers come back,
        and a resume from ``preempt`` repeats the next step."""
    import dataclasses
    import signal
    from unittest import mock

    from dex_tts_tpu_torch import main as port_main
    from dex_tts_tpu_torch.config import build_model, build_vocoder, load_preset
    from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig
    from dex_tts_tpu_torch.ops.attention import flash_attention
    from dex_tts_tpu_torch.train import create_train_state, make_train_step
    from dex_tts_tpu_torch.train.trainer import metrics_to_host

    train_path, val_path = write_training_set(os.path.join(directory, "data"), 16)
    voc_dir = os.path.join(directory, "hifigan")
    torch.manual_seed(42)
    vocoder = build_vocoder(HiFiGANConfig(), device="cuda")
    perturb_(vocoder, seed=42, scale=0.002)
    write_hifigan_release(voc_dir, vocoder)
    del vocoder
    esd = load_preset("esd")
    preset = dataclasses.replace(
        esd, train_path=train_path, val_path=val_path, vocoder_path=voc_dir,
        model=dataclasses.replace(esd.model, dit=dataclasses.replace(esd.model.dit,
                                                                     attention="flash_bf16")),
        train=dataclasses.replace(esd.train, epoch=2, batch_size=4, syn_every=1))

    # --init_from: a reference-layout checkpoint with a distinct EMA
    ref_exp = os.path.join(directory, "reference_exp")
    os.makedirs(ref_exp)
    torch.manual_seed(43)
    source = build_model(preset.model, device="cuda")
    perturb_(source, seed=43)
    weights = {k: v.detach().cpu() for k, v in source.state_dict().items()}
    ema = {k: v + 0.01 if v.is_floating_point() else v for k, v in weights.items()}
    torch.save({"scores": {}, "state_dict": weights, "ema": ema, "optimizer": {}},
               os.path.join(ref_exp, "model-last.pth"))
    del source
    torch.manual_seed(5)
    warm = create_train_state(build_model(preset.model, device="cuda"), seed=5)
    port_main.warm_start_state(warm, ref_exp)
    for k, v in warm.model.state_dict().items():
        assert torch.equal(v.cpu(), weights[k]), k
    assert all(torch.equal(v.cpu(), ema[k]) for k, v in warm.ema.items())
    del warm

    syn_calls = []
    make_callback = port_main.make_synthesis_callback

    def counted_callback(*args, **kwargs):
        syn_fn = make_callback(*args, **kwargs)

        def counted(state, epoch):
            before = flash_attention.launches
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                syn_fn(state, epoch)
            syn_calls.append(dict(epoch=epoch, flash_attention=flash_attention.launches - before,
                                  mel_mae=[float(v) for v in re.findall(r"mel_mae=(\S+)",
                                                                        out.getvalue())]))
            assert state.model.training, "periodic synthesis left the model in eval mode"

        return counted

    exp = os.path.join(directory, "exp")
    t0 = time.perf_counter()
    flash_attention.launches = 0
    with mock.patch.object(port_main, "make_synthesis_callback", counted_callback):
        trainer = port_main.train(preset, exp, seed=1, device="cuda", init_from=ref_exp)
    wall = time.perf_counter() - t0
    fit_launches = flash_attention.launches
    names = sorted(os.listdir(os.path.join(exp, "ckpt")))
    assert {"last.pth", "best-train.pth", "best-val.pth"} <= set(names), names
    samples = sorted(os.listdir(os.path.join(exp, "sample")))
    assert samples == ["epoch1_0.wav", "epoch1_1.wav", "epoch2_0.wav", "epoch2_1.wav"], samples
    per_call = 2 * preset.model.dit.depth * 50
    assert [c["flash_attention"] for c in syn_calls] == [per_call, per_call], syn_calls
    assert all(len(c["mel_mae"]) == 2 and all(map(math.isfinite, c["mel_mae"]))
               for c in syn_calls), syn_calls
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

    def assert_repeats(live, resumed, label):
        want = metrics_to_host(step(live, batch))
        got = metrics_to_host(step(resumed, batch))
        for k in want:
            if k == "grad_norm":  # reductions in the backward need not repeat bit for bit
                assert math.isclose(got[k], want[k], rel_tol=1e-4), (label, k, got[k], want[k])
            else:
                assert got[k] == want[k], (label, k, got[k], want[k])
        return want

    want = assert_repeats(state, fresh, "last")
    log(f"Trainer.fit (esd width, flash_bf16, batch 4, 2 epochs x 4 steps, --init_from, syn_every"
        f" 1) {wall:.1f} s, checkpoints {names}, samples {samples}; synthesis per epoch"
        f" {syn_calls}; K1 launches over the fit {fit_launches}; next step live {want}, resumed"
        f" equal [{card}]")
    del trainer, state, fresh

    # SIGTERM inside the train loader of the entry point
    make_loaders = port_main.make_loaders

    def interrupted(preset, seed):
        train_fn, valid_fn, ds = make_loaders(preset, seed)

        def train_loader():
            for i, b in enumerate(train_fn()):
                if i == 2:
                    signal.raise_signal(signal.SIGTERM)
                yield b

        return train_loader, valid_fn, ds

    stop_exp = os.path.join(directory, "stopped")
    before = signal.getsignal(signal.SIGTERM)
    no_syn = dataclasses.replace(preset, train=dataclasses.replace(preset.train, syn_every=0))
    with mock.patch.object(port_main, "make_loaders", interrupted):
        stopped = port_main.train(no_syn, stop_exp, seed=1, device="cuda")
    assert signal.getsignal(signal.SIGTERM) == before
    assert stopped.state.step == 2, stopped.state.step
    stop_names = sorted(os.listdir(os.path.join(stop_exp, "ckpt")))
    assert stop_names == ["last.pth", "preempt.pth"], stop_names
    torch.manual_seed(6)
    resumed = create_train_state(build_model(preset.model, device="cuda"), seed=6)
    stopped.ckpt.restore(resumed, "preempt")
    assert resumed.step == 2
    preempt_next = assert_repeats(stopped.state, resumed, "preempt")
    log(f"SIGTERM in the loader at batch 3 of epoch 1: fit returned at step 2, checkpoints"
        f" {stop_names}, handlers restored; next step live and resumed from preempt equal"
        f" ({preempt_next}) [{card}]")
    del stopped, resumed
    torch.cuda.empty_cache()
    return dict(checkpoints=names, wall_s=wall, next_step=want, synthesis=syn_calls,
                fit_flash_launches=fit_launches, preempt_checkpoints=stop_names)


VOCODER_STEPS = 12  # BigVGAN steps of the vocoder training main path
VOCODER_STEPS_HIFIGAN = 4


def phase_vocoder_train(card: str, directory: str) -> dict:
    """The vocoder training main path: `python -m
    dex_tts_tpu_torch.train_vocoder --vocoder bigvgan` in this process at
    the CLI's defaults (full-width f32 BigVGAN, default MPD/MRD, batch 16,
    segment 8192) on 16 reference WAVs the phase writes, ``VOCODER_STEPS``
    steps, PyTorch's TF32 defaults. The snake count is set to 0 just
    before and read just after: 109 K3 launches per step, each step's
    counted. A finite, non-zero gradient on every generator parameter in
    the first step. Steps/s over the steps after the first and peak memory
    are logged with the card line. Then ``gen_last.pth`` loads strictly
    through `load_vocoder` (on the CPU in f32: the trained generator's
    output bit for bit; on the card, where it serves in bf16: the trained
    weights in bf16, bit for bit), a resume from ``last`` repeats the next
    step, and ``VOCODER_STEPS_HIFIGAN`` steps of ``--vocoder hifigan`` run
    with no snake launch. → report."""
    import copy
    import dataclasses
    from unittest import mock

    from dex_tts_tpu_torch import train_vocoder
    from dex_tts_tpu_torch.audio.stft import MelSpectrogram
    from dex_tts_tpu_torch.config import build_vocoder, load_preset
    from dex_tts_tpu_torch.data.vocoder_dataset import WavSegmentDataset, wav_paths_from_source
    from dex_tts_tpu_torch.eval.evaluation import load_vocoder
    from dex_tts_tpu_torch.models.vocoder import BigVGANConfig
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.train import vocoder as tv

    wav_dir = os.path.join(directory, "wavs")
    os.makedirs(wav_dir)
    write_reference_wavs(wav_dir, 16)
    make_step = tv.make_vocoder_train_step

    def run(kind, steps):
        """The CLI in-process → (state, its stdout's JSON lines, per-step
        snake launches, end time of each step, first step's gradient
        checks, peak GiB, ckpt_dir)."""
        per_step, ends, first = [], [], {}

        def counted_factory(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def counted(state, batch):
                before = snake_antialias.launches
                metrics = step(state, batch)
                per_step.append(snake_antialias.launches - before)
                if state.step == 1:
                    grads = [(n, p.grad) for n, p in state.generator.named_parameters()]
                    finite = torch.stack([g.isfinite().all() for _, g in grads]).cpu().tolist()
                    nonzero = torch.stack([g.abs().max() > 0 for _, g in grads]).cpu().tolist()
                    first.update(n=len(grads),
                                 bad=[n for (n, _), f, z in zip(grads, finite, nonzero)
                                      if not (f and z)])
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
                return metrics

            return counted

        ckpt_dir = os.path.join(directory, f"ckpt_{kind}")
        argv = ["--data", wav_dir, "--vocoder", kind, "--steps", str(steps), "--log_every", "2",
                "--ckpt_dir", ckpt_dir]
        out = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(train_vocoder, "make_vocoder_train_step", counted_factory):
            snake_antialias.launches = 0
            with contextlib.redirect_stdout(out):
                state = train_vocoder.main(argv)
            launches = snake_antialias.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
        for line in lines:
            log(f"[train_vocoder {kind}] {json.dumps(line)}")
        return state, lines, launches, per_step, ends, first, peak, ckpt_dir

    state, lines, launches, per_step, ends, first, peak, ckpt_dir = run("bigvgan", VOCODER_STEPS)
    steps_per_s = (VOCODER_STEPS - 1) / (ends[-1] - ends[0])
    log(f"[vocoder train, BigVGAN f32 full width, MPD/MRD, 16 x 8192] {VOCODER_STEPS} steps:"
        f" {steps_per_s:.4f} steps/s after the first ({(ends[-1] - ends[0]) / (VOCODER_STEPS - 1):.4f}"
        f" s per step), peak memory {peak:.2f} GiB, snake launches {launches} ({per_step} per"
        f" step), first step: {first['n']} generator gradients, none zero or not finite:"
        f" {not first['bad']}; last {lines[-1]} [{card}]")
    assert launches == VOCODER_STEPS * SNAKE_LAUNCHES and per_step == [SNAKE_LAUNCHES] * VOCODER_STEPS, (
        launches, per_step)
    assert first["n"] > 0 and not first["bad"], first
    assert lines and all(math.isfinite(v) for k, v in lines[-1].items() if k.startswith("loss")), lines
    assert {"last.pth", "gen_last.pth"} <= set(os.listdir(ckpt_dir))

    # the serving handoff: gen_last.pth through load_vocoder
    preset = dataclasses.replace(load_preset("vctk_bench_bigvgan"), vocoder=BigVGANConfig(),
                                 vocoder_path=ckpt_dir)
    mel = torch.randn(2, 80, 32, generator=torch.Generator().manual_seed(51))
    served_cpu = load_vocoder(preset, device="cpu")
    with torch.no_grad():
        exact = torch.equal(served_cpu(mel), copy.deepcopy(state.generator).cpu()(mel))
    del served_cpu
    served = load_vocoder(preset, device="cuda")
    trained_bf16 = build_vocoder(BigVGANConfig(dtype="bfloat16"), device="cuda")
    trained_bf16.load_state_dict(state.generator.state_dict())
    with torch.no_grad():
        same_weights = all(torch.equal(v, state.generator.state_dict()[k])
                           for k, v in served.state_dict().items())
        wav_served = served(mel.cuda())
        wav_bf16 = trained_bf16(mel.cuda())
        wav_f32 = state.generator(mel.cuda())
    served_vs_f32 = (wav_served - wav_f32).abs().max().item()
    log(f"gen_last.pth through load_vocoder: CPU f32 output equal to the trained generator's"
        f" {exact}; card (bf16) weights equal {same_weights}, output equal to the trained weights"
        f" in bf16 {torch.equal(wav_served, wav_bf16)}, {served_vs_f32:.3e} off the f32 output")
    assert exact and same_weights and torch.equal(wav_served, wav_bf16)
    del served, trained_bf16

    # a resume from "last" repeats the next step
    fresh = tv.create_vocoder_train_state(BigVGANConfig(), seed=77, device="cuda")
    tv.VocoderCheckpoints(ckpt_dir).restore(fresh, "last")
    assert fresh.step == state.step == VOCODER_STEPS
    batch = next(WavSegmentDataset(wav_paths_from_source(wav_dir), seed=5).batches(16, 1))
    step = tv.make_vocoder_train_step(MelSpectrogram(), MelSpectrogram(fmax=11025.0))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = {k: v.item() for k, v in step(state, batch).items()}
        got = {k: v.item() for k, v in step(fresh, batch).items()}
    finally:
        torch.backends.cudnn.deterministic = saved
    gen_off = max((p - q).abs().max().item()
                  for p, q in zip(state.generator.parameters(), fresh.generator.parameters()))
    log(f"vocoder resume from last: next step live {want}, resumed {got}; generators"
        f" {gen_off:.3e} apart after it [{card}]")
    # the critics' loss is a forward at equal weights; the rest follows the
    # critics' update (cuDNN deterministic); the generator's gradient passes
    # reflect-pad backwards that accumulate with atomics
    assert got["loss_disc"] == want["loss_disc"], (got, want)
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=1e-6), (k, got[k], want[k])
    assert gen_off <= 1e-6, gen_off
    del state, fresh
    torch.cuda.empty_cache()

    hifi, hifi_lines, hifi_launches, _, hifi_ends, hifi_first, hifi_peak, _ = run(
        "hifigan", VOCODER_STEPS_HIFIGAN)
    hifi_rate = (VOCODER_STEPS_HIFIGAN - 1) / (hifi_ends[-1] - hifi_ends[0])
    log(f"[vocoder train, HiFi-GAN f32, MPD/MRD, 16 x 8192] {VOCODER_STEPS_HIFIGAN} steps:"
        f" {hifi_rate:.4f} steps/s after the first, peak memory {hifi_peak:.2f} GiB, snake"
        f" launches {hifi_launches}; last {hifi_lines[-1]} [{card}]")
    assert hifi_launches == 0 and hifi.step == VOCODER_STEPS_HIFIGAN and not hifi_first["bad"]
    del hifi
    torch.cuda.empty_cache()
    return dict(bigvgan=dict(steps_per_s=steps_per_s, peak_gib=peak, launches=launches,
                             per_step=SNAKE_LAUNCHES, last=lines[-1]),
                hifigan=dict(steps_per_s=hifi_rate, peak_gib=hifi_peak, launches=hifi_launches,
                             last=hifi_lines[-1]),
                resume=dict(live=want, resumed=got, generator_off=gen_off))


EXPORT_FOLD_REL = 1e-6  # fold_weight_norm(export) vs the trained weights, × max|W| per tensor
EXPORT_WAV_REL = {"auto": 8e-3, "float32": 1e-5}  # exported vs trained BigVGAN, × max|y|
CONFIG_SEED = 17


def phase_config_export(card: str, directory: str) -> dict:
    """The YAML config system and the vocoder export, on what
    `phase_vocoder_train` left in ``directory`` (the full-width f32
    BigVGAN's ``ckpt_bigvgan/gen_last.pth``). The configs are the text of
    dex_tts_tpu/config/presets/vctk.yaml, read as a user's file, with
    ``vocoder: bigvgan`` and ``path.vocoder_path`` changed and written back
    (`utils.config.load_config`, `Config.dump`).
    (a) `python -m dex_tts_tpu_torch.export --config <yaml> --vocoder` in
    this process on ``gen_last.pth``, to a fresh directory as
    ``g_05000000``: every conv weight split (``weight_v`` the trained
    weight, bit for bit) and every other tensor unchanged; folded back, each
    weight within ``EXPORT_FOLD_REL`` × max|W| of the trained one, and a
    control with one ``weight_g`` scaled by 1.01 more than 10× outside.
    (b) the exported file through a second YAML that names it, against
    ``gen_last.pth`` loaded the same way, on the card: bf16 ("auto") within
    8e-3 × max|y|, and with ``vocoder_dtype: float32`` within 1e-5 ×
    max|y|; 109 snake launches per call. (c) `python -m
    dex_tts_tpu_torch.synthesize --config <the second yaml>` in this process
    on one sentence with vctk.yaml's full-width f32 DeX (attention "auto"),
    a seeded checkpoint saved through `CheckpointManager`, and a reference
    WAV: a finite WAV of at least 2 s, K1 and K2 counted over the call
    (expect 200 and 109), and `preset_from_config` of vctk.yaml equal to
    the `vctk` preset's model. → report."""
    from dex_tts_tpu_torch import export, synthesize
    from dex_tts_tpu_torch.audio.wav import read_wav
    from dex_tts_tpu_torch.config import build_model, load_preset, preset_from_config
    from dex_tts_tpu_torch.convert import fold_weight_norm
    from dex_tts_tpu_torch.eval.evaluation import load_vocoder
    from dex_tts_tpu_torch.ops.attention import flash_attention
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.pipeline import SAMPLE_RATE
    from dex_tts_tpu_torch.train import create_train_state
    from dex_tts_tpu_torch.train.checkpoint import CheckpointManager
    from dex_tts_tpu_torch.utils.config import Config, load_config

    t_phase = time.perf_counter()
    vctk_yaml = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dex_tts_tpu", "config",
                             "presets", "vctk.yaml")
    trained_dir = os.path.join(directory, "ckpt_bigvgan")
    trained = torch.load(os.path.join(trained_dir, "gen_last.pth"), map_location="cpu",
                         weights_only=True)

    def write_config(name, vocoder_path, **overrides):
        cfg = load_config(vctk_yaml, {"vocoder": "bigvgan", "path": {"vocoder_path": vocoder_path},
                                      **overrides})
        path = os.path.join(directory, name)
        cfg.dump(path)
        return path

    # (a) the export
    exported = os.path.join(directory, "exported", "g_05000000")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        export.main(["--config", write_config("trained.yaml", trained_dir), "--vocoder",
                     "--out", exported])
    export_s = time.perf_counter() - t0
    gen = torch.load(exported, map_location="cpu", weights_only=True)["generator"]
    split = sorted(k for k, v in trained.items() if k.endswith(".weight") and v.ndim >= 2)
    kept = sorted(set(trained) - set(split))
    assert set(gen) == set(kept) | {k + s for k in split for s in ("_g", "_v")}, \
        set(gen) ^ (set(kept) | {k + s for k in split for s in ("_g", "_v")})
    assert all(torch.equal(gen[k + "_v"], trained[k]) for k in split)
    assert all(torch.equal(gen[k], trained[k]) for k in kept)
    assert all(gen[k + "_g"].shape == trained[k].shape[:1] + (1,) * (trained[k].ndim - 1)
               for k in split)

    def fold_ratio(state):
        folded = fold_weight_norm({k: v.numpy() for k, v in state.items()})
        return max(float(np.abs(folded[k] - trained[k].numpy()).max())
                   / (EXPORT_FOLD_REL * float(trained[k].abs().max())) for k in split)

    fold_worst = fold_ratio(gen)
    control = dict(gen)
    control[split[0] + "_g"] = gen[split[0] + "_g"] * 1.01
    fold_control = fold_ratio(control)
    log(f"[config export] export --vocoder of the trained BigVGAN: {len(split)} conv weights"
        f" split, {len(kept)} tensors unchanged, {export_s:.2f} s; folded back, worst"
        f" error/bound {fold_worst:.3e} (control with one weight_g x 1.01: {fold_control:.3e})"
        f" [{card}]")
    assert fold_worst <= 1.0 and fold_control > 10.0, (fold_worst, fold_control)
    del trained, gen, control

    # (b) the exported file through a config that names it, on the card
    mel = torch.randn(1, 80, 256, generator=torch.Generator().manual_seed(CONFIG_SEED)).cuda()
    wavs = {}
    for dtype in EXPORT_WAV_REL:
        extra = {} if dtype == "auto" else {"vocoder_dtype": dtype}
        for name, voc_path in (("trained", trained_dir), ("exported", exported)):
            preset = preset_from_config(Config(write_config(f"{name}_{dtype}.yaml", voc_path,
                                                            **extra)))
            vocoder = load_vocoder(preset, device="cuda")
            want_dtype = "bfloat16" if dtype == "auto" else "float32"
            assert vocoder.cfg.dtype == want_dtype, (dtype, name, vocoder.cfg.dtype)
            with torch.no_grad():
                torch.cuda.synchronize()
                snake_antialias.launches = 0
                y = vocoder(mel).float()
                torch.cuda.synchronize()
            wavs[dtype, name] = (y, snake_antialias.launches)
            del vocoder
        (want, n_want), (got, n_got) = wavs[dtype, "trained"], wavs[dtype, "exported"]
        err = (got - want).abs().max().item()
        bound = EXPORT_WAV_REL[dtype] * want.abs().max().item()
        wavs[dtype] = dict(max_abs_err=err, bound=bound, launches=n_got)
        log(f"[config export] BigVGAN vocoder_dtype {dtype}: exported vs trained max|dy| {err:.3e}"
            f" (bound {bound:.3e}, ratio {err / bound:.3e}); snake launches {n_want} / {n_got}"
            f" [{card}]")
        assert torch.isfinite(got).all() and err <= bound, (dtype, err, bound)
        assert n_want == n_got == SNAKE_LAUNCHES, (n_want, n_got)
    torch.cuda.empty_cache()

    # (c) synthesize --config at vctk.yaml's width from a checkpoint on disk
    yaml_exported = os.path.join(directory, "exported_auto.yaml")
    preset = preset_from_config(Config(yaml_exported))
    assert preset.model == load_preset("vctk").model, "vctk.yaml != the vctk preset"
    torch.manual_seed(0)
    model = build_model(preset.model, device="cuda")
    perturb_(model, seed=3)
    with torch.no_grad():  # durations pinned, as build_main_path does
        model.encoder.proj_w.proj.weight.zero_()
        model.encoder.proj_w.proj.bias.fill_(math.log(FRAMES_PER_TOKEN))
    exp_dir = os.path.join(directory, "exp")
    CheckpointManager(os.path.join(exp_dir, "ckpt")).save(create_train_state(model), "best-train")
    del model
    ref_dir = os.path.join(directory, "ref")
    os.makedirs(ref_dir)
    ref = write_reference_wavs(ref_dir, 1)[0]
    argv = ["--config", yaml_exported, "--weight_path", exp_dir, "--input_text", SENTENCES[0],
            "--ref_name", ref, "--seed", str(CONFIG_SEED),
            "--out_dir", os.path.join(directory, "synth")]
    n_timesteps = synthesize.parse_args(argv).n_timesteps
    torch.cuda.synchronize()
    flash_attention.launches = snake_antialias.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        [(path, out)] = synthesize.main(argv)
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    k1, k2 = flash_attention.launches, snake_antialias.launches
    wav, sr = read_wav(path)
    log(f"[config export] synthesize --config (vctk.yaml, f32 DeX, attention auto, exported bf16"
        f" BigVGAN): {wav.size / sr:.3f} s of audio, {out['n_frames']} frames, {synth_s:.2f} s"
        f" with the loads; K1 {k1}, K2 {k2} per call [{card}]")
    assert sr == SAMPLE_RATE and wav.size >= 2 * SAMPLE_RATE, (sr, wav.size)
    assert wav.shape == out["wav"].shape and np.isfinite(wav).all()
    assert np.isfinite(out["wav"]).all() and np.abs(out["wav"]).max() > 0
    assert k1 == preset.model.dit.depth * n_timesteps and k2 == SNAKE_LAUNCHES, (k1, k2)
    wall = time.perf_counter() - t_phase
    log(f"[config export] phase wall {wall:.1f} s, export {export_s:.2f} s [{card}]")
    torch.cuda.empty_cache()
    return dict(export_s=export_s, wall_s=wall, fold_ratio=fold_worst, fold_control=fold_control,
                wav={k: wavs[k] for k in EXPORT_WAV_REL}, synthesize_s=synth_s,
                launches=dict(flash_attention=k1, snake=k2))


V2_44K_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dex_tts_tpu_torch",
                           "configs", "dex_vctk_bigvgan_v2_44k.yaml")
# the generator and mel keys of the config.json beside the released
# checkpoint (huggingface.co/nvidia/bigvgan_v2_44khz_128band_512x)
V2_44K_RELEASE_CONFIG = {
    "resblock": "1", "upsample_rates": [8, 4, 2, 2, 2, 2],
    "upsample_kernel_sizes": [16, 8, 4, 4, 4, 4], "upsample_initial_channel": 1536,
    "resblock_kernel_sizes": [3, 7, 11], "resblock_dilation_sizes": [[1, 3, 5]] * 3,
    "use_tanh_at_final": False, "use_bias_at_final": False, "activation": "snakebeta",
    "snake_logscale": True, "num_mels": 128, "n_fft": 2048, "hop_size": 512, "win_size": 2048,
    "sampling_rate": 44100, "fmin": 0, "fmax": None,
}


def phase_44k(card: str, directory: str) -> dict:
    """The 44.1 kHz pipeline through its YAML (phase 15 of the module
    docstring), in ``directory``. → report."""
    import dataclasses

    from dex_tts_tpu_torch import synthesize
    from dex_tts_tpu_torch.audio.wav import read_wav, resample, write_wav
    from dex_tts_tpu_torch.config import build_model, build_vocoder, load_preset, preset_from_config
    from dex_tts_tpu_torch.eval.evaluation import read_vocoder_arch
    from dex_tts_tpu_torch.ops.attention import flash_attention
    from dex_tts_tpu_torch.ops.group_norm import group_norm_mish
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.train import create_train_state
    from dex_tts_tpu_torch.train.checkpoint import CheckpointManager
    from dex_tts_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    preset = preset_from_config(load_config(V2_44K_YAML))
    want = load_preset("dex_vctk_bigvgan_v2_44k")
    assert dataclasses.replace(preset, cmu_path=want.cmu_path, vocoder=want.vocoder) == want, (
        "yaml != preset")
    torch.manual_seed(0)
    model = build_model(preset.model, device="cuda")
    perturb_(model, seed=3)
    with torch.no_grad():  # durations pinned, as build_main_path does
        model.encoder.proj_w.proj.weight.zero_()
        model.encoder.proj_w.proj.bias.fill_(math.log(FRAMES_PER_TOKEN))
    exp_dir = os.path.join(directory, "exp")
    CheckpointManager(os.path.join(exp_dir, "ckpt")).save(create_train_state(model), "best-train")
    del model
    vocoder = build_vocoder(want.vocoder, device="cpu")
    perturb_(vocoder, seed=4)
    assert vocoder.conv_post.bias is None
    voc_dir = os.path.join(directory, "bigvgan_v2")
    os.makedirs(voc_dir)
    torch.save(vocoder.state_dict(), os.path.join(voc_dir, "gen_last.pth"))
    with open(os.path.join(voc_dir, "config.json"), "w") as f:
        json.dump(V2_44K_RELEASE_CONFIG, f)
    # the YAML's vocoder as the loader settles it from the release's config.json
    assert dataclasses.replace(preset.vocoder, **read_vocoder_arch(voc_dir, True)) == want.vocoder
    del vocoder
    yaml_path = os.path.join(directory, "v2_44k.yaml")
    load_config(V2_44K_YAML, {"path": {"vocoder_path": voc_dir}}).dump(yaml_path)
    os.makedirs(os.path.join(directory, "ref"))
    refs = write_reference_wavs(os.path.join(directory, "ref"), 1)
    x, sr = read_wav(refs[0])
    refs.append(os.path.join(directory, "ref", "ref_44k.wav"))
    write_wav(refs[1], resample(x, sr, 44100), 44100)
    common = ["--config", yaml_path, "--weight_path", exp_dir, "--seed", str(CONFIG_SEED),
              "--solver", "dpmpp2m", "--n_timesteps", "16"]
    runs = {"sentence": ["--input_text", SENTENCES[0], "--ref_name", *refs,
                         "--out_dir", os.path.join(directory, "sentence")],
            "long": ["--input_text", " ".join(SENTENCES[:3]), "--ref_name", refs[1], "--long",
                     "--out_dir", os.path.join(directory, "long")]}
    report = {}
    for name, argv in runs.items():
        torch.cuda.synchronize()
        flash_attention.launches = snake_antialias.launches = group_norm_mish.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            written = synthesize.main(common + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = len(written) if name == "sentence" else 1  # --long: one batch of 3
        for path, out in written:
            wav, sr = read_wav(path)
            n = out["n_frames"] * 512 + (2 * int(44100 * 0.2) if name == "long" else 0)
            assert sr == 44100 and wav.shape == out["wav"].shape == (n,), (name, sr, wav.shape, n)
            assert np.isfinite(wav).all() and np.abs(out["wav"]).max() > 0
            assert np.abs(out["wav"]).max() <= 1.0
        k1, k2, k5 = flash_attention.launches, snake_antialias.launches, group_norm_mish.launches
        report[name] = dict(files=len(written), seconds=[read_wav(p)[0].size / 44100
                                                         for p, _ in written],
                            wall_s=wall, launches=dict(flash_attention=k1, snake=k2, group_norm=k5))
        log(f"[44.1 kHz] synthesize --config {name}: {len(written)} WAV(s) at 44100 Hz,"
            f" {report[name]['seconds']} s of audio, {wall:.2f} s with the loads; K1 {k1}, K2"
            f" {k2}, K5 {k5} [{card}]")
        assert (k1, k2, k5) == (preset.model.dit.depth * 16 * calls, SNAKE_LAUNCHES * calls,
                                K5_PER_DENOISER_CALL * 16 * calls), (k1, k2, k5)
    report["wall_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    return report


def with_dit(preset, **dit_overrides):
    """``preset`` with its DiT config changed: how a variant is reached
    without a preset of its own (the JAX YAML's ``model.dit`` keys)."""
    import dataclasses

    model = preset.model
    return dataclasses.replace(preset, model=dataclasses.replace(
        model, dit=dataclasses.replace(model.dit, **dit_overrides)))


def build_main_path(preset_name: str = "vctk_bench", **dit_overrides):
    """The benchmark's DeX (VCTK width, bf16, attention "auto") + the
    preset's vocoder (HiFi-GAN for "vctk_bench", the bf16 BigVGAN for
    "vctk_bench_bigvgan") on the card, random weights from fixed seeds →
    (preset, Synthesizer). ``dit_overrides``: a DiT variant."""
    from dex_tts_tpu_torch.config import build_model, build_vocoder, load_preset
    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.pipeline import Synthesizer

    preset = with_dit(load_preset(preset_name), **dit_overrides)
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


VARIANT = dict(pos_embed_time="conv1d", use_decoder=True)  # the DiT variants, both on


def phase_variants(card: str) -> dict:
    """The model variants: the DiT's conv1d time position embedding and its
    decoder, with the text encoder's decayed retention where a config
    reaches it.
      (a) the depth-cut DeX of `phase_card_vs_cpu` with both DiT variants
          and ``use_decay``, card against CPU (f32, TF32 off, 2 euler
          steps): the mel within MEL_ATOL, K1 2 × depth × steps (encoder
          and decoder blocks); a CPU control with the decoder blocks'
          attention zeroed lands more than 10× outside;
      (b) the `vctk_bench` DeX with both DiT variants through
          `Synthesizer.tts` at request 1's shape (K1 400 per call) beside
          the plain `vctk_bench` DeX, in turns (plain, variant, variant,
          plain) after a warm-up each: walls and RTFs;
      (c) one ESD train step with the decoder under "flash_bf16" (every
          parameter perturbed, so the zero-initialised adaLN and final
          layer pass gradients), at PyTorch's TF32 defaults: K1 8 forward
          + 8 backward, the loss finite, every decoder-block gradient
          non-zero.
    → the numbers of each part."""
    from contextlib import ExitStack
    from unittest import mock

    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from dex_tts_tpu_torch.ops.mas import maximum_path
    from dex_tts_tpu_torch.pipeline import SAMPLE_RATE
    from dex_tts_tpu_torch.train.trainer import metrics_to_host

    t0 = time.perf_counter()
    cfg, cpu_model, gpu_model, run = depth_cut_dex(use_decay=True, **VARIANT)
    euler = SamplerConfig(num_steps=2)
    want = run(cpu_model, "cpu", euler)
    flash_attention.launches = 0
    got = run(gpu_model, "cuda", euler)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    err = (got[1].cpu() - want[1]).abs().max().item()
    with ExitStack() as stack:
        for blk in cpu_model.decoder.denoise_fn.vit.decoder_blocks:
            stack.enter_context(mock.patch.object(
                blk.attn, "forward", lambda h, train=False: torch.zeros_like(h)))
        zeroed = run(cpu_model, "cpu", euler)
    zeroed_err = (zeroed[1] - want[1]).abs().max().item()
    log(f"[variants a] card vs CPU (f32, depth-cut DeX, conv1d time pos + DiT decoder + decayed"
        f" retention, 820 tokens, euler 2 steps): mel max_abs_err {err:.3e} (bound"
        f" {MEL_ATOL:.0e}), K1 launches {launches}; decoder attention zeroed on the CPU"
        f" {zeroed_err:.3e} off ({zeroed_err / MEL_ATOL:.1f}x the bound)")
    assert torch.equal(got[3].cpu(), want[3]), "y_lengths differ"
    assert launches == 2 * cfg.dit.depth * euler.num_steps, launches
    assert math.isfinite(err) and err <= MEL_ATOL, err
    assert zeroed_err > 10 * MEL_ATOL, zeroed_err
    part_a = dict(mel_err=err, control_err=zeroed_err, launches=launches,
                  wall_s=time.perf_counter() - t0)
    del cpu_model, gpu_model

    t0 = time.perf_counter()
    refs = random_ref_feats(len(SENTENCES))
    models = {"plain": build_main_path("vctk_bench"), "variant": build_main_path("vctk_bench",
                                                                                **VARIANT)}

    def request_1(name):
        preset, synth = models[name]
        torch.cuda.synchronize()
        flash_attention.launches = 0
        start = time.perf_counter()
        out = synth.tts(SENTENCES, temperature=preset.temperature, max_frames=768,
                        generator=torch.Generator("cuda").manual_seed(6), ref_feats=refs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        depth = preset.model.dit.depth
        n_dit = depth * (2 if preset.model.dit.use_decoder else 1)
        assert flash_attention.launches == n_dit * preset.n_timesteps, flash_attention.launches
        assert all(np.isfinite(r["wav"]).all() and np.isfinite(r["mel"]).all() for r in out)
        audio_s = sum(r["n_frames"] for r in out) * synth.hop / SAMPLE_RATE
        return dict(wall_s=wall, rtf=wall / audio_s, launches=flash_attention.launches,
                    audio_s=audio_s)

    for name in models:
        request_1(name)  # warm-up
    calls = [(name, request_1(name)) for name in ("plain", "variant", "variant", "plain")]
    part_b = {}
    for name in models:
        mine = [c for n, c in calls if n == name]
        part_b[name] = dict(walls_s=[c["wall_s"] for c in mine], rtfs=[c["rtf"] for c in mine],
                            launches=mine[0]["launches"])
    log(f"[variants b] request 1 (16 x long, 768-frame bucket, euler 50) through"
        f" Synthesizer.tts, in turns plain/variant/variant/plain: plain vctk_bench walls"
        f" {part_b['plain']['walls_s']} s, RTFs {part_b['plain']['rtfs']}, K1"
        f" {part_b['plain']['launches']}; conv1d + decoder walls {part_b['variant']['walls_s']}"
        f" s, RTFs {part_b['variant']['rtfs']}, K1 {part_b['variant']['launches']} [{card}]")
    assert part_b["variant"]["launches"] == 400, part_b
    part_b["wall_s"] = time.perf_counter() - t0
    del models
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with torch_tf32_defaults():
        cfg, mode, state, step, batch = build_train_path("flash_bf16", use_decoder=True)
        perturb_(state.model, seed=23)
        counters = (flash_attention, flash_attention_bwd, maximum_path)
        for fn in counters:
            fn.launches = 0
        last = metrics_to_host(step(state, batch))
        launches = {fn.__name__: fn.launches for fn in counters}
    decoder = {n: p.grad for n, p in state.model.named_parameters() if ".decoder_blocks." in n}
    zero = [n for n, g in decoder.items() if g is None or not g.abs().max().item() > 0]
    log(f"[variants c] esd train step with the DiT decoder under {mode}: total loss"
        f" {last['total_loss']:.6f}, launches {launches}, {len(decoder)} decoder-block"
        f" gradients, {len(zero)} of them zero [{card}]")
    assert mode == "flash_bf16", mode
    assert launches == dict(flash_attention=8, flash_attention_bwd=8, maximum_path=1), launches
    assert math.isfinite(last["total_loss"]), last
    assert decoder and not zero, zero
    part_c = dict(launches=launches, total_loss=last["total_loss"],
                  wall_s=time.perf_counter() - t0)
    del state
    torch.cuda.empty_cache()
    return dict(card_vs_cpu=part_a, request_1=part_b, train=part_c)


SERVE_PRESET = "vctk_bench_from_disk"  # vctk_bench with the vocoder_path the phase writes
SERVE_SEED = 11
STREAM_PARAGRAPHS = [" ".join(SENTENCES[(4 * k + j) % len(SENTENCES)] for j in range(6))
                     for k in range(4)]


def write_checkpoints(directory: str) -> tuple[str, str]:
    """The main path's seeded random DeX (`build_main_path`: vctk_bench,
    durations pinned) saved through `CheckpointManager` as ``best-train``,
    and its HiFi-GAN as the reference ships it: weight-normed convs under
    ``generator``, in a plain zip (``generator_universal.pth.tar.zip``),
    with a config.json beside it → (exp_dir, vocoder dir)."""
    from dex_tts_tpu_torch.train import create_train_state
    from dex_tts_tpu_torch.train.checkpoint import CheckpointManager

    _, synth = build_main_path("vctk_bench")
    exp_dir, voc_dir = os.path.join(directory, "exp"), os.path.join(directory, "hifigan")
    CheckpointManager(os.path.join(exp_dir, "ckpt")).save(create_train_state(synth.model),
                                                          "best-train")
    write_hifigan_release(voc_dir, synth.vocoder)
    return exp_dir, voc_dir


def write_hifigan_release(voc_dir: str, vocoder) -> None:
    """``vocoder`` (a HiFiGANGenerator) as the reference ships it, into
    ``voc_dir``: weight-normed convs under ``generator``, in a plain zip
    (``generator_universal.pth.tar.zip``), with a config.json beside it."""
    import zipfile

    from dex_tts_tpu_torch.export import save_torch_checkpoint, vocoder_reference_state

    os.makedirs(voc_dir)
    raw = os.path.join(voc_dir, "generator_universal.pth.tar")
    save_torch_checkpoint(raw, {"generator": vocoder_reference_state(vocoder)})
    with zipfile.ZipFile(raw + ".zip", "w") as zf:
        zf.write(raw, os.path.basename(raw))
    os.remove(raw)
    cfg = vocoder.cfg
    with open(os.path.join(voc_dir, "config.json"), "w") as f:
        json.dump({k: getattr(cfg, k) for k in ("num_mels", "upsample_rates",
                                                "upsample_kernel_sizes", "upsample_initial_channel",
                                                "resblock_kernel_sizes", "resblock_dilation_sizes")}
                  | {"resblock": "1", "sampling_rate": 22050}, f)


def post_json(port: int, path: str, payload: dict, timeout: float = 300.0):
    """POST a JSON body → (status, seconds to the first body line, lines)."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        lines, first = [], None
        for line in r:
            if line.strip():
                first = first if first is not None else time.perf_counter() - t0
                lines.append(json.loads(line))
        return r.status, first, time.perf_counter() - t0, lines


def concurrently(fn, args_list):
    """Run ``fn(*args)`` for every args in a thread of its own, all
    started together → results in order (an exception is re-raised)."""
    import threading

    results = [None] * len(args_list)

    def run(i, args):
        try:
            results[i] = fn(*args)
        except BaseException as exc:  # handed to the caller below
            results[i] = exc

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(args_list)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        assert not th.is_alive(), "a client thread hung"
    for r in results:
        if isinstance(r, BaseException):
            raise r
    return results


def phase_serve(card: str, directory: str) -> dict:
    """The serving path from a checkpoint on disk, at vctk_bench's full
    width with HiFi-GAN: write the checkpoints, load them through
    `load_synthesizer` (no random init), run `python -m
    dex_tts_tpu_torch.synthesize` in-process (one sentence, and a
    3-sentence paragraph with --long) and hold the sentence against a
    direct `tts` with the same seed; then `dex_tts_tpu_torch.serve`'s
    server on 127.0.0.1 (port 0) after its warm-up, 16 concurrent /tts
    requests of one sentence and 4 concurrent /tts_stream requests of a
    6-sentence paragraph, every response checked. Counts are set to 0
    before the synthesize calls and before the loads. → launches per
    path, latencies, batch sizes."""
    import base64
    import dataclasses
    import threading
    import urllib.request

    from dex_tts_tpu_torch import serve, synthesize
    from dex_tts_tpu_torch.audio.wav import read_wav
    from dex_tts_tpu_torch.config import PRESETS, load_preset
    from dex_tts_tpu_torch.eval import load_synthesizer
    from dex_tts_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from dex_tts_tpu_torch.ops.mas import maximum_path
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.pipeline import SAMPLE_RATE, split_sentences
    from dex_tts_tpu_torch.serving import _percentile

    exp_dir, voc_dir = write_checkpoints(directory)
    ref = write_reference_wavs(directory, 1)[0]
    preset = dataclasses.replace(load_preset("vctk_bench"), vocoder_path=voc_dir)
    PRESETS[SERVE_PRESET] = lambda: preset
    synth = load_synthesizer(preset, exp_dir)
    dit_cfg = preset.model.dit_config()

    def samples(text):  # durations pinned: FRAMES_PER_TOKEN rounds up to 4
        return 4 * len(synth.prepare_text(text)) * synth.hop

    counters = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
                "maximum_path": maximum_path, "snake": snake_antialias}

    def reset_counts():
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in counters.items()}

    # synthesize: one sentence, then a paragraph (each WAV in its own directory)
    argv = ["--preset", SERVE_PRESET, "--weight_path", exp_dir, "--ref_name", ref,
            "--seed", str(SERVE_SEED)]
    cli = synthesize.parse_args(argv + ["--input_text", SENTENCES[5]])
    # K1 per tts call whose DiT runs the flash route: depth × the CLIs' steps
    per_call = dit_cfg.depth * cli.n_timesteps
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        [(path, one)] = synthesize.main(argv + ["--input_text", SENTENCES[5], "--out_dir",
                                                os.path.join(directory, "sentence")])
        [(long_path, long)] = synthesize.main(argv + ["--input_text", " ".join(REQUEST_2),
                                                      "--long", "--out_dir",
                                                      os.path.join(directory, "paragraph")])
    synth_launches = read_counts()
    direct = synth.tts([SENTENCES[5]], generator=torch.Generator("cuda").manual_seed(cli.seed),
                       n_timesteps=cli.n_timesteps, temperature=cli.temperature,
                       length_scale=cli.length_scale, ref_wavs=[ref])[0]["wav"]
    err = float(np.abs(one["wav"] - direct).max())
    log(f"[serve] synthesize.main vs tts, same seed: max|Δwav| {err:.3e} (bound"
        f" {1e-4 * np.abs(direct).max():.3e}); launches {synth_launches} [{card}]")
    assert err <= 1e-4 * np.abs(direct).max(), err
    for p, out, want in ((path, one, samples(SENTENCES[5])),
                         (long_path, long, sum(samples(s) for s in REQUEST_2)
                          + 2 * int(SAMPLE_RATE * 0.2))):  # --pause_ms 200
        wav, sr = read_wav(p)
        assert sr == SAMPLE_RATE and wav.shape == out["wav"].shape == (want,), (p, wav.shape)
        assert np.isfinite(wav).all() and np.isfinite(out["wav"]).all()
    assert synth_launches["flash_attention"] > 0, synth_launches
    assert synth_launches["flash_attention"] % per_call == 0, synth_launches

    # serve: the CLI's server after its warm-up, the loads from client threads
    args = serve.parse_args(["--preset", SERVE_PRESET, "--weight_path", exp_dir, "--ref_name", ref,
                             "--port", "0", "--seed", str(SERVE_SEED)])
    with contextlib.redirect_stdout(io.StringIO()):
        srv, batcher = serve.build_server(args)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    port = srv.server_address[1]
    try:
        reset_counts()
        t0 = time.perf_counter()
        tts = concurrently(lambda s: post_json(port, "/tts", {"texts": [s]}),
                           [(s,) for s in SENTENCES])
        tts_wall = time.perf_counter() - t0
        n_tts_batches = len(batcher.batch_sizes)
        t0 = time.perf_counter()
        streams = concurrently(lambda p: post_json(port, "/tts_stream", {"text": p}),
                               [(p,) for p in STREAM_PARAGRAPHS])
        stream_wall = time.perf_counter() - t0
        serve_launches = read_counts()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        batcher.close()
        srv.server_close()
        server.join(timeout=30)
    for text, (status, _, _, [body]) in zip(SENTENCES, tts):
        assert status == 200, status
        pcm = np.frombuffer(base64.b64decode(body["wavs"][0]), dtype="<i2")
        assert pcm.shape == (samples(text),), (pcm.shape, samples(text))
    pause = int(SAMPLE_RATE * 0.2)  # the default pause_ms of /tts_stream and --long
    for paragraph, (status, _, _, lines) in zip(STREAM_PARAGRAPHS, streams):
        assert status == 200, status
        sentences = split_sentences(paragraph)
        assert [line.get("i") for line in lines[:-1]] == list(range(len(sentences))), lines[-1]
        assert lines[-1].get("done") and lines[-1]["sentences"] == len(sentences), lines[-1]
        for i, (line, s) in enumerate(zip(lines[:-1], sentences)):
            pcm = np.frombuffer(base64.b64decode(line["pcm"]), dtype="<i2")
            assert pcm.shape == (samples(s) + (pause if i else 0),), (i, pcm.shape)
    n_sentences = len(SENTENCES) + sum(len(split_sentences(p)) for p in STREAM_PARAGRAPHS)
    assert health["device"] == "cuda" and health["card"] == card, health
    assert health["sentences"] == n_sentences, health
    sizes = list(batcher.batch_sizes)
    assert max(sizes) > 1 and sum(sizes) == n_sentences, sizes
    k1 = serve_launches["flash_attention"]
    assert k1 > 0 and k1 % per_call == 0, serve_launches
    for name in ("snake", "flash_attention_bwd", "maximum_path"):  # HiFi-GAN, inference
        assert serve_launches[name] == 0 == synth_launches[name], (serve_launches, synth_launches)
    lat = sorted(r[2] for r in tts)
    ttfa = sorted(r[1] for r in streams)
    result = dict(
        launches={"synthesize": synth_launches, "serve": serve_launches},
        tts_p50_s=_percentile(lat, 0.5), tts_p95_s=_percentile(lat, 0.95), tts_wall_s=tts_wall,
        ttfa_p50_s=_percentile(ttfa, 0.5), ttfa_p95_s=_percentile(ttfa, 0.95),
        stream_wall_s=stream_wall, batch_sizes=sizes, tts_batches=n_tts_batches,
        synthesize_max_abs_err=err,
    )
    log(f"[serve] /tts x16 concurrent: latency p50 {result['tts_p50_s']:.4f} s, p95"
        f" {result['tts_p95_s']:.4f} s, wall {tts_wall:.4f} s in {n_tts_batches} batches;"
        f" /tts_stream x4 (6 sentences each): time to first audio p50"
        f" {result['ttfa_p50_s']:.4f} s, p95 {result['ttfa_p95_s']:.4f} s, wall"
        f" {stream_wall:.4f} s; batch sizes {sizes}; K1 launches {k1} [{card}]")
    return result


EVAL_PRESETS = ("vctk_bench_eval", "vctk_bench_bigvgan_eval")  # registered by phase_eval
EVAL_ITEMS, EVAL_BIGVGAN_ITEMS = 8, 2
EVAL_SEED = 13
# card vs CPU preprocessing: the mels in the linear domain, relative to the
# utterance's largest value (log(clamp(x, 1e-5)) magnifies cuFFT's and
# pocketfft's differences near the clamp); lf0, WAVs, filelists equal
EVAL_MEL_REL = 1e-5
# card vs CPU GE2E embeddings (unit vectors), max |Δ|: cuDNN's LSTM in f32
# (cuDNN TF32 off), and at PyTorch's default (cuDNN TF32 on)
GE2E_ATOL = 1e-4
GE2E_TF32_ATOL = 5e-2


@contextlib.contextmanager
def eval_stage_timers(totals: dict):
    """Time the evaluation's stages per call, each between two
    synchronisations: the synthesizer's `tts` ("tts"), its vocoder inside
    it ("vocoder"), `mel_cepstral_distortion` ("mcd") and
    `SpeakerScorer.cosine` ("speaker"), appending seconds to ``totals``."""
    from dex_tts_tpu_torch.eval import evaluation
    from dex_tts_tpu_torch.eval.metric import SpeakerScorer

    def timed(fn, name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                totals.setdefault(name, []).append(time.perf_counter() - t0)
        return run

    def load_synthesizer(*args, **kwargs):
        synth = real_load(*args, **kwargs)
        start = []

        def before(*_):  # hooks return None: inputs and outputs unchanged
            torch.cuda.synchronize()
            start.append(time.perf_counter())

        def after(*_):
            torch.cuda.synchronize()
            totals.setdefault("vocoder", []).append(time.perf_counter() - start.pop())

        synth.vocoder.register_forward_pre_hook(before)
        synth.vocoder.register_forward_hook(after)
        synth.tts = timed(synth.tts, "tts")
        return synth

    real_load, real_mcd = evaluation.load_synthesizer, evaluation.mel_cepstral_distortion
    real_cosine = SpeakerScorer.cosine
    evaluation.load_synthesizer = load_synthesizer
    evaluation.mel_cepstral_distortion = timed(real_mcd, "mcd")
    SpeakerScorer.cosine = timed(real_cosine, "speaker")
    try:
        yield totals
    finally:
        evaluation.load_synthesizer, evaluation.mel_cepstral_distortion = real_load, real_mcd
        SpeakerScorer.cosine = real_cosine


def phase_eval(card: str, directory: str) -> dict:
    """Preprocess a corpus and evaluate DeX-TTS on it, through the entry
    points: a seeded VCTK-layout corpus (2 speakers x 8 utterances at 48
    kHz, `write_vctk_corpus`) through `python -m
    dex_tts_tpu_torch.preprocess` in-process with the mels on the card, and
    again on the CPU: every mel within EVAL_MEL_REL of the CPU's, the lf0
    files, WAVs, speaker map and filelists equal. Then `python -m
    dex_tts_tpu_torch.main test` on the held-out speaker's 8 items
    (`--n_random_unseen 1`) with the main path's seeded DeX and HiFi-GAN
    from disk (`write_checkpoints`) and a GE2E state dict from
    `init_params` (`--spk_encoder`): 8 WAVs and 8 ground-truth copies, a
    finite mel MAE, MCD > 0, cos in [-1, 1], no WER/CER without
    transformers, K1 200 launches per item; and with the bf16 BigVGAN
    from a seeded ``gen_last.pth`` on 2 items (K1 400, K2 218). The GE2E
    embeddings of the corpus on the card against the CPU's, cuDNN TF32
    off and on. Counts are set to 0 just before each evaluation. TF32 off
    (`main`). → launches, per-item stage times, walls, errors."""
    import dataclasses
    import importlib.util

    from dex_tts_tpu_torch import main as port_main
    from dex_tts_tpu_torch.audio.wav import read_wav
    from dex_tts_tpu_torch.config import PRESETS, build_vocoder, load_preset
    from dex_tts_tpu_torch.eval.speaker import BuiltinVoiceEncoder, init_params
    from dex_tts_tpu_torch.ops.attention import flash_attention
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.preprocess import __main__ as preprocess_cli

    os.environ["HF_HUB_OFFLINE"] = "1"  # a pretrained ASR is never fetched
    corpus = os.path.join(directory, "corpus")
    write_vctk_corpus(corpus, n_speakers=2, n_utts=8, seed=EVAL_SEED)
    runs = {}
    for dev in ("cuda", "cpu"):
        root = os.path.join(directory, dev)
        argv = ["--dataset", "VCTK", "--corpus_path", corpus, "--raw_path", os.path.join(root, "raw"),
                "--out_path", os.path.join(root, "pre"), "--filelist_dir", os.path.join(root, "fl"),
                "--n_random_unseen", "1", "--device", dev]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rows, counts = preprocess_cli.main(argv)
        torch.cuda.synchronize()
        runs[dev] = dict(root=root, rows=rows, counts=counts, wall_s=time.perf_counter() - t0)
    card_run, cpu_run = runs["cuda"], runs["cpu"]
    n_utts = len(card_run["rows"])
    assert n_utts == 16 and card_run["counts"] == cpu_run["counts"], (n_utts, card_run["counts"])
    assert card_run["counts"]["test_unseen"] == EVAL_ITEMS, card_run["counts"]
    mel_err = 0.0
    for sub_root, _, names in os.walk(os.path.join(cpu_run["root"], "pre")):
        for name in names:
            rel = os.path.relpath(os.path.join(sub_root, name), cpu_run["root"])
            a, b = (os.path.join(run["root"], rel) for run in (card_run, cpu_run))
            if rel.startswith(os.path.join("pre", "mel")):
                on_card, on_cpu = np.exp(np.load(a).astype(np.float64)), np.exp(
                    np.load(b).astype(np.float64))
                assert on_card.shape == on_cpu.shape and on_card.shape[1] == 80, rel
                mel_err = max(mel_err, float(np.abs(on_card - on_cpu).max() / on_cpu.max()))
            else:  # lf0, WAVs, speakers.txt
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), rel
    for name in os.listdir(os.path.join(cpu_run["root"], "fl")):
        with open(os.path.join(card_run["root"], "fl", name)) as fa, \
                open(os.path.join(cpu_run["root"], "fl", name)) as fb:
            assert fa.read().replace(card_run["root"], "") == fb.read().replace(cpu_run["root"], "")
    log(f"[eval] preprocessing {n_utts} utterances (VCTK layout, 48 kHz): card {card_run['wall_s']:.4f}"
        f" s ({card_run['wall_s'] / n_utts:.4f} s per utterance), CPU {cpu_run['wall_s']:.4f} s;"
        f" mels card vs CPU max |Δ| / max {mel_err:.3e} (bound {EVAL_MEL_REL:.0e}, linear"
        f" domain); lf0, WAVs, filelists equal [{card}]")
    assert mel_err <= EVAL_MEL_REL, mel_err

    exp_dir, voc_dir = write_checkpoints(os.path.join(directory, "ckpt"))
    bigvgan_preset = load_preset("vctk_bench_bigvgan")
    bigvgan_dir = os.path.join(directory, "bigvgan")
    os.makedirs(bigvgan_dir)
    torch.manual_seed(EVAL_SEED)
    torch.save(build_vocoder(bigvgan_preset.vocoder, device="cpu").state_dict(),
               os.path.join(bigvgan_dir, "gen_last.pth"))
    ge2e = os.path.join(directory, "ge2e.pt")
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in init_params(EVAL_SEED).items()}},
               ge2e)
    filelist = os.path.join(card_run["root"], "fl", "test_unseen.txt")
    PRESETS[EVAL_PRESETS[0]] = lambda: dataclasses.replace(load_preset("vctk_bench"),
                                                           vocoder_path=voc_dir)
    PRESETS[EVAL_PRESETS[1]] = lambda: dataclasses.replace(bigvgan_preset, vocoder_path=bigvgan_dir)
    per_item_k1 = bigvgan_preset.model.dit.depth * bigvgan_preset.n_timesteps  # 4 x 50
    has_asr = importlib.util.find_spec("transformers") is not None

    def evaluate(preset_name, checkpoint, n_items, eval_dir):
        argv = ["test", "--preset", preset_name, "--test_checkpoint", checkpoint, "--val_path",
                filelist, "--sample_size", str(n_items), "--spk_encoder", ge2e, "--seed",
                str(EVAL_SEED), "--n_timesteps", str(bigvgan_preset.n_timesteps), "--device", "cuda"]
        stages = {}
        torch.cuda.synchronize()
        flash_attention.launches = snake_antialias.launches = 0
        t0 = time.perf_counter()
        with eval_stage_timers(stages), contextlib.redirect_stdout(io.StringIO()):
            report = port_main.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": flash_attention.launches, "snake": snake_antialias.launches}
        names = sorted(os.listdir(eval_dir))
        assert names == sorted([f"{i:03d}_{k}.wav" for i in range(n_items) for k in ("syn", "ref")]
                               + ["report.txt"]), names
        for i in range(n_items):
            wav, sr = read_wav(os.path.join(eval_dir, f"{i:03d}_syn.wav"))
            assert sr == 22050 and len(wav) > 0 and np.isfinite(wav).all()
        assert np.isfinite(report["mel_mae"][0]) and report["mcd"][0] > 0, report
        assert -1.0 <= report["cos"][0] <= 1.0, report
        assert has_asr or not {"wer", "cer"} & set(report), report
        assert launches["flash_attention"] == per_item_k1 * n_items, launches
        per_item = {k: float(np.mean(v)) for k, v in stages.items()}
        per_item["synthesis"] = per_item["tts"] - per_item["vocoder"]
        assert len(stages["tts"]) == len(stages["speaker"]) == n_items, stages
        return dict(report={k: list(v) for k, v in report.items()}, launches=launches,
                    wall_s=wall, per_item_s=per_item, n_items=n_items)

    hifigan = evaluate(EVAL_PRESETS[0], exp_dir, EVAL_ITEMS, os.path.join(exp_dir, "eval"))
    assert hifigan["launches"]["snake"] == 0, hifigan["launches"]
    # BigVGAN from the checkpoint's .pth file: its eval directory goes beside it
    bigvgan = evaluate(EVAL_PRESETS[1], os.path.join(exp_dir, "ckpt", "best-train.pth"),
                       EVAL_BIGVGAN_ITEMS, os.path.join(exp_dir, "ckpt", "eval"))
    assert bigvgan["launches"]["snake"] == SNAKE_LAUNCHES * EVAL_BIGVGAN_ITEMS, bigvgan["launches"]
    for label, run in (("HiFi-GAN f32", hifigan), ("BigVGAN bf16", bigvgan)):
        t = run["per_item_s"]
        log(f"[eval {label}] main test on {run['n_items']} held-out items: wall"
            f" {run['wall_s']:.4f} s; per item: synthesis {t['synthesis']:.4f} s, vocoder"
            f" {t['vocoder']:.4f} s, MCD {t['mcd']:.4f} s, speaker {t['speaker']:.4f} s; report"
            f" {json.dumps(run['report'])}; launches {run['launches']} [{card}]")

    # GE2E on the card against the CPU, on the corpus's preprocessed WAVs
    wavs = []
    for sub_root, _, names in os.walk(os.path.join(card_run["root"], "pre", "wav")):
        wavs += [read_wav(os.path.join(sub_root, n)) for n in sorted(names)]
    on_cpu = BuiltinVoiceEncoder(ge2e, device="cpu")
    want = np.stack([on_cpu.embed_utterance(w, source_sr=sr) for w, sr in wavs])
    ge2e_err = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            got = np.stack([BuiltinVoiceEncoder(ge2e, device="cuda").embed_utterance(w, source_sr=sr)
                            for w, sr in wavs])
        finally:
            torch.backends.cudnn.allow_tf32 = False
        ge2e_err["cudnn_tf32" if tf32 else "f32"] = float(np.abs(got - want).max())
    log(f"[eval] GE2E card vs CPU over {len(wavs)} utterances, max |Δ| of unit embeddings:"
        f" cuDNN TF32 off {ge2e_err['f32']:.3e} (bound {GE2E_ATOL:.0e}), on (PyTorch's default)"
        f" {ge2e_err['cudnn_tf32']:.3e} (bound {GE2E_TF32_ATOL:.0e}) [{card}]")
    assert ge2e_err["f32"] <= GE2E_ATOL and ge2e_err["cudnn_tf32"] <= GE2E_TF32_ATOL, ge2e_err
    return dict(preprocess={dev: dict(wall_s=r["wall_s"], per_utterance_s=r["wall_s"] / n_utts)
                            for dev, r in runs.items()},
                mel_rel_err=mel_err, ge2e_err=ge2e_err, hifigan=hifigan, bigvgan=bigvgan,
                launches={"eval_hifigan": hifigan["launches"], "eval_bigvgan": bigvgan["launches"]})


# the port bench's runs: (label, argv, K1 launches, K2 launches) per
# text→WAV call: K1 4 per DiT evaluation (depth 4), K2 109 per BigVGAN call
PARALLEL_BATCH = 32  # the ESD global batch: 16 rows per rank
PARALLEL_TIMED_STEPS = 3
# DP step against the one-process step on the same card and rows, TF32
# off: the same kernels on half the rows, so only f32 summation order
# (and, under flash_bf16, bf16 roundings it flips) separates them
PARALLEL_BOUNDS = {"auto": dict(loss_rtol=1e-4, grad_rel=1e-3),
                   "flash_bf16": dict(loss_rtol=1e-3, grad_rel=1e-2)}
PARALLEL_BUFFER_RTOL = 1e-4  # BatchNorm running statistics, VQ codebook
PARALLEL_VOCODER_ROWS = 8  # per rank: 2 × 8 × 8192 against 16 × 8192
PARALLEL_MEL_REL = 2e-2  # sharded synthesis (bf16 DiT, 50 steps) vs one process, × max|mel|
PARALLEL_CLI_PRESET = "esd_parallel_smoke"


def _grad_ratio(got: dict, want: dict, rel: float) -> tuple[float, str]:
    """max over tensors of |g − g_want| / (rel × (max|g_want| + 1e-3 × top))."""
    top = max(g.abs().max().item() for g in want.values())
    assert top > 0 and sorted(got) == sorted(want)
    return max(((got[n] - g).abs().max().item() / (rel * (g.abs().max().item() + 1e-3 * top)), n)
               for n, g in want.items())


def _buffer_ratio(got: dict, want: dict) -> float:
    names = [n for n in want if "running" in n or ".vq." in n]
    assert len(names) >= 9, names
    return max((got[n] - want[n]).abs().max().item()
               / (PARALLEL_BUFFER_RTOL * want[n].abs().max().item() + 1e-12) for n in names)


def _parallel_train(rank: int, data: dict) -> dict:
    """(a) on one of two gloo ranks that share the card: for each attention
    setting, rank 0's one-process step on the global batch, then the DP
    step (every rank), then the plain-DDP control, then timed DP steps."""
    import dataclasses
    from unittest import mock

    from dex_tts_tpu_torch import main as port_main
    from dex_tts_tpu_torch import parallel
    from dex_tts_tpu_torch.config import load_preset
    from dex_tts_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from dex_tts_tpu_torch.ops.mas import maximum_path
    from dex_tts_tpu_torch.parallel import collectives
    from dex_tts_tpu_torch.train.trainer import metrics_to_host

    mesh = parallel.make_mesh()
    preset = dataclasses.replace(load_preset("esd"), train_path=data["train"],
                                 val_path=data["valid"])
    preset = dataclasses.replace(preset, train=dataclasses.replace(preset.train,
                                                                   batch_size=PARALLEL_BATCH))
    global_batch = next(iter(port_main.make_loaders(preset, seed=1)[0]()))
    local_batch = next(iter(port_main.make_loaders(preset, 1, mesh.world_size, mesh.rank)[0]()))

    def snapshot(state):
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        bufs = {n: b.detach().clone() for n, b in state.model.named_buffers()}
        return grads, bufs

    def fresh(attention):
        _, mode, state, step, _ = build_train_path(attention)
        state.max_grad = float("inf")  # compare the gradients before any clip
        return mode, state, step

    out = {}
    for attention in ("auto", "flash_bf16"):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        bounds = PARALLEL_BOUNDS[attention]
        report = {}
        if mesh.rank == 0:
            _, state, step = fresh(attention)
            want = metrics_to_host(step(state, global_batch))
            want_grads, want_bufs = snapshot(state)
            del state
        dist_barrier(mesh)
        mode, state, step = fresh(attention)
        pstep = parallel.make_parallel_train_step(step, mesh)
        got = metrics_to_host(pstep(state, local_batch))
        got_grads, got_bufs = snapshot(state)
        # plain DDP: each rank's own denominators and BatchNorm statistics
        # (and codebook counts), the gradients averaged
        _, ddp_state, ddp_step = fresh(attention)
        with mock.patch.object(collectives, "global_sum", lambda x: x), \
                mock.patch.object(collectives, "dp_world", lambda: 1):
            ddp = metrics_to_host(parallel.make_parallel_train_step(ddp_step, mesh)(
                ddp_state, local_batch))
        ddp_grads = {n: p.grad.detach() / mesh.dp_size
                     for n, p in ddp_state.model.named_parameters()}
        ddp["total_loss"] /= mesh.dp_size  # the metrics were summed: DDP reports the mean
        del ddp_state
        if mesh.rank == 0:
            loss_ratio = max(abs(got[k] - v) / (bounds["loss_rtol"] * abs(v))
                             for k, v in want.items() if k != "grad_norm")
            report.update(
                want_loss=want["total_loss"], got_loss=got["total_loss"],
                ddp_loss=ddp["total_loss"], loss_ratio=loss_ratio,
                grad_ratio=_grad_ratio(got_grads, want_grads, bounds["grad_rel"]),
                buffer_ratio=_buffer_ratio(got_bufs, want_bufs),
                ddp_grad_ratio=_grad_ratio(ddp_grads, want_grads, bounds["grad_rel"]),
                ddp_loss_ratio=abs(ddp["total_loss"] - want["total_loss"])
                / (bounds["loss_rtol"] * abs(want["total_loss"])))
        del got_grads, ddp_grads
        # timed DP steps at PyTorch's TF32 defaults, two ranks on one card
        with torch_tf32_defaults():
            state.max_grad = load_preset("esd").train.max_grad
            metrics_to_host(pstep(state, local_batch))  # warm-up at these flags
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counters = (flash_attention, flash_attention_bwd, maximum_path)
            for fn in counters:
                fn.launches = 0
            dist_barrier(mesh)
            t0 = time.perf_counter()
            for _ in range(PARALLEL_TIMED_STEPS):
                metrics = pstep(state, local_batch)
            last = metrics_to_host(metrics)
            dist_barrier(mesh)
            wall = time.perf_counter() - t0
        report.update(mode=mode, depth=state.model.cfg.dit.depth,
                      steps_per_s=PARALLEL_TIMED_STEPS / wall, last=last,
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                      launches={fn.__name__: fn.launches for fn in counters})
        out[attention] = report
        del state
        torch.cuda.empty_cache()
    return out


def dist_barrier(mesh) -> None:
    import torch.distributed as dist

    dist.barrier(group=mesh.cpu_group)


def _parallel_nccl(directory: str, data: dict) -> dict:
    """(b) world size 1 over nccl, in this process (a spawned rank would
    cost a process start and a CUDA context): one DP step against the
    plain step from the same state, deterministic algorithms on both
    (cuBLAS on one stream is deterministic already), the group destroyed
    and the algorithm flags put back after."""
    import dataclasses

    from dex_tts_tpu_torch import main as port_main
    from dex_tts_tpu_torch import parallel
    from dex_tts_tpu_torch.config import load_preset

    import torch.distributed as dist

    preset = dataclasses.replace(load_preset("esd"), train_path=data["train"],
                                 val_path=data["valid"])
    preset = dataclasses.replace(preset, train=dataclasses.replace(preset.train, batch_size=8))
    batch = next(iter(port_main.make_loaders(preset, seed=1)[0]()))
    benchmark = torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    parallel.initialize("file://" + os.path.join(directory, "nccl_store"), world_size=1, rank=0,
                        backend="nccl", device="cuda:0")
    try:
        backend, world = dist.get_backend(), dist.get_world_size()
        runs = []
        for parallel_step in (False, True):
            _, _, state, step, _ = build_train_path("auto")
            if parallel_step:
                step = parallel.make_parallel_train_step(step, parallel.make_mesh())
            metrics = {k: v.item() for k, v in step(state, batch).items()}
            runs.append((metrics,
                         {n: p.detach().cpu() for n, p in state.model.state_dict().items()},
                         {n: p.detach().cpu() for n, p in state.ema.items()}))
            del state
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = benchmark
    (m0, p0, e0), (m1, p1, e1) = runs
    return dict(backend=backend, world=world, plain=m0, dp=m1,
                metrics_equal=m0 == m1,
                params_equal=all(torch.equal(p0[n], p1[n]) for n in p0),
                ema_equal=all(torch.equal(e0[n], e1[n]) for n in e0))


def _parallel_vocoder(rank: int, data: dict) -> dict:
    """(c) the vocoder GAN step: rank 0's one-process step on the global
    16 × 8192 crop batch, then the DP step on each rank's 8 rows of the
    same seeded crops."""
    from dex_tts_tpu_torch import parallel
    from dex_tts_tpu_torch.audio.stft import MelSpectrogram
    from dex_tts_tpu_torch.data.vocoder_dataset import WavSegmentDataset
    from dex_tts_tpu_torch.models.vocoder import BigVGANConfig
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.train import vocoder as tv

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = parallel.make_mesh()
    rows = PARALLEL_VOCODER_ROWS * mesh.dp_size
    batch = next(WavSegmentDataset(data["wavs"], segment=8192, seed=100).batches(rows, 1))
    mel, mel_l1 = MelSpectrogram(), MelSpectrogram(fmax=11025.0)

    def run(batch, sharded: bool):
        state = tv.create_vocoder_train_state(BigVGANConfig(), seed=100, device="cuda")
        step = tv.make_vocoder_train_step(mel, mel_l1)
        if sharded:
            parallel.replicate_state(state, mesh)
            step = parallel.make_parallel_train_step(step, mesh)
        metrics = step(state, batch)
        grads = {f"critic {n}": p.grad.detach().clone() for n, p in state.critics.named_parameters()}
        grads.update({f"generator {n}": p.grad.detach().clone()
                      for n, p in state.generator.named_parameters()})
        return {k: v.item() for k, v in metrics.items()}, grads

    report = {}
    if mesh.rank == 0:
        want, want_grads = run(batch, sharded=False)
    dist_barrier(mesh)
    snake_antialias.launches = 0
    got, got_grads = run(parallel.shard_rows(batch, mesh), sharded=True)
    torch.cuda.synchronize()
    report["snake_launches"] = snake_antialias.launches
    if mesh.rank == 0:
        rows_ = [(abs(got[k] - v) / (VOCODER_LOSS_RTOL * abs(v)), k) for k, v in want.items()]
        median = None
        for part in ("critic", "generator"):
            sub_w = {n: g for n, g in want_grads.items() if n.startswith(part)}
            sub_g = {n: got_grads[n] for n in sub_w}
            top = max(g.abs().max().item() for g in sub_w.values())
            scaled = [((sub_g[n] - g).abs().max().item() / (g.abs().max().item() + 1e-3 * top), n)
                      for n, g in sub_w.items()]
            rows_ += [(e / VOCODER_GRAD_REL[part], n) for e, n in scaled]
            if part == "generator":
                median = sorted(e for e, _ in scaled)[len(scaled) // 2]
        report.update(want=want, got=got, worst=max(rows_), generator_median=median)
    return report


def _parallel_synthesis(rank: int, data: dict) -> dict:
    """(d) `Synthesizer.tts` of the main path's DeX + HiFi-GAN over dp2 and
    over dp1×tp2 (4 sentences, 50 euler steps); rank 0 also runs one
    process, and the same with another noise seed (the control)."""
    import copy

    from dex_tts_tpu_torch import parallel
    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.ops.attention import flash_attention
    from dex_tts_tpu_torch.pipeline import Synthesizer

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    preset, synth = build_main_path("vctk_bench")
    texts, feats = SENTENCES[:4], random_ref_feats(4, seed=9)

    def mels(s, seed=1):
        out = s.tts(texts, generator=torch.Generator("cuda").manual_seed(seed), ref_feats=feats)
        return [torch.from_numpy(r["mel"]) for r in out], [r["n_frames"] for r in out]

    report = {}
    if rank == 0:
        want, frames = mels(synth)
        control, _ = mels(synth, seed=2)
    out = {}
    for label, tp_size in (("dp2", 1), ("dp1xtp2", 2)):
        mesh = parallel.make_mesh(tp_size=tp_size)
        sharded = Synthesizer(copy.deepcopy(synth.model), synth.vocoder, cmu_path=preset.cmu_path,
                              sampler=SamplerConfig(num_steps=preset.n_timesteps), device="cuda",
                              mesh=mesh)
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, got_frames = mels(sharded)
        wall = time.perf_counter() - t0
        out[label] = dict(launches=flash_attention.launches, wall_s=wall,
                          per_call=preset.model.dit.depth * preset.n_timesteps,
                          shard_count=parallel.shard_count(sharded.model))
        if rank == 0:
            scale = max(m.abs().max().item() for m in want)
            out[label].update(
                frames_equal=got_frames == frames,
                ratio=max((g - w).abs().max().item() for g, w in zip(got, want))
                / (PARALLEL_MEL_REL * scale))
        del sharded
    if rank == 0:
        scale = max(m.abs().max().item() for m in want)
        report["control_ratio"] = max((c - w).abs().max().item() for c, w in zip(control, want)) \
            / (PARALLEL_MEL_REL * scale)
    report.update(out)
    return report


def _parallel_rank(rank: int, data: dict, preset, argv: list) -> dict:
    """(a), (c), (d) and (e) (a first run, then ``--resume``) in one pair of
    gloo ranks on one card, each part's wall in ``walls``."""
    parts = dict(train=lambda: _parallel_train(rank, data),
                 vocoder=lambda: _parallel_vocoder(rank, data),
                 synthesis=lambda: _parallel_synthesis(rank, data),
                 cli_first=lambda: _parallel_cli(rank, preset, argv),
                 cli_resumed=lambda: _parallel_cli(rank, preset, argv + ["--resume"]))
    out, walls = {}, {}
    for name, part in parts.items():
        t0 = time.perf_counter()
        out[name] = part()
        walls[name] = round(time.perf_counter() - t0, 1)
    return dict(out, walls=walls)


def _parallel_cli(rank: int, preset, argv: list) -> dict:
    """(e) `python -m dex_tts_tpu_torch.main train` on this rank, with
    checkpoint writes and restores counted."""
    from unittest import mock

    from dex_tts_tpu_torch import config
    from dex_tts_tpu_torch import main as port_main
    from dex_tts_tpu_torch.train import checkpoint

    config.PRESETS[PARALLEL_CLI_PRESET] = lambda: preset
    writes, restores = [], []
    write, restore = checkpoint._write, checkpoint.CheckpointManager.restore

    def counted_write(payload, path):
        writes.append(os.path.basename(path))
        write(payload, path)

    def counted_restore(self, state, tag):
        out = restore(self, state, tag)
        restores.append((tag, state.step))
        return out

    with mock.patch.object(checkpoint, "_write", counted_write), \
            mock.patch.object(checkpoint.CheckpointManager, "restore", counted_restore):
        trainer = port_main.main(argv)
    return dict(writes=writes, restores=restores, step=trainer.state.step,
                world=trainer.mesh.world_size)


def phase_parallel(card: str, directory: str) -> dict:
    """Data and tensor parallelism on the card. This machine has one card,
    and NCCL refuses two ranks on one device, so the multi-rank runs are
    two gloo ranks sharing cuda:0 (their times are two ranks on one card,
    not a scaling number), and the nccl run has world size 1:
      (a) the ESD train step at full width, global batch 32 (16 per rank,
          from `BucketBatcher(process_count=2)` on a dataset written here),
          attention "auto" and "flash_bf16": the DP step against the
          one-process step on the same 32 rows (`PARALLEL_BOUNDS`: losses,
          every gradient before the clip; BatchNorm statistics and the
          codebook within `PARALLEL_BUFFER_RTOL`), a plain-DDP control
          (per-rank denominators, BatchNorm and codebook counts, gradients
          averaged) outside the bound, then timed DP steps with K1 and K4
          launches per rank;
      (b) one DP step over nccl at world size 1, equal to the plain step
          bit for bit (metrics, weights, EMA);
      (c) the BigVGAN f32 GAN step, 2 ranks × 8 × 8192 against 16 × 8192:
          both losses and both optimizers' gradients within the card-vs-CPU
          vocoder bounds, K3 launches per rank;
      (d) `Synthesizer.tts` (vctk_bench, 4 sentences, euler 50) over dp2
          and dp1×tp2 against one process within `PARALLEL_MEL_REL`, a
          control with another noise seed outside, K1 launches per rank;
      (e) `main train` on the same two gloo ranks for one epoch: rank 0
          alone writes checkpoints and the log, ``--resume`` restores on
          both ranks, and the checkpoint loads into a one-process
          `load_synthesizer`.
    (a), (c), (d) and (e) run in one launch of the two ranks, (b) in this
    process: each launch costs a process start and a CUDA context per
    rank. → report."""
    import dataclasses

    from dex_tts_tpu_torch import parallel
    from dex_tts_tpu_torch.config import build_vocoder, load_preset
    from dex_tts_tpu_torch.eval.evaluation import load_synthesizer
    from dex_tts_tpu_torch.models.vocoder import HiFiGANConfig

    torch.cuda.empty_cache()
    train_path, val_path = write_training_set(os.path.join(directory, "data"), 40)
    wav_dir = os.path.join(directory, "wavs")
    os.makedirs(wav_dir)
    data = dict(train=train_path, valid=val_path, wavs=write_reference_wavs(wav_dir, 8))
    # (e)'s preset, data and vocoder release
    esd = load_preset("esd")
    small_train, small_valid = write_training_set(os.path.join(directory, "cli"), 16)
    voc_dir = os.path.join(directory, "hifigan")
    torch.manual_seed(44)
    vocoder = build_vocoder(HiFiGANConfig(), device="cuda")
    perturb_(vocoder, seed=44, scale=0.002)
    write_hifigan_release(voc_dir, vocoder)
    del vocoder
    exp = os.path.join(directory, "exp")
    argv = ["train", "--preset", PARALLEL_CLI_PRESET, "--train_path", small_train, "--val_path",
            small_valid, "--exp_dir", exp, "--seed", "1"]
    preset = dataclasses.replace(esd, vocoder_path=voc_dir, train=dataclasses.replace(
        esd.train, epoch=1, batch_size=4, syn_every=0))
    t0 = time.perf_counter()
    ranks = parallel.launch(_parallel_rank, 2, args=(data, preset, argv), backend="gloo",
                            devices=["cuda:0", "cuda:0"], timeout=900)
    wall_ranks = time.perf_counter() - t0
    r0 = ranks[0]
    train = r0["train"]
    for attention, rep in train.items():
        depth = rep["depth"] if rep["mode"].startswith("flash") else 0
        for r in ranks:
            got = r["train"][attention]["launches"]
            want = dict(flash_attention=PARALLEL_TIMED_STEPS * depth,
                        flash_attention_bwd=PARALLEL_TIMED_STEPS * depth,
                        maximum_path=PARALLEL_TIMED_STEPS)
            assert got == want, (attention, got, want)
        log(f"[parallel (a), esd train, attention {attention} → {rep['mode']}, dp2 gloo, two ranks"
            f" on one card] total_loss one process {rep['want_loss']:.6f}, dp {rep['got_loss']:.6f},"
            f" plain DDP {rep['ddp_loss']:.6f}; worst error/bound: losses {rep['loss_ratio']:.3e},"
            f" gradients {rep['grad_ratio'][0]:.3e} ({rep['grad_ratio'][1]}), buffers"
            f" {rep['buffer_ratio']:.3e}; plain-DDP control: gradients"
            f" {rep['ddp_grad_ratio'][0]:.3e} ({rep['ddp_grad_ratio'][1]}), loss"
            f" {rep['ddp_loss_ratio']:.3e} (bounds {PARALLEL_BOUNDS[attention]}, buffers rtol"
            f" {PARALLEL_BUFFER_RTOL}) [{card}]")
        log(f"[parallel (a) timed, {attention}] {PARALLEL_TIMED_STEPS} DP steps per rank:"
            f" {[round(r['train'][attention]['steps_per_s'], 4) for r in ranks]} steps/s (two"
            f" ranks sharing one card, not a scaling number), peak memory per rank"
            f" {[round(r['train'][attention]['peak_gib'], 2) for r in ranks]} GiB, launches per"
            f" rank {[r['train'][attention]['launches'] for r in ranks]} [{card}]")
        assert rep["loss_ratio"] <= 1 and rep["grad_ratio"][0] <= 1, rep
        assert rep["buffer_ratio"] <= 1, rep
        assert rep["ddp_grad_ratio"][0] > 1, ("the plain-DDP control lies inside the bound", rep)

    voc = r0["vocoder"]
    log(f"[parallel (c), BigVGAN f32 GAN step, dp2 gloo 2 x {PARALLEL_VOCODER_ROWS} x 8192 vs"
        f" {2 * PARALLEL_VOCODER_ROWS} x 8192] losses {voc['got']} vs {voc['want']}; worst"
        f" error/bound {voc['worst'][0]:.3e} ({voc['worst'][1]}), median generator tensor"
        f" {voc['generator_median']:.3e}; K3 launches per rank"
        f" {[r['vocoder']['snake_launches'] for r in ranks]} [{card}]")
    assert voc["worst"][0] <= 1 and voc["generator_median"] <= VOCODER_GRAD_MEDIAN_REL, voc
    assert all(r["vocoder"]["snake_launches"] == SNAKE_LAUNCHES for r in ranks), ranks

    syn = r0["synthesis"]
    for label in ("dp2", "dp1xtp2"):
        log(f"[parallel (d), vctk_bench + HiFi-GAN, 4 sentences, euler 50, {label}] worst"
            f" |mel - one process| / ({PARALLEL_MEL_REL} x max|mel|) {syn[label]['ratio']:.3e};"
            f" frames equal {syn[label]['frames_equal']}; K1 launches per rank"
            f" {[r['synthesis'][label]['launches'] for r in ranks]}; tp-sharded tensors"
            f" {syn[label]['shard_count']}; first call's wall {syn[label]['wall_s']:.3f} s"
            f" [{card}]")
        assert syn[label]["ratio"] <= 1 and syn[label]["frames_equal"], syn
        assert all(r["synthesis"][label]["launches"] == syn[label]["per_call"]
                   for r in ranks), ranks
    assert syn["dp1xtp2"]["shard_count"] > 0 and syn["dp2"]["shard_count"] == 0, syn
    log(f"[parallel (d) control] another noise seed: {syn['control_ratio']:.3e} x the bound")
    assert syn["control_ratio"] > 1, syn

    t0 = time.perf_counter()
    nccl = _parallel_nccl(directory, data)
    wall_b = time.perf_counter() - t0
    log(f"[parallel (b), esd train step over {nccl['backend']} at world size {nccl['world']}]"
        f" metrics equal {nccl['metrics_equal']}, weights equal {nccl['params_equal']}, EMA"
        f" equal {nccl['ema_equal']}: {nccl['dp']} [{card}]")
    assert nccl["backend"] == "nccl" and nccl["metrics_equal"] and nccl["params_equal"] \
        and nccl["ema_equal"], nccl

    # (e) the train entry point on the same two gloo ranks
    first = [r["cli_first"] for r in ranks]
    resumed = [r["cli_resumed"] for r in ranks]
    log_lines = open(os.path.join(exp, "log.txt")).read().splitlines()
    names = sorted(os.listdir(os.path.join(exp, "ckpt")))
    log(f"[parallel (e), main train on 2 gloo ranks, esd width, batch 4, 16 items] epoch 1:"
        f" writes per rank {[r['writes'] for r in first]}, steps {[r['step'] for r in first]};"
        f" --resume: restores per rank {[r['restores'] for r in resumed]}, steps"
        f" {[r['step'] for r in resumed]}; log {len(log_lines)} lines; checkpoints {names}"
        f" [{card}]")
    assert first[0]["writes"] and not first[1]["writes"], first
    assert resumed[0]["writes"] and not resumed[1]["writes"], resumed
    assert all(r["world"] == 2 for r in first + resumed)
    steps = first[0]["step"]
    assert steps > 0 and all(r["step"] == steps for r in first), first
    assert all(r["restores"] == [("last", steps)] and r["step"] == 2 * steps
               for r in resumed), resumed
    assert len(log_lines) == 2 and log_lines[1].startswith("epoch 1 | "), log_lines
    assert {"last.pth", "best-train.pth", "best-val.pth"} <= set(names), names
    synth = load_synthesizer(preset, exp, tag="last", device="cuda")
    saved = torch.load(os.path.join(exp, "ckpt", "last.pth"), weights_only=True)
    weights = saved["ema"] if preset.ema else saved["state_dict"]
    for n, v in synth.model.state_dict().items():
        assert torch.equal(v.cpu(), weights[n]), n
    out = synth.tts([SENTENCES[0]], generator=torch.Generator("cuda").manual_seed(0),
                    ref_feats=random_ref_feats(1))[0]
    assert np.isfinite(out["mel"]).all() and np.isfinite(out["wav"]).all(), out
    log(f"[parallel (e)] load_synthesizer(tag='last') in one process: weights equal the file's,"
        f" one sentence {out['n_frames']} frames, finite mel and wav; walls: the gloo ranks"
        f" (a, c, d, e) {wall_ranks:.1f} s (parts on rank 0, s: {r0['walls']}), the nccl rank"
        f" (b, in this process) {wall_b:.1f} s [{card}]")
    del synth
    torch.cuda.empty_cache()
    launches = {
        "flash_attention": {f"parallel_train_{k}_{PARALLEL_TIMED_STEPS}_steps_per_rank":
                            v["launches"]["flash_attention"] for k, v in train.items()},
        "flash_attention_bwd": {f"parallel_train_{k}_{PARALLEL_TIMED_STEPS}_steps_per_rank":
                                v["launches"]["flash_attention_bwd"] for k, v in train.items()},
        "maximum_path": {f"parallel_train_{k}_{PARALLEL_TIMED_STEPS}_steps_per_rank":
                         v["launches"]["maximum_path"] for k, v in train.items()},
        "snake": {"parallel_vocoder_step_per_rank": voc["snake_launches"]},
    }
    launches["flash_attention"].update({f"parallel_synthesis_{k}_per_rank": syn[k]["launches"]
                                        for k in ("dp2", "dp1xtp2")})
    return dict(train=train, vocoder=voc, synthesis=syn, nccl=nccl, launches=launches,
                cli=dict(first=first, resumed=resumed))


# (label, argv, K1, K2, K5 launches per timed call): K5, two launches,
# for each of the 13 U-Net Blocks per denoiser call
K5_PER_DENOISER_CALL = 13 * 2
BENCH_RUNS = [
    ("default", [], 200, 0, K5_PER_DENOISER_CALL * 50),
    ("dpmpp2m_16", ["--solver", "dpmpp2m", "--steps", "16"], 64, 0, K5_PER_DENOISER_CALL * 16),
    ("dit_cache_5", ["--dit_cache", "5"], 40, 0, K5_PER_DENOISER_CALL * 50),
    ("gedex_bigvgan", ["--family", "gedex", "--vocoder", "bigvgan"], 200, SNAKE_LAUNCHES,
     K5_PER_DENOISER_CALL * 50),
]
PROFILED = {"default": "flash_fwd_bf16", "train_default": "mas_warp"}  # a kernel each trace names


def trace_kernels(directory: str) -> set:
    """The device kernels' names in the one Chrome trace in ``directory``."""
    (name,) = os.listdir(directory)
    with open(os.path.join(directory, name)) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def check_mfu(label: str, line: dict, flops_key: str, mfu_keys: tuple) -> None:
    """The FLOP count and the MFU fields of a bench line on the card."""
    assert line[flops_key] > 0 and line["peak_tflops"] > 0, (label, line)
    for key in mfu_keys:
        assert line[key] is not None and 0 < line[key] < 1, (label, key, line[key])


def phase_flop_count(card: str) -> dict:
    """`utils.mfu` on the card against the CPU: the FLOPs of `entry()`'s
    full-size function (8 steps) counted on the card, and on the CPU
    extrapolated from 2 and 3 steps, agree to 1e-6 relative; the LF0
    encoder's GRU forward + backward (cuDNN's fused RNN on the card,
    separate products on the CPU) and a DiT block's forward + backward
    under flash_bf16 (K1's kernels on the card, the plain version on the
    CPU) count exactly the same."""
    from dex_tts_tpu_torch.entry import N_STEPS, entry
    from dex_tts_tpu_torch.utils.mfu import count_flops, extrapolated_scan_flops

    t0 = time.perf_counter()
    fn, args = entry("cuda")
    on_card = count_flops(fn, *args)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    del fn, args
    t0 = time.perf_counter()
    cpu_args = entry("cpu", n_steps=2)[1]
    on_cpu = extrapolated_scan_flops(lambda n: entry("cpu", n_steps=n)[0], N_STEPS, *cpu_args)
    cpu_s = time.perf_counter() - t0
    gru = torch.nn.GRU(192, 96, 2, batch_first=True, bidirectional=True)
    x = torch.randn(2, 200, 192)

    def gru_step(g, x):
        g(x.requires_grad_(True))[0].sum().backward()

    gru_cpu = count_flops(gru_step, gru, x.clone())
    gru_card = count_flops(gru_step, gru.cuda(), x.cuda())
    # a DiT block's forward + backward under flash_bf16 at the train step's
    # 880 tokens: K1 and its backward (counted where they launch, the
    # backward on autograd's device thread) against the plain version
    from dex_tts_tpu_torch.models.dit import DiTBlock, DiTConfig
    from dex_tts_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    torch.manual_seed(0)
    block = DiTBlock(DiTConfig(hidden_size=256, num_heads=2, attention="flash_bf16",
                               dtype="bfloat16"))
    tokens, cond = torch.randn(2, 880, 256), torch.randn(2, 256)

    def block_step(blk, x, c):
        blk(x.requires_grad_(True), c, train=True).float().sum().backward()

    block_cpu = count_flops(block_step, block, tokens.clone(), cond)
    flash_attention.launches = flash_attention_bwd.launches = 0
    block_card = count_flops(block_step, block.cuda(), tokens.cuda(), cond.cuda())
    k1 = (flash_attention.launches, flash_attention_bwd.launches)
    rel = abs(on_card - on_cpu) / on_cpu
    log(f"[flop count] entry() ({N_STEPS} steps): card {on_card} FLOPs ({card_s:.1f} s), CPU"
        f" {on_cpu} (from 2 and 3 steps, {cpu_s:.1f} s): relative difference {rel:.3e}; LF0 GRU"
        f" forward + backward card {gru_card}, CPU {gru_cpu}; DiT block forward + backward"
        f" (flash_bf16, 880 tokens) card {block_card} (K1 launches {k1}), CPU {block_cpu} [{card}]")
    assert rel <= 1e-6, (on_card, on_cpu)
    assert gru_card == gru_cpu, (gru_card, gru_cpu)
    assert k1 == (1, 1) and block_card == block_cpu, (k1, block_card, block_cpu)
    return dict(entry_card=on_card, entry_cpu=on_cpu, rel=rel, gru=gru_card, block=block_card,
                card_s=card_s, cpu_s=cpu_s)


def phase_bench(card: str) -> dict:
    """The port's benches in this process, as `python -m
    dex_tts_tpu_torch.bench ...` and `python -m dex_tts_tpu_torch.bench_train`
    run them: each JSON line logged behind its label (so that the kernels
    and device lines stay the only bare JSON lines), the launches of one
    timed call (of the timed train steps) asserted, the FLOP count and
    0 < MFU < 1 on every line; the default runs of both with ``--profile``,
    whose traces must name a kernel each (`PROFILED`). → {label: JSON line}."""
    import tempfile

    from dex_tts_tpu_torch import bench, bench_train

    lines = {}
    for label, argv, k1, k2, k5 in BENCH_RUNS:
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            line = bench.main(argv + (["--profile", tmp] if label in PROFILED else []))
            if label in PROFILED:
                kernels = trace_kernels(tmp)
                assert any(PROFILED[label] in k for k in kernels), (label, sorted(kernels))
        log(f"[bench {label}] {json.dumps(line)}")
        assert line["launches"] == {"flash_attention": k1, "snake": k2, "group_norm": k5}, (
            label, line["launches"])
        assert math.isfinite(line["value"]) and line["card"] == card, line
        check_mfu(label, line, "tflops_per_dispatch", ("mfu", "mfu_text_to_mel"))
        lines[label] = line
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        line = bench_train.main(["--profile", tmp])
        kernels = trace_kernels(tmp)
    log(f"[bench_train default] {json.dumps(line)}")
    assert any(PROFILED["train_default"] in k for k in kernels), sorted(kernels)
    log(f"[bench --profile] the traces name {PROFILED} among their device kernels")
    steps = bench_train.parse_args([]).steps
    assert line["launches"] == dict(flash_attention=0, flash_attention_bwd=0,
                                    maximum_path=steps), line["launches"]
    assert math.isfinite(line["final_loss"]) and line["card"] == card, line
    check_mfu("train_default", line, "tflops_per_step", ("mfu",))
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
    group_norm = phase_group_norm()
    bwd = phase_attention_backward()
    phase_card_vs_cpu()
    snake_f32_run = phase_bigvgan_card_vs_cpu()
    train_parity = phase_train_card_vs_cpu()
    snake_grad = phase_snake_grad()
    vocoder_parity = phase_vocoder_card_vs_cpu()
    with torch_tf32_defaults():
        train = {attention: phase_train_main_path(card, attention)
                 for attention in ("auto", "flash_bf16")}
        with tempfile.TemporaryDirectory() as tmp:
            fit = phase_trainer_fit(card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with torch_tf32_defaults():
            vocoder_train = phase_vocoder_train(card, tmp)
        config_export = phase_config_export(card, tmp)  # on vocoder_train's generator
    with tempfile.TemporaryDirectory() as tmp:
        v2_44k = phase_44k(card, tmp)
    hifigan = phase_main_path(card, "vctk_bench", {"ref_feats": random_ref_feats(16)},
                              {"ref_feats": random_ref_feats(3, seed=6)}, sampler_options=True)
    with tempfile.TemporaryDirectory() as tmp:
        wavs = write_reference_wavs(tmp, 16)
        bigvgan = phase_main_path(card, "vctk_bench_bigvgan", {"ref_wavs": wavs},
                                  {"ref_wavs": wavs[:3]})
    with tempfile.TemporaryDirectory() as tmp:
        served = phase_serve(card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        evaluated = phase_eval(card, tmp)
    walls = {}
    t0 = time.perf_counter()
    variants = phase_variants(card)
    walls["variants"] = time.perf_counter() - t0
    with torch_tf32_defaults():
        benches = phase_bench(card)
    walls["bench"] = time.perf_counter() - t0 - walls["variants"]
    flop_count = phase_flop_count(card)
    walls["flop_count"] = time.perf_counter() - t0 - walls["variants"] - walls["bench"]
    log("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    with tempfile.TemporaryDirectory() as tmp:
        parallel_run = phase_parallel(card, tmp)
    par = parallel_run["launches"]
    paths = {"hifigan": hifigan["request_1"]["launches"], "bigvgan": bigvgan["request_1"]["launches"],
             **{f"hifigan_{k}": v["launches"] for k, v in hifigan["options"].items()},
             **{f"v2_44k_{k}": v["launches"] for k, v in v2_44k.items() if k != "wall_s"},
             **served["launches"], **evaluated["launches"],
             **{f"bench_{run[0]}": benches[run[0]]["launches"] for run in BENCH_RUNS}}
    train_launches = {**{f"train_{k}": v["launches"] for k, v in train.items()},
                      "bench_train": benches["train_default"]["launches"],
                      "variant_train_flash_bf16": variants["train"]["launches"],
                      **served["launches"]}

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
                             **{k: v["flash_attention"] for k, v in train_launches.items()},
                             # Trainer.fit under flash_bf16 (steps, validation,
                             # synthesis), and its periodic synthesis alone
                             "trainer_fit": fit["fit_flash_launches"],
                             "trainer_fit_synthesis": sum(c["flash_attention"]
                                                          for c in fit["synthesis"]),
                             # the DiT variants (conv1d time position + decoder)
                             "variant_request_1": variants["request_1"]["variant"]["launches"],
                             "variant_card_vs_cpu": variants["card_vs_cpu"]["launches"],
                             # synthesize --config with vctk.yaml's f32 DeX
                             "config_synthesize": config_export["launches"]["flash_attention"],
                             **par["flash_attention"]},
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
        "launches_by_path": {**{k: v["flash_attention_bwd"] for k, v in train_launches.items()},
                             **par["flash_attention_bwd"]},
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
        "launches_by_path": {**{k: v["maximum_path"] for k, v in train_launches.items()},
                             **par["maximum_path"]},
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
        "launches_by_path": {**{k: v["snake"] for k, v in paths.items()},
                             f"vocoder_train_bigvgan_{VOCODER_STEPS}_steps":
                                 vocoder_train["bigvgan"]["launches"],
                             f"vocoder_train_hifigan_{VOCODER_STEPS_HIFIGAN}_steps":
                                 vocoder_train["hifigan"]["launches"],
                             # the exported BigVGAN: one call in bf16 (K2) and
                             # one in f32 (K3), then synthesize --config (K2)
                             "config_export_bf16": config_export["wav"]["auto"]["launches"],
                             "config_export_f32": config_export["wav"]["float32"]["launches"],
                             "config_synthesize": config_export["launches"]["snake"],
                             **par["snake"]},
        "launches_per_vocoder_train_step": vocoder_train["bigvgan"]["per_step"],
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
        # under autograd (vocoder training): kernel forward, plain backward;
        # gradients bit-equal to the plain version's, times per train step
        "autograd": {str(dt).removeprefix("torch."): v for dt, v in snake_grad.items()},
        "vocoder_step_card_vs_cpu": vocoder_parity,
        "card": card,
    }, {
        "name": "group_norm_mish",
        "route": "cuda",
        "source": "dex_tts_tpu_torch/csrc/group_norm.cu",
        "replaces": None,  # no TPU kernel: XLA fuses the JAX package's GroupNorm + Mish
        "launches": benches["default"]["launches"]["group_norm"],
        "launches_by_path": {**{f"bench_{run[0]}": benches[run[0]]["launches"]["group_norm"]
                                for run in BENCH_RUNS},
                             **{f"v2_44k_{k}": v["launches"]["group_norm"]
                                for k, v in v2_44k.items() if k != "wall_s"}},
        "max_abs_err": group_norm[torch.bfloat16]["max_abs_err"],
        # times: one denoiser call of the cells, Σ over the Block shapes of
        # (time at the shape × Blocks at it)
        "ms": group_norm[torch.bfloat16]["ms"],
        "plain_ms": group_norm[torch.bfloat16]["plain_ms"],
        "bound_ms": group_norm[torch.bfloat16]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes GroupNorm + Mish + mask
        "per": "denoiser call (13 Blocks at the cells' shapes)",
        "dtype": "bfloat16",
        "bf16": group_norm[torch.bfloat16],
        "f32": group_norm[torch.float32],
        "card": card,
    }]
    log(f"main paths: HiFi-GAN request 1 RTF {hifigan['request_1']['rtf']:.6f}, BigVGAN request 1"
        f" RTF {bigvgan['request_1']['rtf']:.6f}; esd train steps/s "
        + ", ".join(f"{k} {v['steps_per_s']:.4f}" for k, v in train.items())
        + f"; train card vs CPU worst error/bound {train_parity['worst_ratio']:.3e};"
        f" Trainer.fit {fit['wall_s']:.1f} s")
    log(f"vocoder training (f32, 16 x 8192): BigVGAN {vocoder_train['bigvgan']['steps_per_s']:.4f}"
        f" steps/s, peak {vocoder_train['bigvgan']['peak_gib']:.2f} GiB; HiFi-GAN"
        f" {vocoder_train['hifigan']['steps_per_s']:.4f} steps/s, peak"
        f" {vocoder_train['hifigan']['peak_gib']:.2f} GiB; snake per BigVGAN step (f32 kernel fwd +"
        f" plain bwd) {snake_grad[torch.float32]['per_train_step']['fwd_bwd_ms']:.3f} ms; vocoder"
        f" step card vs CPU worst error/bound {vocoder_parity['worst_ratio']:.3e} [{card}]")
    log(f"config and export: export --vocoder {config_export['export_s']:.2f} s, phase"
        f" {config_export['wall_s']:.1f} s; fold error/bound {config_export['fold_ratio']:.3e};"
        f" exported vs trained BigVGAN error/bound "
        + ", ".join(f"{k} {v['max_abs_err'] / v['bound']:.3e}"
                    for k, v in config_export["wav"].items())
        + f"; synthesize --config K1 {config_export['launches']['flash_attention']}, K2"
        f" {config_export['launches']['snake']} [{card}]")
    log(f"serving from a checkpoint: /tts x16 latency p50 {served['tts_p50_s']:.4f} s, p95"
        f" {served['tts_p95_s']:.4f} s; /tts_stream x4 time to first audio p50"
        f" {served['ttfa_p50_s']:.4f} s, p95 {served['ttfa_p95_s']:.4f} s; batch sizes"
        f" {served['batch_sizes']} [{card}]")
    log(f"eval (main test, 50 euler steps): HiFi-GAN {evaluated['hifigan']['per_item_s']['tts']:.4f}"
        f" s per item ({EVAL_ITEMS} items), BigVGAN {evaluated['bigvgan']['per_item_s']['tts']:.4f}"
        f" s ({EVAL_BIGVGAN_ITEMS}); preprocessing {evaluated['preprocess']['cuda']['per_utterance_s']:.4f}"
        f" s per utterance; mels card vs CPU {evaluated['mel_rel_err']:.3e}; GE2E card vs CPU"
        f" {evaluated['ge2e_err']} [{card}]")
    log("port bench: e2e RTF " + ", ".join(f"{k} {v['value']}" for k, v in benches.items()
                                          if k != "train_default")
        + f"; train {benches['train_default']['value']} steps/s, peak"
        f" {benches['train_default']['peak_mem_gib']:.3f} GiB; MFU "
        + ", ".join(f"{k} {v['mfu']:.6f}" for k, v in benches.items())
        + f"; entry() FLOPs card vs CPU {flop_count['rel']:.3e} relative [{card}]")
    vb = variants["request_1"]
    log(f"variants: card vs CPU mel {variants['card_vs_cpu']['mel_err']:.3e} (control"
        f" {variants['card_vs_cpu']['control_err']:.3e}); request 1 RTF plain"
        f" {vb['plain']['rtfs']}, conv1d + decoder {vb['variant']['rtfs']} (K1"
        f" {vb['plain']['launches']} / {vb['variant']['launches']}); decoder train step K1"
        f" {variants['train']['launches']}, loss {variants['train']['total_loss']:.6f} [{card}]")
    log("parallel (two gloo ranks on one card): esd DP step vs one process worst error/bound "
        + ", ".join(f"{k} {v['grad_ratio'][0]:.3e} (plain DDP {v['ddp_grad_ratio'][0]:.3e})"
                    for k, v in parallel_run["train"].items())
        + "; DP steps/s per rank " + ", ".join(f"{k} {v['steps_per_s']:.4f}"
                                              for k, v in parallel_run["train"].items())
        + f"; vocoder dp2 {parallel_run['vocoder']['worst'][0]:.3e}; synthesis dp2"
        f" {parallel_run['synthesis']['dp2']['ratio']:.3e}, dp1xtp2"
        f" {parallel_run['synthesis']['dp1xtp2']['ratio']:.3e}; nccl world 1 bit-equal"
        f" {parallel_run['nccl']['params_equal']} [{card}]")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
