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
     shapes of request 1, at ragged T and C, at k = 8 and 16, and on a
     contiguous (B, T, C) input;
  3. run a small-depth DeX (full widths, every parameter perturbed,
     attention "flash", ≥ 768 DiT tokens) once on the CPU (plain version)
     and once on the card (kernel), f32 with TF32 off, same noise; a CPU
     run with the attention output zeroed shows that the bound separates
     a broken kernel;
  3b. the same for the full-width BigVGAN in f32 on a short mel: CPU
     (plain snake) against the card (snake kernel), and a CPU run with
     every snake replaced by its input;
  4. drive the main path through `Synthesizer.tts` like a server answering
     requests: the benchmark's DeX (VCTK width, bf16, attention "auto") +
     HiFi-GAN, 50 euler steps at temperature 1.5, first 16 sentences in
     the 768-frame bucket (warm-up call, then one timed), then 3 sentences
     (padded to 4) with their own reference features (warm-up call, then
     five timed);
  4b. the same two requests through the same DeX + BigVGAN (bf16, full
     width), with reference WAV files that the script writes itself
     (`tts(ref_wavs=...)`: trim, resample, log-mel, lf0).
The last two lines are the `kernels` JSON line and the device JSON line.
Needs one card; exits non-zero without CUDA.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
MAIN_SHAPE = (16, 3840, 2, 128)  # (B, T, H, hd): 16 × 768 frames, 20 × 192 patches
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


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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


def attention_bound_ms(b, t, h, hd, dtype) -> tuple[float, str]:
    """Least time for exact attention: each of q, k, v read once, o
    written once, against 4·B·H·T²·hd operations at the type's peak."""
    elem = torch.tensor([], dtype=dtype).element_size()
    t_bytes = 4 * b * t * h * hd * elem / PEAK_BYTES
    t_ops = 4 * b * h * t * t * hd / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def qkv_views(b, t, h, hd, dtype, seed):
    """q, k, v as the DiT hands them over: strided views of one
    (B, T, 3, H, hd) projection output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3, h, hd), generator=g, device="cuda", dtype=dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def phase_kernels():
    """Kernel vs plain version on the card; returns the per-type report."""
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
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, scale=scale), 20
        )
        bound_ms, bound_by = attention_bound_ms(*MAIN_SHAPE, dtype)
        report[dtype] = dict(max_abs_err=worst, tolerance=tol_name, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"flash_attention {dtype} at {MAIN_SHAPE}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
            f" sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return report


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


def snake_inputs(b, t, c, dtype, seed, contiguous=False):
    """x as BigVGAN hands it over, a (B, T, C) transpose of a (B, C, T)
    buffer (or a contiguous (B, T, C) tensor), with alpha and inv_beta as
    logscale snakebeta parameters near the reference's, in x's dtype."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if contiguous:
        x = 2 * torch.randn((b, t, c), generator=g, device="cuda")
    else:
        x = 2 * torch.randn((b, c, t), generator=g, device="cuda").transpose(1, 2)
    alpha = torch.exp(0.3 * torch.randn(c, generator=g, device="cuda"))
    inv_beta = 1.0 / (torch.exp(0.3 * torch.randn(c, generator=g, device="cuda")) + 1e-9)
    return x.to(dtype), alpha.to(dtype), inv_beta.to(dtype)


def phase_snake():
    """The snake kernel against its plain version on the card (bf16 with
    the polynomial sin² as the bf16 generator runs it; f32 with the exact
    sine), then kernel, plain and bound times at the six stage shapes."""
    from dex_tts_tpu_torch.ops.snake import snake_antialias, snake_antialias_reference

    ragged = [(2, t, c) for t in (1, 2, 17, 777) for c in (3, 24)]
    report = {}
    for dtype, impl, fast, tol_name in ((torch.bfloat16, "auto", True, "8e-3 x max|y|"),
                                        (torch.float32, "pallas", False, "atol 2e-5")):
        worst = 0.0
        cases = ([(shape, 12, False) for shape in SNAKE_STAGES + ragged]
                 + [((2, 777, 24), k, False) for k in (8, 16)]
                 + [((2, 777, 24), 12, True), ((4, 4096, 96), 12, True)])
        for i, (shape, k, contiguous) in enumerate(cases):
            x, al, ib = snake_inputs(*shape, dtype, seed=i, contiguous=contiguous)
            got = snake_antialias(x, al, ib, kernel_size=k, impl=impl)
            want = snake_antialias_reference(x, al, ib, k, fast)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            bound = 8e-3 * want.float().abs().max().item() if dtype == torch.bfloat16 else 2e-5
            log(f"snake {dtype} {shape} k={k}{' contiguous' if contiguous else ''}:"
                f" max_abs_err {err:.3e} (bound {bound:.3e})")
            assert got.dtype == x.dtype and got.shape == x.shape, (got.dtype, got.shape)
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
            log(f"snake {dtype} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                f" bound {max(t_bytes, t_ops):.4f} ms ({stages[-1]['bound_by']})")
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
            f" bound {per_call['bound_ms']:.3f} ms")
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

    def run(model, device):
        with torch.no_grad():
            return model.synthesize(
                y_max_length=y_max, sampler=SamplerConfig(num_steps=2), temperature=1.5,
                **{k: v.to(device) for k, v in inputs.items()},
            )

    want = run(cpu_model, "cpu")
    # the bound must separate a broken kernel: the same run with the
    # attention output zeroed lands far outside it
    with mock.patch.object(dit, "flash_attention", lambda q, k, v, scale: torch.zeros_like(q)):
        zeroed = run(cpu_model, "cpu")
    flash_attention.launches = 0
    got = run(gpu_model, "cuda")
    torch.cuda.synchronize()
    launches = flash_attention.launches
    err = (got[1].cpu() - want[1]).abs().max().item()
    zeroed_err = (zeroed[1] - want[1]).abs().max().item()
    log(f"card vs CPU (f32, depth-cut DeX, 820 tokens, 2 steps): mel max_abs_err {err:.3e}"
        f" (bound {MEL_ATOL:.0e}; attention zeroed: {zeroed_err:.3e}), launches {launches}")
    assert torch.equal(got[3].cpu(), want[3]), "y_lengths differ"
    assert launches == cfg.dit.depth * 2, launches
    assert math.isfinite(err) and err <= MEL_ATOL, err
    assert zeroed_err > 10 * MEL_ATOL, zeroed_err


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


def phase_main_path(card: str, preset_name: str, refs_1: dict, refs_2: dict) -> dict:
    """One main path through Synthesizer.tts: request 1 (16 long
    sentences, warm-up then one timed call) and request 2 (3 short ones,
    warm-up then five timed calls). ``refs_*``: the style keyword of
    `tts` (``ref_feats`` or ``ref_wavs``). Each kernel's count is set to
    0 just before each call and read just after. → request 1's launches
    per kernel, wall and RTF, and request 2's walls."""
    from dex_tts_tpu_torch.models.dit import resolve_attention_mode, token_count
    from dex_tts_tpu_torch.models.vocoder import BigVGANGenerator
    from dex_tts_tpu_torch.ops.attention import flash_attention
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.pipeline import SAMPLE_RATE

    preset, synth = build_main_path(preset_name)
    dit_cfg = preset.model.dit_config()
    n_snakes = SNAKE_LAUNCHES if isinstance(synth.vocoder, BigVGANGenerator) else 0

    def request(texts, refs, label):
        feats = refs.get("ref_feats") or [synth.prepare_reference(p) for p in refs["ref_wavs"]]
        inputs, b = synth.prepare_batch(texts, ref_feats=feats)
        y_len = synth.frame_bucket(inputs, max_frames=768)
        assert synth.predict_frames(inputs) <= y_len, "an item would be cut at the bucket"
        tokens = token_count(dit_cfg, y_len // 2)
        torch.cuda.synchronize()
        flash_attention.launches = snake_antialias.launches = 0
        t0 = time.perf_counter()
        out = synth.tts(texts, temperature=preset.temperature, max_frames=768,
                        generator=torch.Generator("cuda").manual_seed(6), **refs)
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
        for r in out:
            assert r["wav"].shape == (r["n_frames"] * synth.hop,)
            assert np.isfinite(r["wav"]).all() and np.isfinite(r["mel"]).all()
        if resolve_attention_mode(dit_cfg, tokens) == "flash_bf16":
            assert launches["flash_attention"] == dit_cfg.depth * preset.n_timesteps, launches
        assert launches["snake"] == n_snakes, launches
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
    return dict(request_1=first, request_2_walls_s=walls)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import tempfile

    from dex_tts_tpu_torch.ops.kernels import build_all

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    report = phase_kernels()
    snake = phase_snake()
    phase_card_vs_cpu()
    snake_f32_run = phase_bigvgan_card_vs_cpu()
    hifigan = phase_main_path(card, "vctk_bench", {"ref_feats": random_ref_feats(16)},
                              {"ref_feats": random_ref_feats(3, seed=6)})
    with tempfile.TemporaryDirectory() as tmp:
        wavs = write_reference_wavs(tmp, 16)
        bigvgan = phase_main_path(card, "vctk_bench_bigvgan", {"ref_wavs": wavs},
                                  {"ref_wavs": wavs[:3]})
    paths = {"hifigan": hifigan["request_1"]["launches"], "bigvgan": bigvgan["request_1"]["launches"]}

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
        "launches_by_path": {k: v["flash_attention"] for k, v in paths.items()},
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
        "shape": list(MAIN_SHAPE),
        "dtype": "bfloat16",
        "max_abs_err_f32": f32["max_abs_err"],
        "f32": {k: f32[k] for k in timing_keys},
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
        f" RTF {bigvgan['request_1']['rtf']:.6f}")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
