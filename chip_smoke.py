#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. build every kernel of `dex_tts_tpu_torch/csrc/` with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shape and at ragged lengths, and time kernel, plain
     version and the library yardstick with CUDA events;
  3. run a small-depth DeX (full widths, every parameter perturbed,
     attention "flash", ≥ 768 DiT tokens) once on the CPU (plain version)
     and once on the card (kernel), f32 with TF32 off, same noise; a CPU
     run with the attention output zeroed shows that the bound separates
     a broken kernel;
  4. drive the main path through `Synthesizer.tts` like a server answering
     requests: the benchmark's DeX (VCTK width, bf16, attention "auto") +
     HiFi-GAN, 50 euler steps at temperature 1.5, first 16 sentences in
     the 768-frame bucket (warm-up call, then one timed), then 3 sentences
     (padded to 4) with their own reference features (warm-up call, then
     five timed).
The last two lines are the `kernels` JSON line and the device JSON line.
Needs one card; exits non-zero without CUDA.
"""

import json
import math
import subprocess
import sys
import time

import torch

# H100 SXM data-sheet peaks (dense)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
MAIN_SHAPE = (16, 3840, 2, 128)  # (B, T, H, hd): 16 × 768 frames, 20 × 192 patches
MEL_ATOL = 1e-3  # card vs CPU, f32 with TF32 off
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


def build_main_path():
    """The benchmark's DeX (VCTK width, bf16, attention "auto") + HiFi-GAN
    on the card, random weights from fixed seeds → (preset, Synthesizer)."""
    from dex_tts_tpu_torch.config import build_model, load_preset
    from dex_tts_tpu_torch.models.edm import SamplerConfig
    from dex_tts_tpu_torch.models.vocoder import HiFiGANGenerator
    from dex_tts_tpu_torch.pipeline import Synthesizer

    preset = load_preset("vctk_bench")
    torch.manual_seed(0)
    model = build_model(preset.model, device="cuda")
    perturb_(model, seed=3)
    with torch.no_grad():
        model.encoder.proj_w.proj.weight.zero_()
        model.encoder.proj_w.proj.bias.fill_(math.log(FRAMES_PER_TOKEN))
    vocoder = HiFiGANGenerator(preset.vocoder)
    perturb_(vocoder, seed=4, scale=0.002)
    synth = Synthesizer(model, vocoder, cmu_path=preset.cmu_path,
                        sampler=SamplerConfig(num_steps=preset.n_timesteps), device="cuda")
    return preset, synth


def phase_main_path(card: str):
    """The benchmark's DeX + HiFi-GAN through Synthesizer.tts."""
    import numpy as np

    from dex_tts_tpu_torch.models.dit import resolve_attention_mode, token_count
    from dex_tts_tpu_torch.ops.attention import flash_attention
    from dex_tts_tpu_torch.pipeline import SAMPLE_RATE

    preset, synth = build_main_path()
    dit_cfg = preset.model.dit_config()
    rng = np.random.default_rng(5)

    def feats(n, t_ref=256):
        return [(rng.standard_normal((80, t_ref)).astype(np.float32),
                 rng.standard_normal(t_ref).astype(np.float32)) for _ in range(n)]

    def request(texts, ref_feats, label):
        inputs, b = synth.prepare_batch(texts, ref_feats=ref_feats)
        y_len = synth.frame_bucket(inputs, max_frames=768)
        assert synth.predict_frames(inputs) <= y_len, "an item would be cut at the bucket"
        tokens = token_count(dit_cfg, y_len // 2)
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = synth.tts(texts, ref_feats=ref_feats, temperature=preset.temperature,
                        max_frames=768, generator=torch.Generator("cuda").manual_seed(6))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        audio_s = sum(r["n_frames"] for r in out) * synth.hop / SAMPLE_RATE
        bucket_s = inputs["x"].shape[0] * y_len * synth.hop / SAMPLE_RATE
        log(f"{label}: batch {b} (padded {inputs['x'].shape[0]}), bucket {y_len} frames,"
            f" {tokens} DiT tokens, wall {wall:.3f} s, RTF {wall / audio_s:.6f} over"
            f" {audio_s:.2f} s audio ({wall / bucket_s:.6f} over the padded bucket),"
            f" flash launches {launches} [{card}]")
        assert len(out) == len(texts)
        for r in out:
            assert r["wav"].shape == (r["n_frames"] * synth.hop,)
            assert np.isfinite(r["wav"]).all() and np.isfinite(r["mel"]).all()
        if resolve_attention_mode(dit_cfg, tokens) == "flash_bf16":
            assert launches == dit_cfg.depth * preset.n_timesteps, launches
        return y_len, launches, wall

    request(SENTENCES, feats(16), "warm-up 16 x long")
    y_len, launches, wall = request(SENTENCES, feats(16), "request 1: 16 x long")
    assert y_len == 768, y_len
    # latency of a short request, warm: one untimed call at its bucket first
    short_feats = feats(3)
    request(REQUEST_2, short_feats, "warm-up 3 x short")
    walls = sorted(request(REQUEST_2, short_feats, f"request 2.{i}: 3 x short")[2]
                   for i in range(5))
    log(f"request 2 latency over 5 warm calls: min {walls[0]:.4f} s, median {walls[2]:.4f} s,"
        f" max {walls[-1]:.4f} s [{card}]")
    return launches, wall


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dex_tts_tpu_torch.ops.kernels import build_all

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    report = phase_kernels()
    phase_card_vs_cpu()
    launches, _ = phase_main_path(card)

    bf16, f32 = report[torch.bfloat16], report[torch.float32]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "dex_tts_tpu_torch/csrc/flash_attention.cu",
        "replaces": "dex_tts_tpu/models/dit.py:410",
        "replaces_also": "dex_tts_tpu/models/dit.py:367",
        "launches": launches,
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
        "shape": list(MAIN_SHAPE),
        "dtype": "bfloat16",
        "max_abs_err_f32": f32["max_abs_err"],
        "f32": {k: f32[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "card": card,
    }]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
