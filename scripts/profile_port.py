#!/usr/bin/env python3
"""Where the time goes on the port's main paths, on one NVIDIA card.

    python3 scripts/profile_port.py            # synthesis
    python3 scripts/profile_port.py --train    # training
    python3 scripts/profile_port.py --vocoder  # vocoder GAN training
    python3 scripts/profile_port.py --variant  # the DiT variant's request 1

Builds both of chip_smoke's main paths with chip_smoke.build_main_path
(the benchmark DeX at VCTK width, bf16, attention "auto", random weights,
with HiFi-GAN; then with the bf16 BigVGAN, fed reference WAV files that
chip_smoke.write_reference_wavs writes) and, for each of chip_smoke's two
requests (16 sentences in the 768-frame bucket; 3 short sentences padded
to 4), warms up once, then
  1. times the stages of one `Synthesizer.tts` call with the host clock
     around synchronised work: reference front end (WAV path only),
     duration pre-pass, text→mel synthesis (style + text encoders, 50
     denoiser steps), vocoder;
  2. traces one more call with torch.profiler and prints device time by
     kernel (top 25), grouped into families, kernel launches, and the
     device's idle share of the call's wall time.
With ``--train`` it profiles the training main path instead
(chip_smoke.build_train_path: the ESD preset at full width on
bench_train's batch, PyTorch's TF32 defaults), for attention "auto" and
"flash_bf16": after two warm-up steps, two steps timed with the host clock
and two traced. With ``--vocoder`` it profiles the vocoder GAN train
step the same way, as `python -m dex_tts_tpu_torch.train_vocoder` runs it
at its defaults (f32 BigVGAN, then HiFi-GAN, with the MPD/MRD critics,
16 × 8192 samples cut from chip_smoke's reference WAVs, PyTorch's TF32
defaults). With ``--variant`` it profiles request 1 through the
`vctk_bench` DeX + HiFi-GAN twice, plain and with chip_smoke.VARIANT (the
DiT's conv1d time position and its decoder), as above.
Prints one JSON line last. Needs a card.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = (  # first match wins, by substring of the kernel name
    ("flash_attention (csrc)", ("flash_fwd",)),
    ("flash_attention backward (csrc)", ("flash_bwd",)),
    ("mas (csrc)", ("mas_kernel",)),
    ("snake (csrc)", ("snake_fwd",)),
    ("convolution", ("conv", "implicit_gemm", "xmma_fprop", "dgrad", "wgrad", "winograd", "fft")),
    ("matmul", ("gemm", "cutlass", "sm90_xmma", "ampere", "cublas", "gemv", "splitk")),
    ("softmax / norm / reduce", ("softmax", "norm", "reduce", "welford")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "cat", "fill", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile_request(preset, synth, texts, refs) -> dict:
    """Stage times and one traced `tts` call of one request, after a
    warm-up. ``refs``: the style keyword of `tts` (``ref_feats`` or
    ``ref_wavs``)."""
    from dex_tts_tpu_torch.pipeline import SAMPLE_RATE

    def call():
        return synth.tts(texts, temperature=preset.temperature, max_frames=768,
                         generator=torch.Generator("cuda").manual_seed(6), **refs)

    call()  # warm-up: cuDNN algorithm choice, kernel build
    torch.cuda.synchronize()

    # 1. stages, host clock around synchronised work
    stages = {}
    with torch.no_grad():
        feats = refs.get("ref_feats")
        if feats is None:
            t0 = time.perf_counter()
            feats = [synth.prepare_reference(p) for p in refs["ref_wavs"]]
            torch.cuda.synchronize()
            stages["reference front end"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inputs, b = synth.prepare_batch(texts, ref_feats=feats)
        y_len = synth.frame_bucket(inputs, max_frames=768)
        torch.cuda.synchronize()
        stages["duration pre-pass"] = time.perf_counter() - t0
        cond = {k: v for k, v in inputs.items() if k not in ("x", "x_lengths")}
        t0 = time.perf_counter()
        _, mel, _, y_lengths = synth.model.synthesize(
            inputs["x"], inputs["x_lengths"], y_max_length=y_len, sampler=synth.sampler,
            temperature=preset.temperature, generator=torch.Generator("cuda").manual_seed(6),
            **cond,
        )
        torch.cuda.synchronize()
        stages["text->mel (encoders + 50 steps)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        synth.vocoder(mel)
        torch.cuda.synchronize()
        stages["vocoder"] = time.perf_counter() - t0
    audio_s = y_lengths[:b].sum().item() * synth.hop / SAMPLE_RATE
    for k, v in stages.items():
        print(f"stage {k}: {v * 1e3:.1f} ms")

    # 2. one traced call
    traced = trace(call)
    return {
        "batch": b, "padded_batch": inputs["x"].shape[0], "frames": y_len,
        "steps": preset.n_timesteps, "audio_s": audio_s,
        "rtf_untraced": sum(stages.values()) / audio_s,
        "stages_ms": {k: v * 1e3 for k, v in stages.items()},
        **traced,
    }


def trace(fn) -> dict:
    """Run ``fn`` (then synchronise) under torch.profiler; print and return
    the wall time, device busy time, idle share, launches and device time
    by kernel family."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        # a profiler annotation such as "Optimizer.step#Adam.step" is a
        # range over kernels already counted, not a kernel
        annotation = re.fullmatch(r"[\w.]+#[\w.]+", e.key) is not None
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            rows.append((e.key, dev / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    fams = {}
    for name, ms, _ in rows:
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    print(f"traced call: wall {wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms,"
          f" idle share {1 - busy_ms / (wall * 1e3):.3f}, {launches} kernel launches")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"family {fam}: {ms:.1f} ms ({ms / busy_ms:.3f} of device time)")
    for name, ms, n in rows[:25]:
        print(f"kernel {ms:9.2f} ms  x{n:<6d} {name[:110]}")
    return {"traced_wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / (wall * 1e3), "kernel_launches": launches,
            "families_ms": fams}


def profile_train(card: str, attention: str, steps: int = 2) -> dict:
    """Host-clock time of ``steps`` train steps and one trace of ``steps``
    more, after two warm-up steps."""
    import chip_smoke
    from dex_tts_tpu_torch.train.trainer import metrics_to_host

    cfg, mode, state, step, batch = chip_smoke.build_train_path(attention)
    print(f"== esd train step, attention {attention} → {mode} [{card}]")
    for _ in range(2):
        metrics_to_host(step(state, batch))

    def run():
        for _ in range(steps):
            metrics = step(state, batch)
        return metrics_to_host(metrics)

    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    print(f"{steps} steps untraced: {wall * 1e3:.1f} ms, {steps / wall:.4f} steps/s")
    report = {"mode": mode, "steps": steps, "untraced_ms": wall * 1e3,
              "steps_per_s": steps / wall, **trace(run)}
    del state
    torch.cuda.empty_cache()
    return report


def profile_vocoder(card: str, kind: str, wav_dir: str, steps: int = 2) -> dict:
    """`profile_train` for the vocoder GAN step (``kind``: "bigvgan" or
    "hifigan") on one batch of the CLI's shape."""
    from dex_tts_tpu_torch.audio.stft import MelSpectrogram
    from dex_tts_tpu_torch.data.vocoder_dataset import WavSegmentDataset, wav_paths_from_source
    from dex_tts_tpu_torch.models.vocoder import BigVGANConfig, HiFiGANConfig
    from dex_tts_tpu_torch.ops.snake import snake_antialias
    from dex_tts_tpu_torch.train import vocoder as tv

    cfg = BigVGANConfig() if kind == "bigvgan" else HiFiGANConfig()
    state = tv.create_vocoder_train_state(cfg, seed=100, device="cuda")
    step = tv.make_vocoder_train_step(MelSpectrogram(), MelSpectrogram(fmax=11025.0))
    batch = next(WavSegmentDataset(wav_paths_from_source(wav_dir), seed=100).batches(16, 1))
    print(f"== vocoder train step, {kind}, 16 x 8192 [{card}]")
    for _ in range(2):
        step(state, batch)

    def run():
        for _ in range(steps):
            metrics = step(state, batch)
        return {k: v.item() for k, v in metrics.items()}

    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    print(f"{steps} steps untraced: {wall * 1e3:.1f} ms, {steps / wall:.4f} steps/s")
    snake_antialias.launches = 0
    report = {"steps": steps, "untraced_ms": wall * 1e3, "steps_per_s": steps / wall,
              **trace(run), "snake_launches": snake_antialias.launches}
    del state
    torch.cuda.empty_cache()
    return report


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--train", action="store_true", help="profile the training main path")
    p.add_argument("--vocoder", action="store_true", help="profile vocoder GAN training")
    p.add_argument("--variant", action="store_true",
                   help="profile request 1 of the plain DeX and of its DiT variant")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port: CUDA is not available")

    import chip_smoke

    card = chip_smoke.card_line()
    report = {"card": card, "paths": {}}
    if args.train:
        report["paths"]["esd train"] = {a: profile_train(card, a) for a in ("auto", "flash_bf16")}
    if args.vocoder:
        with tempfile.TemporaryDirectory() as tmp:
            chip_smoke.write_reference_wavs(tmp, 16)
            report["paths"]["vocoder train"] = {k: profile_vocoder(card, k, tmp)
                                                for k in ("bigvgan", "hifigan")}
    if args.train or args.vocoder:
        report["nvidia_smi"] = nvidia_smi()
        print(json.dumps(report))
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.variant:
        refs = {"ref_feats": chip_smoke.random_ref_feats(16)}
        for label, overrides in (("plain", {}), ("conv1d + decoder", chip_smoke.VARIANT)):
            preset, synth = chip_smoke.build_main_path("vctk_bench", **overrides)
            print(f"== vctk_bench {label}, 16 x long [{card}]")
            report["paths"][f"vctk_bench {label}"] = {
                "16 x long": profile_request(preset, synth, chip_smoke.SENTENCES, refs)}
            del synth
            torch.cuda.empty_cache()
        report["nvidia_smi"] = nvidia_smi()
        print(json.dumps(report))
        return
    with tempfile.TemporaryDirectory() as tmp:
        wavs = chip_smoke.write_reference_wavs(tmp, 16)
        for preset_name, refs_1, refs_2 in (
            ("vctk_bench", {"ref_feats": chip_smoke.random_ref_feats(16)},
             {"ref_feats": chip_smoke.random_ref_feats(3, seed=6)}),
            ("vctk_bench_bigvgan", {"ref_wavs": wavs}, {"ref_wavs": wavs[:3]}),
        ):
            preset, synth = chip_smoke.build_main_path(preset_name)
            requests = report["paths"][preset_name] = {}
            for label, texts, refs in (("16 x long", chip_smoke.SENTENCES, refs_1),
                                       ("3 x short", chip_smoke.REQUEST_2, refs_2)):
                print(f"== {preset_name}, {label} [{card}]")
                requests[label] = profile_request(preset, synth, texts, refs)
            del synth
            torch.cuda.empty_cache()
    report["nvidia_smi"] = nvidia_smi()
    print(json.dumps(report))


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


if __name__ == "__main__":
    main()
