"""One-shot synthesis CLI (port of synthesize.py).

    # expressive (style from reference wavs):
    python -m dex_tts_tpu_torch.synthesize --config dex_tts_tpu/config/presets/vctk.yaml \\
        --weight_path checkpoints/VCTK-0 --input_text "Hello there." \\
        --ref_name ref1.wav ref2.wav

    # general (speaker id), a paragraph joined with pauses:
    python -m dex_tts_tpu_torch.synthesize --preset gedex_vctk \\
        --weight_path checkpoints/VCTK-0/model-last.pth --spk_id 3 \\
        --input_text "First sentence. Second one." --long

``--config`` reads a YAML config in the JAX package's layout
(`config.preset_from_config`); ``--preset`` names one of the port's
presets instead. ``--weight_path`` is an experiment directory
(``ckpt/<tag>.pth`` of the port's trainer, or the reference's
``model-*.pth``) or a ``.pth`` file; the vocoder comes from the config's
``path.vocoder_path``. ``--device`` replaces synthesize.py's
``--platform``: CUDA unless ``--device cpu``. ``--random_init``
synthesizes from random weights when no checkpoint is found (a smoke run;
the output is noise). Writes one int16 WAV per reference (``sample.wav``
without one) at the config's ``preprocess.sample_rate``.
"""

from __future__ import annotations

import argparse
import os

import torch

from dex_tts_tpu_torch.audio.wav import write_wav
from dex_tts_tpu_torch.config import load_preset_or_config
from dex_tts_tpu_torch.eval.evaluation import load_synthesizer


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    source = p.add_mutually_exclusive_group(required=True)
    source.add_argument("--config", default=None, metavar="YAML",
                        help="a YAML config in the JAX package's layout")
    source.add_argument("--preset", default=None, help="one of config.PRESETS")
    p.add_argument("--weight_path", required=True,
                   help="experiment dir (ckpt/<tag>.pth or model-*.pth) or a .pth file")
    p.add_argument("--input_text", required=True)
    p.add_argument("--ref_name", nargs="*", default=None, help="reference wavs (DEX)")
    p.add_argument("--spk_id", type=int, default=None, help="speaker id (GeDEX)")
    p.add_argument("--n_timesteps", type=int, default=50)
    p.add_argument("--dit_cache_interval", type=int, default=1,
                   help="approximate turbo sampling: reuse the DiT "
                        "mid-block for k-1 of every k steps (1 = exact)")
    p.add_argument("--solver", default="euler", choices=["euler", "heun", "dpmpp2m"],
                   help="ODE solver; dpmpp2m (DPM-Solver++ 2M, 2nd-order "
                        "multistep) reaches the 50-step euler solution "
                        "with ~16-25 steps")
    p.add_argument("--temperature", type=float, default=1.5)
    p.add_argument("--length_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--out_dir", default="./synth_out")
    p.add_argument("--checkpoint_tag", default="best-train")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--long", action="store_true",
                   help="treat --input_text as a paragraph: sentence-split, "
                        "synthesize in batches, concatenate with pauses")
    p.add_argument("--pause_ms", type=float, default=200.0,
                   help="inter-sentence silence for --long")
    p.add_argument("--random_init", action="store_true",
                   help="random weights when no checkpoint is found (smoke runs only)")
    return p.parse_args(argv)


def main(argv=None) -> list[tuple[str, dict]]:
    """Run the CLI; → [(wav path, {"wav", "n_frames"})] per written file."""
    args = parse_args(argv)
    torch.manual_seed(args.seed)  # random-init weights only
    synth = load_synthesizer(
        load_preset_or_config(args.preset, args.config), args.weight_path,
        n_timesteps=args.n_timesteps, tag=args.checkpoint_tag,
        dit_cache_interval=args.dit_cache_interval, solver=args.solver, device=args.device,
        random_init=args.random_init,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    # one generator feeds every call in turn, as synthesize.py splits one key
    generator = torch.Generator(synth.device).manual_seed(args.seed)
    written = []
    for ref in args.ref_name or [None]:
        common = dict(
            generator=generator,
            temperature=args.temperature,
            length_scale=args.length_scale,
            spk_ids=[args.spk_id] if args.spk_id is not None else None,
            ref_wavs=[ref] if ref else None,
        )
        if args.long:
            long_out = synth.tts_long(args.input_text, pause_ms=args.pause_ms, **common)
            out = {"wav": long_out["wav"],
                   "n_frames": sum(s["n_frames"] for s in long_out["sentences"])}
        else:
            out = synth.tts([args.input_text], **common)[0]
        stem = os.path.splitext(os.path.basename(ref))[0] if ref else "sample"
        path = os.path.join(args.out_dir, f"{stem}.wav")
        write_wav(path, out["wav"], synth.audio.sample_rate)
        print(f"wrote {path} ({out['n_frames']} frames)")
        written.append((path, out))
    return written


if __name__ == "__main__":
    main()
