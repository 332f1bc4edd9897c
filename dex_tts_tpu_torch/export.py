"""Export the port's checkpoints in the reference PyTorch layouts (port of
the torch side of dex_tts_tpu/export.py and of export_torch.py).

  # TTS experiment → <exp_dir>/export/model-export.pth
  python -m dex_tts_tpu_torch.export --config cfg.yaml --weight_path checkpoints/VCTK-0 \\
      [--tag best-train] [--out PATH]

  # vocoder generator (the config's vocoder and path.vocoder_path select it)
  python -m dex_tts_tpu_torch.export --config cfg.yaml --vocoder [--out generator.pth]

``--preset NAME`` may replace ``--config``. A vocoder becomes a
``{'generator': ...}`` dict with the weight-norm parametrization restored
(``weight_g``/``weight_v`` for every conv weight), the layout the
reference's generators and loaders read (reference: DEX-TTS/hifigan/
models.py:112-174, bigvgan/models.py:140-218, src/utils.py:251-281);
BigVGAN's Kaiser-sinc ``.filter`` buffers are left out, as JAX's exporter
leaves them out. It is what `eval.evaluation.load_vocoder` finds (a
missing checkpoint raises), loaded in f32 on the CPU. A TTS experiment's
``<exp_dir>/ckpt/<tag>.pth`` (`train.checkpoint.CheckpointManager`)
becomes ``{'state_dict', 'ema'}``, the layout of the reference's
evaluation and synthesis loaders (reference: DEX-TTS/src/evaluation.py:
29-34, synthesize.py:68-72), without the optimizer, scores and step; both
are checked against the config's model by a strict load first.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from dex_tts_tpu_torch.config import Preset, build_model, load_preset_or_config
from dex_tts_tpu_torch.convert import load_numpy_state
from dex_tts_tpu_torch.eval.evaluation import load_vocoder


def split_weight_norm(state: dict) -> dict:
    """Inverse of `convert.fold_weight_norm`: every conv weight W (key
    ending ``.weight``, ndim ≥ 2) as ``weight_g`` = ‖W‖ over the non-output
    axes, in float64 and cast to float32, and ``weight_v`` = W, so that
    g · v / ‖v‖ == W up to f32 rounding. Other entries are kept. Values
    are numpy arrays (or anything `np.asarray` takes), as JAX's."""
    out = {}
    for key, value in state.items():
        v = np.asarray(value)
        if key.endswith(".weight") and v.ndim >= 2:
            axes = tuple(range(1, v.ndim))
            out[key + "_g"] = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes,
                                             keepdims=True)).astype(np.float32)
            out[key + "_v"] = v
        else:
            out[key] = v
    return out


def vocoder_reference_state(generator: torch.nn.Module) -> dict:
    """A HiFi-GAN or BigVGAN generator → its reference state_dict in f32
    numpy with weight norm split (`split_weight_norm`): the reference's
    names, BigVGAN's upsamplers at ``ups.{i}.0`` and its snake ``alpha``/
    ``beta`` at ``resblocks.{m}.activations.{j}.act`` and
    ``activation_post.act``, no ``.filter`` buffers."""
    return split_weight_norm({k: v.detach().to("cpu", torch.float32).numpy()
                              for k, v in generator.state_dict().items()})


def save_torch_checkpoint(path: str, trees: dict) -> None:
    """torch.save a {section: flat numpy dict} container, e.g.
    ``{'state_dict': ..., 'ema': ...}`` or ``{'generator': ...}``."""
    torch.save({section: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}
                for section, tree in trees.items()}, path)


def export_vocoder(preset: Preset, out: str) -> dict:
    """The vocoder `load_vocoder` finds for ``preset``, in f32 on the CPU,
    → ``out`` as ``{'generator': ...}``. → the exported state."""
    vocoder = load_vocoder(dataclasses.replace(preset, vocoder_dtype="float32"), device="cpu")
    state = vocoder_reference_state(vocoder)
    save_torch_checkpoint(out, {"generator": state})
    print(f"wrote {out} ({len(state)} tensors, weight-norm restored)")
    return state


def export_tts(preset: Preset, exp_dir: str, tag: str, out: str) -> None:
    """``<exp_dir>/ckpt/<tag>.pth`` → ``out`` as ``{'state_dict', 'ema'}``,
    both loaded strictly into the preset's model on the CPU first."""
    path = os.path.join(exp_dir, "ckpt", f"{tag}.pth")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    trees = {k: {n: t.numpy() for n, t in ckpt[k].items()} for k in ("state_dict", "ema")}
    model = build_model(preset.model, device="cpu")
    for tree in trees.values():
        load_numpy_state(model, tree)
    save_torch_checkpoint(out, trees)
    print(f"wrote {out} ({len(trees['state_dict'])} tensors + ema)")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    source = p.add_mutually_exclusive_group(required=True)
    source.add_argument("--config", default=None, metavar="YAML",
                        help="a YAML config in the JAX package's layout")
    source.add_argument("--preset", default=None, help="one of config.PRESETS")
    p.add_argument("--weight_path", default=None,
                   help="TTS export: the experiment directory with ckpt/<tag>.pth")
    p.add_argument("--tag", default="best-train", help="TTS export: the checkpoint tag")
    p.add_argument("--vocoder", action="store_true",
                   help="export the generator that the config's vocoder and "
                        "path.vocoder_path select, instead of the TTS model")
    p.add_argument("--out", default=None,
                   help="output .pth path (default: <weight_path>/export/model-export.pth, "
                        "or ./generator-export.pth)")
    args = p.parse_args(argv)
    if not args.vocoder and not args.weight_path:
        p.error("--weight_path is required for TTS export")
    return args


def main(argv=None) -> str:
    """Run the CLI → the path written."""
    args = parse_args(argv)
    preset = load_preset_or_config(args.preset, args.config)
    if args.vocoder:
        out = args.out or "./generator-export.pth"
    else:
        out = args.out or os.path.join(args.weight_path, "export", "model-export.pth")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    if args.vocoder:
        export_vocoder(preset, out)
    else:
        export_tts(preset, args.weight_path, args.tag, out)
    return out


if __name__ == "__main__":
    main()
