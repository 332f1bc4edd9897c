"""The benchmark's plain reference: DeX-TTS / GeDEX-TTS, the EDM samplers
and the HiFi-GAN and BigVGAN generators in float32 PyTorch, and the
front end that turns a batch of sentences into the same padded inputs
(`tts`). It imports nothing of the program under test.

Each part a configuration names under ``parts`` is built by the module
``benchmark/reference/<name>.py`` (``build(config)``; `dex_tts`,
`hifigan`, `bigvgan`) from the libraries here (`model`, `sampler`,
`text`, `vocoders`). `lower_precision` rounds the matrix products and
convolutions of a module to a lower precision (the control of the
correctness comparison).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from benchmark.reference.model import TTS
from benchmark.reference.text import read_cmudict, text_to_ids


def bucket(n: int, quantum: int, minimum: int = 0) -> int:
    return max(minimum, -(-n // quantum) * quantum)


def frame_bucket(frames: int, y_quantum: int, max_frames: int) -> int:
    """The frame count a batch is synthesized at: the largest item's
    frames to a multiple of ``y_quantum`` (at least 8), capped at
    ``max_frames``, then to a multiple of 4 (two U-Net downsamplings)."""
    return bucket(min(bucket(frames, y_quantum, 8), max_frames), 4)


@torch.no_grad()
def tts(model: TTS, texts, cmudict, ref_feats, generator, synth: dict, traffic: dict,
        device):
    """One batch through the reference: token ids, the pre-pass, the frame
    bucket, the initial noise (the first draw of ``generator``, over the
    batch padded to a power of two) and text→mel. → dict with ``ids``
    (per item), ``frames`` (the pre-pass's frames per item, uncapped),
    ``bucket``, ``mel`` (B, F, bucket) and ``lengths`` (B,)."""
    ids = [text_to_ids(t, cmudict) for t in texts]
    b = len(ids)
    x = torch.zeros(b, bucket(max(map(len, ids)), synth["x_quantum"]), dtype=torch.long)
    for i, s in enumerate(ids):
        x[i, : len(s)] = torch.tensor(s)
    x_lengths = torch.tensor([len(s) for s in ids])
    style = {}
    if ref_feats is not None:
        t_ref = bucket(max(m.shape[1] for m, _ in ref_feats), synth["y_quantum"], 4)
        ref = np.zeros((b, ref_feats[0][0].shape[0], t_ref), np.float32)
        lf0 = np.zeros((b, t_ref), np.float32)
        for i, (m, l) in enumerate(ref_feats):
            ref[i, :, : m.shape[1]] = m
            lf0[i, : len(l)] = l
        style = {"ref": torch.from_numpy(ref).to(device), "lf0": torch.from_numpy(lf0).to(device),
                 "ref_lengths": torch.tensor([m.shape[1] for m, _ in ref_feats], device=device)}
    encoded = model.encode(x.to(device), x_lengths.to(device), **style)
    frames = model.frames(encoded[1], encoded[2]).long()
    y_max = frame_bucket(int(frames.max()), synth["y_quantum"], traffic["max_frames"])
    b_pad = 1 << (b - 1).bit_length() if synth["pad_batches"] else b
    noise = torch.randn((b_pad, model.c["n_feats"], y_max), generator=generator,
                        device=device)[:b]
    mel, lengths = model.synthesize(encoded, y_max, noise, traffic["solver"], traffic["steps"],
                                    traffic["temperature"])
    return {"ids": ids, "frames": frames.cpu(), "bucket": y_max, "mel": mel,
            "lengths": lengths.cpu()}


def _round(x: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    if dtype == "float8_e4m3fn":  # one scale per tensor, to the format's largest value
        scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(torch.float8_e4m3fn).max
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    raise ValueError(f"no rounding to {dtype!r}")


@torch.no_grad()
def lower_precision(module: nn.Module, dtypes: dict[str, str]) -> nn.Module:
    """Round the weights and the inputs of every Linear and convolution in
    ``module`` to the precision that ``dtypes`` gives it (computed on in
    float32 after the rounding). ``dtypes`` maps a dotted module path to
    a precision; the longest path that leads to a layer is its own."""
    kinds = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)
    for name, m in module.named_modules():
        if not isinstance(m, kinds):
            continue
        owner = max((p for p in dtypes if not p or name == p or name.startswith(p + ".")),
                    key=len)
        dtype = dtypes[owner]
        m.weight.copy_(_round(m.weight, dtype))
        m.register_forward_pre_hook(
            lambda _, args, dtype=dtype: (_round(args[0], dtype),) + args[1:])
    return module


__all__ = ["frame_bucket", "lower_precision", "read_cmudict", "tts"]
