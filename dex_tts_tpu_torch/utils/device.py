"""The port's device policy: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a visible card
    raises instead of silently running on the CPU; ``"cpu"`` must be asked
    for explicitly (the CPU tests do)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
