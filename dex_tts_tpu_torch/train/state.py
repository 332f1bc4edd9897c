"""Train state: model + optimizer + EMA + generator (port of
dex_tts_tpu/train/state.py).

The JAX package keeps params, Adam moments, EMA params, the BatchNorm and
VQ collections and the rng key in one pytree. Here the model's parameters
and buffers (BatchNorm running statistics, the VQ codebook) live in the
module, the Adam moments in a `torch.optim.Adam`, the EMA in a dict of
tensors and the rng in one `torch.Generator` on the model's device.
reference: DEX-TTS/src/train.py:28-62.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn


@dataclass
class TrainState:
    """``step`` counts optimizer updates; ``ema`` maps each parameter name
    to its exponential moving average."""

    step: int
    model: nn.Module
    ema: dict
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    max_grad: float


def make_optimizer(params, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam(lr, b1 0.9, b2 0.999, eps 1e-8): the update of optax.adam, eps
    added to the bias-corrected root. reference: DEX-TTS/src/train.py."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def global_norm(grads) -> torch.Tensor:
    """sqrt(Σ g²) over every tensor, as optax.global_norm, on the device."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g ← g / norm · max_norm unless
    norm < max_norm, decided on the device (no host sync). Unlike
    torch.nn.utils.clip_grad_norm_ nothing is added to the norm. ``norm``:
    the global norm when ``grads`` are not the whole model's (tensor
    parallelism), else computed here. Returns the norm before clipping."""
    if norm is None:
        norm = global_norm(grads)
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def ema_update_(ema: dict, model: nn.Module, decay: float) -> None:
    """optax.incremental_update(params, ema, step_size=1 - decay), in place:
    ema ← (1 - step)·ema + step·p."""
    step = 1.0 - decay
    with torch.no_grad():
        for name, p in model.named_parameters():
            ema[name].mul_(1.0 - step).add_(p, alpha=step)


def ema_state_dict(state: TrainState) -> dict:
    """The EMA weights as a full model state_dict (buffers from the model),
    the reference's deep-copied EMA model."""
    sd = state.model.state_dict()
    return {k: state.ema.get(k, v) for k, v in sd.items()}


def create_train_state(model: nn.Module, seed: int = 100, lr: float = 1e-4,
                       max_grad: float = 1.0) -> TrainState:
    """A fresh state around an initialised ``model`` (on its device): Adam,
    EMA = a copy of the parameters, generator seeded with ``seed``. The
    model is put in module train mode, which only cuDNN's GRU needs for
    its backward: train-time behaviour is the ``train`` argument."""
    model.train()
    device = next(model.parameters()).device
    return TrainState(
        step=0,
        model=model,
        ema={n: p.detach().clone() for n, p in model.named_parameters()},
        optimizer=make_optimizer(model.parameters(), lr),
        generator=torch.Generator(device=device).manual_seed(seed),
        max_grad=float(max_grad),
    )
