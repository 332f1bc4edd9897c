"""The EDM ODE samplers in float32: euler and DPM-Solver++(2M) over the
EDM σ ladder (Karras et al. 2022, σ from 80 down to 0.002 with ρ = 7,
then 0), with the EDM preconditioning of the denoiser (σ_data = 0.5).
reference: DEX-TTS/model/edm.py:88-211; DPM-Solver++(2M): Lu et al.
2022, arXiv 2211.01095, data-prediction multistep form.
"""

from __future__ import annotations

import numpy as np
import torch

SIGMA_DATA = 0.5


def sigmas(steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0):
    i = np.arange(steps, dtype=np.float64)
    ladder = (sigma_max ** (1 / rho)
              + i / (steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([ladder, [0.0]])


def denoised(fn, x, sigma: float):
    """D(x; σ) = c_skip·x + c_out·F(c_in·x; ln(σ)/4)."""
    s = torch.full((x.shape[0],), sigma, dtype=x.dtype, device=x.device)
    c_skip = SIGMA_DATA**2 / (sigma**2 + SIGMA_DATA**2)
    c_out = sigma * SIGMA_DATA / (sigma**2 + SIGMA_DATA**2) ** 0.5
    c_in = 1.0 / (sigma**2 + SIGMA_DATA**2) ** 0.5
    return c_skip * x + c_out * fn(c_in * x, torch.log(s) / 4)


def sample(fn, latents, solver: str, steps: int):
    """x_N = σ_0·latents, then ``steps`` steps of ``solver`` down to σ = 0."""
    sig = sigmas(steps)
    x = latents * float(np.float32(sig[0]))
    if solver == "euler":
        for i in range(steps):
            s, s_next = float(np.float32(sig[i])), float(np.float32(sig[i + 1]))
            x = x + (s_next - s) * (x - denoised(fn, x, s)) / s
        return x
    if solver == "dpmpp2m":
        lam = -np.log(sig[:steps])
        h = np.diff(lam)  # h_i = λ_{i+1} − λ_i, i < steps − 1
        old = None
        for i in range(steps):
            s = float(np.float32(sig[i]))
            den = denoised(fn, x, s)
            d = den
            if 0 < i < steps - 1:  # second order between the first and last steps
                r = h[i - 1] / h[i]
                d = (1 + 1 / (2 * r)) * den - 1 / (2 * r) * old
            ratio = sig[i + 1] / sig[i]
            x = ratio * x + (1 - ratio) * d
            old = den
        return x
    raise ValueError(f"unknown solver {solver!r}")
