"""EDM preconditioning, the training loss and the ODE samplers: euler,
heun, DPM-Solver++(2M) and the DiT-cache ("turbo") euler sampler (port of
dex_tts_tpu/models/edm.py).

reference: DEX-TTS/model/edm.py:22-211. Training noise is mu-shifted,
n = (randn + mu)·σ (reference: model/edm.py:64). Every schedule quantity
is a host-side numpy array precomputed by `build_schedule` /
`build_dpmpp2m_schedule` (copies of the JAX package's); each sampling loop
is a Python loop of denoiser evaluations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from dex_tts_tpu_torch.parallel import collectives


def edm_precond_scalings(sigma, sigma_data: float = 0.5):
    """c_skip, c_out, c_in, c_noise. reference: DEX-TTS/model/edm.py:88-98."""
    c_skip = sigma_data**2 / (sigma**2 + sigma_data**2)
    c_out = sigma * sigma_data / torch.sqrt(sigma**2 + sigma_data**2)
    c_in = 1.0 / torch.sqrt(sigma_data**2 + sigma**2)
    c_noise = torch.log(sigma) / 4.0
    return c_skip, c_out, c_in, c_noise


def apply_precond(denoise_fn, x, sigma, sigma_data: float = 0.5, has_aux: bool = False,
                  **kwargs):
    """D(x; σ) = c_skip·x + c_out·F(c_in·x; c_noise); x (B, F, W), sigma (B,).
    has_aux: denoise_fn returns (F_x, aux) and the aux rides along
    (DiT-cache sampling)."""
    c_skip, c_out, c_in, _ = edm_precond_scalings(sigma.reshape(-1, 1, 1), sigma_data)
    c_noise = torch.log(sigma) / 4.0
    if has_aux:
        f_x, aux = denoise_fn(c_in * x, c_noise, **kwargs)
        return c_skip * x + c_out * f_x, aux
    return c_skip * x + c_out * denoise_fn(c_in * x, c_noise, **kwargs)


def edm_loss_weight(sigma, loss_type: str = "base", sigma_data: float = 0.5):
    """Per-σ loss weight, every reference variant.
    reference: DEX-TTS/model/edm.py:37-62."""
    base = (sigma**2 + sigma_data**2) / (sigma * sigma_data) ** 2
    snr = 1.0 / sigma**2
    if loss_type == "base":
        return base
    if loss_type.startswith("base_min_"):
        return torch.clamp(base, max=float(loss_type.removeprefix("base_min_")))
    if loss_type.startswith("base_log_"):
        k = float(loss_type.removeprefix("base_log_"))
        return torch.where(base >= k, torch.log(base) + (k - math.log(k)), base)
    if loss_type.startswith("min_snr_"):
        return torch.clamp(snr, max=float(loss_type.removeprefix("min_snr_")))
    if loss_type.startswith("max_snr_"):
        return torch.clamp(snr, min=float(loss_type.removeprefix("max_snr_")))
    if loss_type == "snr":
        return snr
    if loss_type == "inv_snr":
        return 1.0 / snr
    raise ValueError(f"unknown loss_type {loss_type!r}")


def edm_loss(denoise_fn, x0, mask, mu, n_feats: int = 80, p_mean: float = -1.2,
             p_std: float = 1.2, sigma_data: float = 0.5, loss_type: str = "base",
             generator=None, draws=None, **kwargs):
    """EDM training loss with mu-shifted noise. x0, mu (B, F, W), mask
    (B, 1, W). σ = exp(r·p_std + p_mean) per item; ``draws`` = (r (B, 1, 1),
    noise (B, F, W)), standard normals, else both drawn from
    ``generator``. Data-parallel: the global batch's draws and mask sum
    (`parallel.collectives`). reference: DEX-TTS/model/edm.py:22-68."""
    if draws is None:
        rnd = collectives.randn((x0.shape[0], 1, 1), generator=generator, device=x0.device)
        noise = collectives.randn(x0.shape, generator=generator, device=x0.device)
    else:
        rnd, noise = draws
    sigma = torch.exp(rnd.to(x0.dtype) * p_std + p_mean)
    weight = edm_loss_weight(sigma, loss_type, sigma_data)
    n = (noise.to(x0.dtype) + mu) * sigma
    d_x = apply_precond(denoise_fn, x0 + n, sigma[:, 0, 0], sigma_data, **kwargs)
    return (weight * (d_x - x0) ** 2).sum() / (collectives.global_sum(mask.sum()) * n_feats)


@dataclass(frozen=True)
class SamplerConfig:
    """Same fields and defaults as the JAX package's SamplerConfig.
    ``unroll`` only tunes the TPU scan and is ignored here."""

    num_steps: int = 50
    solver: str = "euler"
    discretization: str = "edm"
    schedule: str = "linear"
    scaling: str = "none"
    sigma_min: float | None = None
    sigma_max: float | None = None
    rho: float = 7.0
    epsilon_s: float = 1e-3
    c_1: float = 0.001
    c_2: float = 0.008
    m_steps: int = 1000
    alpha: float = 1.0
    s_churn: float = 0.0
    s_min: float = 0.0
    s_max: float = float("inf")
    s_noise: float = 1.0
    dit_cache_interval: int = 1
    unroll: int = 2


def _schedule_fns(cfg: SamplerConfig, vp_beta_d: float, vp_beta_min: float):
    if cfg.schedule == "vp":
        sigma = lambda t: np.sqrt(np.exp(0.5 * vp_beta_d * t**2 + vp_beta_min * t) - 1)
        sigma_deriv = lambda t: 0.5 * (vp_beta_min + vp_beta_d * t) * (
            sigma(t) + 1 / sigma(t)
        )
        sigma_inv = lambda s: (
            np.sqrt(vp_beta_min**2 + 2 * vp_beta_d * np.log(s**2 + 1)) - vp_beta_min
        ) / vp_beta_d
    elif cfg.schedule == "ve":
        sigma = lambda t: np.sqrt(t)
        sigma_deriv = lambda t: 0.5 / np.sqrt(t)
        sigma_inv = lambda s: s**2
    else:
        sigma = lambda t: t
        sigma_deriv = lambda t: np.ones_like(t)
        sigma_inv = lambda s: s
    if cfg.scaling == "vp":
        s_fn = lambda t: 1 / np.sqrt(1 + sigma(t) ** 2)
        s_deriv = lambda t: -sigma(t) * sigma_deriv(t) * s_fn(t) ** 3
    else:
        s_fn = lambda t: np.ones_like(np.asarray(t, dtype=np.float64))
        s_deriv = lambda t: np.zeros_like(np.asarray(t, dtype=np.float64))
    return sigma, sigma_deriv, sigma_inv, s_fn, s_deriv


_vp_sigma = lambda bd, bm: lambda t: np.sqrt(np.exp(0.5 * bd * t**2 + bm * t) - 1)


def _resolve_sigma_range(cfg: SamplerConfig) -> tuple[float, float]:
    """Per-discretization default σ range. reference: edm.py:122-135."""
    sigma_min, sigma_max = cfg.sigma_min, cfg.sigma_max
    if sigma_min is None:
        sigma_min = {
            "vp": float(_vp_sigma(19.9, 0.1)(cfg.epsilon_s)),
            "ve": 0.02, "iddpm": 0.002, "edm": 0.002,
        }[cfg.discretization]
    if sigma_max is None:
        sigma_max = {
            "vp": float(_vp_sigma(19.9, 0.1)(1.0)),
            "ve": 100.0, "iddpm": 81.0, "edm": 80.0,
        }[cfg.discretization]
    return sigma_min, sigma_max


def _discretize_sigmas(cfg, sigma_min, sigma_max, vp_beta_d, vp_beta_min):
    """The per-step σ ladder (n,), descending. reference: edm.py:137-152
    (iddpm in float64, as in the JAX package)."""
    n = cfg.num_steps
    i = np.arange(n, dtype=np.float64)
    if cfg.discretization == "vp":
        orig_t = 1 + i / (n - 1) * (cfg.epsilon_s - 1)
        return _vp_sigma(vp_beta_d, vp_beta_min)(orig_t)
    if cfg.discretization == "ve":
        orig_t = sigma_max**2 * (sigma_min**2 / sigma_max**2) ** (i / (n - 1))
        return np.sqrt(orig_t)
    if cfg.discretization == "iddpm":
        m = cfg.m_steps
        u = np.zeros(m + 1)
        alpha_bar = lambda j: np.sin(0.5 * np.pi * j / m / (cfg.c_2 + 1)) ** 2
        for j in range(m, 0, -1):
            u[j - 1] = np.sqrt(
                (u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), cfg.c_1) - 1
            )
        u_filtered = u[(u >= sigma_min) & (u <= sigma_max)]
        idx = np.round((len(u_filtered) - 1) / (n - 1) * i).astype(np.int64)
        return u_filtered[idx]
    return (
        sigma_max ** (1 / cfg.rho)
        + i / (n - 1) * (sigma_min ** (1 / cfg.rho) - sigma_max ** (1 / cfg.rho))
    ) ** cfg.rho


def _vp_betas(cfg: SamplerConfig, sigma_min: float, sigma_max: float):
    vp_beta_d = (
        2 * (np.log(sigma_min**2 + 1) / cfg.epsilon_s - np.log(sigma_max**2 + 1))
        / (cfg.epsilon_s - 1)
    )
    vp_beta_min = np.log(sigma_max**2 + 1) - 0.5 * vp_beta_d
    return vp_beta_d, vp_beta_min


def build_schedule(cfg: SamplerConfig) -> dict[str, np.ndarray]:
    """Precompute all per-step scalars of the generalized sampler.
    reference: DEX-TTS/model/edm.py:110-180."""
    n = cfg.num_steps
    sigma_min, sigma_max = _resolve_sigma_range(cfg)
    vp_beta_d, vp_beta_min = _vp_betas(cfg, sigma_min, sigma_max)
    sigma_steps = _discretize_sigmas(cfg, sigma_min, sigma_max, vp_beta_d, vp_beta_min)
    sigma, sigma_deriv, sigma_inv, s_fn, s_deriv = _schedule_fns(
        cfg, vp_beta_d, vp_beta_min
    )

    t_steps = np.concatenate([sigma_inv(sigma_steps), [0.0]])
    t_cur = t_steps[:-1]
    t_next = t_steps[1:]
    gamma = np.where(
        (cfg.s_min <= sigma(t_cur)) & (sigma(t_cur) <= cfg.s_max),
        min(cfg.s_churn / n, np.sqrt(2) - 1),
        0.0,
    )
    t_hat = sigma_inv(sigma(t_cur) + gamma * sigma(t_cur))
    churn_std = (
        np.sqrt(np.maximum(sigma(t_hat) ** 2 - sigma(t_cur) ** 2, 0.0))
        * s_fn(t_hat) * cfg.s_noise
    )
    h = t_next - t_hat
    t_prime = t_hat + cfg.alpha * h

    def coeffs(t):
        a = sigma_deriv(t) / sigma(t) + s_deriv(t) / s_fn(t)
        b = sigma_deriv(t) * s_fn(t) / sigma(t)
        return a, b

    a_hat, b_hat = coeffs(t_hat)
    a_pr, b_pr = coeffs(np.where(t_prime > 0, t_prime, 1.0))

    f32 = lambda x: np.asarray(x, np.float32)
    return {
        "x_init_scale": f32(sigma(t_steps[0]) * s_fn(t_steps[0])),
        "ratio_s": f32(s_fn(t_hat) / s_fn(t_cur)),
        "churn_std": f32(churn_std),
        "inv_s_hat": f32(1.0 / s_fn(t_hat)),
        "sigma_hat": f32(sigma(t_hat)),
        "a_hat": f32(a_hat),
        "b_hat": f32(b_hat),
        "h": f32(h),
        "alpha_h": f32(cfg.alpha * h),
        "inv_s_prime": f32(1.0 / s_fn(np.where(t_prime > 0, t_prime, 1.0))),
        "sigma_prime": f32(sigma(np.where(t_prime > 0, t_prime, 1.0))),
        "a_prime": f32(a_pr),
        "b_prime": f32(b_pr),
        "last_step": np.arange(n) == n - 1,
    }


def build_dpmpp2m_schedule(cfg: SamplerConfig) -> dict[str, np.ndarray]:
    """Per-step coefficients of DPM-Solver++(2M) (Lu et al. 2022, arXiv
    2211.01095), data-prediction multistep form for x = x₀ + σ·ε (scaling
    "none"); a copy of the JAX package's. With λ = −ln σ:

        x_{i+1} = (σ_{i+1}/σ_i)·x_i + (1 − σ_{i+1}/σ_i)·D̃_i
        D̃_i = c1_i·D_i + c2_i·D_{i−1},  c1 = 1 + 1/(2r), c2 = −1/(2r),
        r_i = h_{i−1}/h_i,  h_i = λ_{i+1} − λ_i

    The first and last steps are first order (c1 = 1, c2 = 0). It shares
    the σ ladder with the euler/heun sampler."""
    n = cfg.num_steps
    sigma_min, sigma_max = _resolve_sigma_range(cfg)
    vp_beta_d, vp_beta_min = _vp_betas(cfg, sigma_min, sigma_max)
    sig = _discretize_sigmas(cfg, sigma_min, sigma_max, vp_beta_d, vp_beta_min)

    ratio = np.concatenate([sig[1:], [0.0]]) / sig  # σ_{i+1}/σ_i; last → 0
    c1 = np.ones(n)
    c2 = np.zeros(n)
    if n > 2:
        lam = -np.log(sig)
        h = lam[1:] - lam[:-1]
        r = h[:-1] / h[1:]  # r_i for i = 1..n-2
        c1[1: n - 1] = 1.0 + 1.0 / (2.0 * r)
        c2[1: n - 1] = -1.0 / (2.0 * r)

    f32 = lambda x: np.asarray(x, np.float32)
    return {
        "x_init_scale": f32(sig[0]),
        "sigma": f32(sig),
        "ratio": f32(ratio),
        "cd": f32(1.0 - ratio),
        "c1": f32(c1),
        "c2": f32(c2),
    }


def _per_step(sched: dict, i: int) -> dict[str, float]:
    return {k: float(v[i]) for k, v in sched.items() if k != "x_init_scale"}


def ablation_sampler(denoise_fn, latents, cfg: SamplerConfig, sigma_data: float = 0.5,
                     generator=None, denoise_fn_mid=None, denoise_fn_cached=None, **cond):
    """Euler / heun / dpmpp2m ODE sampler, and the DiT-cache euler sampler
    when ``cfg.dit_cache_interval`` > 1. reference: DEX-TTS/model/edm.py:104-211.

    denoise_fn(x, t, **cond) is the raw network (preconditioning applied
    here); latents: (B, n_feats, W). ``generator`` feeds the churn noise
    (only used with s_churn > 0). The DiT cache also needs
    denoise_fn_mid(x, t, **cond) → (out, mid) (a full evaluation that
    keeps the DiT's output) and denoise_fn_cached(x, t, mid=mid, **cond)
    (the conv path only, reusing it). Invalid combinations raise
    ValueError, checked in the JAX package's order."""
    if cfg.solver not in ("euler", "heun", "dpmpp2m"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    b = latents.shape[0]

    def denoised_at(x, sigma):
        sigma_b = torch.full((b,), sigma, dtype=latents.dtype, device=latents.device)
        return apply_precond(denoise_fn, x, sigma_b, sigma_data, **cond)

    if cfg.solver == "dpmpp2m":
        return _dpmpp2m_sampler(denoised_at, latents, cfg)
    sched = build_schedule(cfg)
    if cfg.dit_cache_interval > 1:
        return _dit_cache_sampler(denoise_fn_mid, denoise_fn_cached, latents, cfg, sched,
                                  sigma_data, **cond)

    x = latents * float(sched["x_init_scale"])
    for i in range(cfg.num_steps):
        ps = _per_step(sched, i)
        x_hat = ps["ratio_s"] * x
        if cfg.s_churn > 0:
            noise = collectives.randn(x.shape, generator=generator, dtype=x.dtype,
                                      device=x.device)
            x_hat = x_hat + ps["churn_std"] * noise
        den = denoised_at(x_hat * ps["inv_s_hat"], ps["sigma_hat"])
        d_cur = ps["a_hat"] * x_hat - ps["b_hat"] * den
        if cfg.solver == "heun" and not sched["last_step"][i]:
            # the reference skips the 2nd-order correction on the last step
            x_prime = x_hat + ps["alpha_h"] * d_cur
            den2 = denoised_at(x_prime * ps["inv_s_prime"], ps["sigma_prime"])
            d_prime = ps["a_prime"] * x_prime - ps["b_prime"] * den2
            x = x_hat + ps["h"] * (
                (1 - 1 / (2 * cfg.alpha)) * d_cur + (1 / (2 * cfg.alpha)) * d_prime
            )
        else:
            x = x_hat + ps["h"] * d_cur
    return x


def _dpmpp2m_sampler(denoised_at, latents, cfg: SamplerConfig):
    """DPM-Solver++(2M) (see `build_dpmpp2m_schedule`): deterministic, one
    denoiser evaluation per step on the unscaled x; the first-order first
    and last steps come from the (c1, c2) arrays, not from branches."""
    if cfg.scaling != "none":
        raise ValueError("solver='dpmpp2m' requires scaling='none'")
    if cfg.s_churn > 0:
        raise ValueError("solver='dpmpp2m' is deterministic (no churn)")
    if cfg.dit_cache_interval > 1:
        raise ValueError("solver='dpmpp2m' is incompatible with dit_cache_interval>1")
    sched = build_dpmpp2m_schedule(cfg)
    x = latents * float(sched["x_init_scale"])
    old_den = torch.zeros_like(x)
    for i in range(cfg.num_steps):
        ps = _per_step(sched, i)
        den = denoised_at(x, ps["sigma"])
        x = ps["ratio"] * x + ps["cd"] * (ps["c1"] * den + ps["c2"] * old_den)
        old_den = den
    return x


def _dit_cache_sampler(denoise_fn_mid, denoise_fn_cached, latents, cfg: SamplerConfig,
                       sched: dict, sigma_data: float, **cond):
    """Euler sampling in chunks of k = cfg.dit_cache_interval steps: the
    chunk's first step runs the full denoiser and keeps the DiT's output
    ``mid``; the k−1 steps after it reuse it (fresh conv path, fresh x and
    σ), each an euler step with its own coefficients. Approximate: the
    exact path is dit_cache_interval=1."""
    k = cfg.dit_cache_interval
    if cfg.solver != "euler":
        raise ValueError("dit_cache_interval>1 requires the euler solver")
    if cfg.s_churn > 0:
        raise ValueError("dit_cache_interval>1 is incompatible with churn")
    if cfg.num_steps % k:
        raise ValueError(
            f"num_steps {cfg.num_steps} must be a multiple of dit_cache_interval {k}"
        )
    if denoise_fn_mid is None or denoise_fn_cached is None:
        raise ValueError("dit_cache_interval>1 needs denoise_fn_mid and denoise_fn_cached")
    b = latents.shape[0]

    def sigma_b(ps):
        return torch.full((b,), ps["sigma_hat"], dtype=latents.dtype, device=latents.device)

    x = latents * float(sched["x_init_scale"])
    mid = None
    for i in range(cfg.num_steps):
        ps = _per_step(sched, i)
        x_hat = ps["ratio_s"] * x
        if i % k == 0:
            den, mid = apply_precond(denoise_fn_mid, x_hat * ps["inv_s_hat"], sigma_b(ps),
                                     sigma_data, has_aux=True, **cond)
        else:
            den = apply_precond(denoise_fn_cached, x_hat * ps["inv_s_hat"], sigma_b(ps),
                                sigma_data, mid=mid, **cond)
        x = x_hat + ps["h"] * (ps["a_hat"] * x_hat - ps["b_hat"] * den)
    return x
