"""The full-size text→mel function and its example inputs (counterpart of
`__graft_entry__.entry`): the benchmark's DeX (`vctk_bench`: the
reference's VCTK width, bf16, attention "auto", random weights from seed
0) synthesizing b = 2 items of 64 tokens into the 256-frame bucket
(1300 DiT tokens: K1 on the card) from 200 frames of seeded reference
features, with an 8-step euler sampler at temperature 1.5.

    fn, args = entry("cuda")
    enc, mel, attn, y_lengths = fn(*args)
"""

from __future__ import annotations

import torch

from dex_tts_tpu_torch.bench import style_inputs
from dex_tts_tpu_torch.config import build_model, load_preset
from dex_tts_tpu_torch.models.edm import SamplerConfig
from dex_tts_tpu_torch.utils.device import resolve_device

B, TX, TY, T_REF = 2, 64, 256, 200
N_STEPS = 8


def entry(device="cuda", n_steps: int = N_STEPS):
    """→ (fn, example_args) on ``device`` (CUDA unless the caller names
    another). ``fn(*example_args)`` runs `synthesize` without grad, the
    sampler noise from a generator seeded 3 on each call; ``n_steps``
    other than 8 gives the same function at another step count (as a FLOP
    count extrapolates over steps, `utils.mfu.extrapolated_scan_flops`)."""
    device = resolve_device(device)
    preset = load_preset("vctk_bench")
    torch.manual_seed(0)
    model = build_model(preset.model, device=device)
    sampler = SamplerConfig(num_steps=n_steps)
    style = {k: torch.from_numpy(v).to(device) for k, v in
             style_inputs(B, preset.model.n_feats, T_REF).items()}
    style = {k: v.long() if k.endswith("lengths") else v for k, v in style.items()}

    @torch.no_grad()
    def fn(x, x_lengths, ref, ref_lengths, sty, sty_lengths, lf0, lf0_lengths):
        return model.synthesize(
            x, x_lengths, y_max_length=TY, sampler=sampler, temperature=1.5,
            generator=torch.Generator(device).manual_seed(3), ref=ref,
            ref_lengths=ref_lengths, sty=sty, sty_lengths=sty_lengths, lf0=lf0,
            lf0_lengths=lf0_lengths,
        )

    args = (
        torch.ones((B, TX), dtype=torch.long, device=device),
        torch.full((B,), TX, dtype=torch.long, device=device),
        style["ref"], style["ref_lengths"], style["sty"], style["sty_lengths"],
        style["lf0"], style["lf0_lengths"],
    )
    return fn, args
