"""Multi-rank dry run of the port's parallel paths on the CPU (the
counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m dex_tts_tpu_torch.dryrun [N] --device cpu

The CPU must be asked for: at these widths the DiT's head_dim is 16, which
the flash-attention kernel does not take, so there is no card run.

`dryrun_multichip(n)` starts ``n`` gloo ranks on the CPU and runs, at tiny
widths: one data-parallel train step of DeX-TTS against the one-process
step on the same global batch; when ``n`` is even a dp×tp2 step, whose
loss must lie within 1e-2 of the dp loss (JAX's bound); and
`Synthesizer.tts` over dp ``n`` and dp ``n/2`` × tp2, against the
one-process mels.
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from dex_tts_tpu_torch import parallel
from dex_tts_tpu_torch.models.dit import DiTConfig
from dex_tts_tpu_torch.models.edm import SamplerConfig
from dex_tts_tpu_torch.models.tts import TTSConfig, build_tts
from dex_tts_tpu_torch.train import create_train_state
from dex_tts_tpu_torch.train.trainer import make_train_step

# __graft_entry__.dryrun_multichip's widths
CFG = TTSConfig(
    n_vocab=149, n_feats=16, enc_channels=24, enc_filter_channels=32,
    enc_filter_channels_dp=16, enc_heads=2, enc_layers=2, dec_dim=8, dec_dim_mults=(1, 2),
    dit=DiTConfig(patch_size=3, stride_size=2, hidden_size=32, depth=1, num_heads=2,
                  mlp_ratio=2.0, conv_pos=4, conv_pos_groups=2),
    tv_c_h=12, tv_c_out=24, tv_c_out_g=24, tv_layers=2, tv_n_emb=16, lf0_c_h=12, lf0_c_out=24,
    lf0_c_out_g=24, lf0_layers=1, tiv_c_h=16, tiv_c_out=8, tiv_layers=2, use_style=True,
)
OUT_SIZE = 16


def tiny_batch(b: int, seed: int = 0) -> dict:
    """The JAX dry run's batch: ``b`` rows of 12 tokens, 32 mel frames."""
    rng = np.random.default_rng(seed)
    style = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in (("ref", (b, 16, 24)), ("lf0", (b, 24)))}
    full = lambda n: np.full((b,), n, np.int64)  # noqa: E731
    return {
        "x": rng.integers(1, 148, (b, 12)).astype(np.int64), "x_lengths": full(12),
        "y": rng.standard_normal((b, 16, 32)).astype(np.float32), "y_lengths": full(32),
        "ref": style["ref"], "ref_lengths": full(24), "sty": style["ref"], "sty_lengths": full(24),
        "lf0": style["lf0"], "lf0_lengths": full(24),
    }


def _state(seed: int = 0):
    torch.manual_seed(seed)
    return create_train_state(build_tts(CFG), seed=seed, lr=1e-4, max_grad=1.0)


def _step_loss(batch, mesh=None, tp: bool = False) -> float:
    state = _state()
    step = make_train_step(out_size=OUT_SIZE)
    if mesh is not None:
        parallel.replicate_state(state, mesh)
        if tp:
            parallel.shard_train_state(state, mesh)
        step = parallel.make_parallel_train_step(step, mesh)
        batch = parallel.shard_rows(batch, mesh)
    return float(step(state, batch)["total_loss"])


def _mels(model, texts, mesh=None) -> list:
    from dex_tts_tpu_torch.pipeline import Synthesizer

    synth = Synthesizer(model, None, sampler=SamplerConfig(num_steps=2), device="cpu",
                        x_quantum=8, y_quantum=16, mesh=mesh)
    rng = np.random.default_rng(1)
    feats = [(rng.standard_normal((16, 20)).astype(np.float32),
              rng.standard_normal(20).astype(np.float32)) for _ in texts]
    out = synth.tts(texts, generator=torch.Generator().manual_seed(5), ref_feats=feats)
    return [r["mel"] for r in out]


def _rank(rank: int, n: int) -> dict:
    b = max(n, 2)
    batch = tiny_batch(b)
    out = {"one": _step_loss(batch), "dp": _step_loss(batch, parallel.make_mesh(n))}
    texts = ["one", "two three", "four five six", "seven"][: max(n, 2)]
    torch.manual_seed(7)  # synthesis weights: the same seed on every rank
    model = build_tts(CFG)
    out["mel_one"] = _mels(copy.deepcopy(model), texts)
    out["mel_dp"] = _mels(copy.deepcopy(model), texts, parallel.make_mesh(n))
    if n % 2 == 0:
        tp_mesh = parallel.make_mesh(n, tp_size=2)
        out["dp_tp"] = _step_loss(batch, tp_mesh, tp=True)
        out["mel_tp"] = _mels(copy.deepcopy(model), texts, tp_mesh)
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """The dry run over ``n_devices`` gloo ranks on the CPU (module
    docstring); raises on a mismatch → rank 0's numbers."""
    res = parallel.launch(_rank, n_devices, args=(n_devices,), devices=["cpu"] * n_devices,
                          timeout=600)
    r0 = res[0]
    for r in res:
        assert r["dp"] == r0["dp"], "ranks disagree on the dp loss"
    assert np.isfinite(r0["dp"]), r0
    np.testing.assert_allclose(r0["dp"], r0["one"], rtol=1e-5)
    print(f"dryrun_multichip({n_devices}): dp total_loss={r0['dp']:.4f} "
          f"(one process {r0['one']:.4f}) OK")
    keys = ["mel_dp"]
    if n_devices % 2 == 0:
        assert abs(r0["dp_tp"] - r0["dp"]) < 1e-2 * max(1.0, abs(r0["dp"])), r0
        print(f"dryrun_multichip({n_devices}): dp{n_devices // 2}xtp2 "
              f"total_loss={r0['dp_tp']:.4f} OK")
        keys.append("mel_tp")
    for r in res:
        for key in keys:
            assert len(r[key]) == len(r0["mel_one"])
            for got, want in zip(r[key], r0["mel_one"]):
                np.testing.assert_allclose(got, want, atol=2e-5)
    print(f"dryrun_multichip({n_devices}): sharded synthesis ({', '.join(keys)}) "
          "matches one process OK")
    return r0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", nargs="?", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="must be cpu: the dry run's ranks run on the CPU only")
    args = p.parse_args(argv)
    if args.device != "cpu":
        p.error("the dry run's tiny model runs on the CPU only (its head_dim 16 has no "
                "kernel on the card); pass --device cpu")
    return dryrun_multichip(args.n_devices)


if __name__ == "__main__":
    main()
