"""Tiny cells for the CPU tests: each configuration file narrowed and cut
to one layer per stack, the traffic cut to two sentences per call and
two sampler steps, everything in float32 so that the program and the
plain reference agree to rounding."""

from __future__ import annotations

import copy
import json
import os

from benchmark.run import ROOT, Cell, load_cell

TINY_TTS = dict(enc_channels=32, enc_filter_channels=64, enc_filter_channels_dp=32,
                enc_layers=2, dec_dim=16, compute_dtype="float32", tv_c_h=16, tv_c_out=32,
                tv_c_out_g=16, tv_layers=1, tv_n_emb=8, lf0_c_h=16, lf0_c_out=32,
                lf0_c_out_g=16, lf0_layers=1, tiv_c_h=32, tiv_c_out=8, tiv_layers=1)
TINY_DIT = dict(hidden_size=32, depth=1, conv_pos=4, conv_pos_groups=2)
TINY_VOCODER = dict(upsample_initial_channel=128, resblock_kernel_sizes=[3],
                    resblock_dilation_sizes=[[1, 3, 5]], dtype="float32")
TINY_TRAFFIC = dict(batch=2, distinct_batches=2, steps=2, ref_frames=40,
                    pool=["Please call Stella and ask her.", "The quick brown fox jumps.",
                          "Good morning, doctor."])


def tiny_cell(workload: str, trace: bool = False, **traffic) -> Cell:
    """The cell ``workload`` of BENCHMARK.json at the tiny size, with
    limits for float32 against float32."""
    cell = load_cell(ROOT, workload, trace)
    config = copy.deepcopy(cell.config)
    config["tts"].update(TINY_TTS)
    config["dit"].update(TINY_DIT)
    config["vocoder"].update(TINY_VOCODER)
    config["precision"] = {k: "float32" for k in config["precision"]}
    return Cell(cell.name, cell.chips, config, {**cell.traffic, **TINY_TRAFFIC, **traffic},
                {"ids": 0, "frames": 0, "mel": 1e-4, "wav": 1e-4}, cell.metrics)


def workloads() -> list[str]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
