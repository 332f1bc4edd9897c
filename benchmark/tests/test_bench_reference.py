"""The plain reference against the program, both in float32 on the CPU at
a tiny size, through the harness's own run: the text front end, the
pre-pass and bucket, the encoders, euler and dpmpp2m over the U-Net and
DiT, and HiFi-GAN and BigVGAN; and the full-width configurations' seeded
weights loading strictly into both."""

import json
import os

import pytest
import torch

from benchmark import program
from benchmark.registry import named
from benchmark.run import ROOT, run_cell
from benchmark.weights import state_dicts
from benchmark.tests.tiny import tiny_cell, workloads


@pytest.mark.parametrize("solver,steps", [("euler", 3), ("dpmpp2m", 4)])
@pytest.mark.parametrize("workload", workloads())
def test_reference_agrees_with_program(workload, solver, steps):
    result = run_cell(tiny_cell(workload, solver=solver, steps=steps), seed=2**31 + 5,
                      seconds=0.0, trace=False, device="cpu")
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert result["correct"], checks
    assert checks["ids"] == 0 and checks["frames"] == 0, checks
    assert checks["mel"] < 1e-4 and checks["wav"] < 1e-4, checks


@pytest.mark.parametrize("name", ["dex_vctk_hifigan", "gedex_ljspeech_bigvgan"])
def test_full_width_weights_load_strictly(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        config = json.load(f)
    weights = state_dicts(config, 3, "cpu")
    parts = program.build_parts(config, weights)
    for part, names in config["parts"].items():
        named("reference", names["reference"]).build(config).load_state_dict(weights[part],
                                                                             strict=True)
        for name_, value in parts[part].state_dict().items():
            assert torch.equal(value, weights[part][name_]), (part, name_)
    # the duration projection is pinned: 4 frames per token
    assert float(weights["tts"]["encoder.proj_w.proj.bias"][0]) == pytest.approx(1.2527629)
    assert not weights["tts"]["encoder.proj_w.proj.weight"].any()


def test_weights_repeat_by_seed_and_differ_across_seeds():
    with open(os.path.join(ROOT, "benchmark", "configs", "dex_vctk_hifigan.json")) as f:
        config = json.load(f)
    a, b = state_dicts(config, 7, "cpu"), state_dicts(config, 7, "cpu")
    c = state_dicts(config, 8, "cpu")
    key = "decoder.denoise_fn.vit.blocks.0.attn.qkv.weight"
    assert torch.equal(a["tts"][key], b["tts"][key])
    assert not torch.equal(a["tts"][key], c["tts"][key])
    # no published zero-init survives: the DiT's gates and final layer move
    for k in ("decoder.denoise_fn.vit.final_layer.linear.weight",
              "decoder.denoise_fn.vit.blocks.0.adaLN_modulation.1.weight",
              "decoder.denoise_fn.downs.0.2.fn.g"):
        assert a["tts"][k].abs().max() > 0, k
    # the vocoder's bias adds are part of what is compared
    assert a["vocoder"]["conv_pre.bias"].abs().max() > 0
