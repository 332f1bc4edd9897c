"""The 44.1 kHz configuration (DeX-TTS at 128 bands + BigVGAN-v2 44 kHz
128-band 512x): its full-width seeded weights load strictly into the
program and the plain reference, and the program's ``vocoder.stage``
spans tile its ``tts.vocoder`` span on the tiny cell."""

import json
import math
import os

import pytest
import torch

from benchmark import program
from benchmark.registry import named
from benchmark.run import ROOT, run_cell
from benchmark.tests.tiny import tiny_cell
from benchmark.weights import state_dicts
from dex_tts_tpu_torch.utils import profiling

NAME = "dex_vctk_bigvgan_v2_44k"
CELL = NAME + ".batch16_dpmpp2m16"


def test_full_width_weights_load_strictly():
    with open(os.path.join(ROOT, "benchmark", "configs", NAME + ".json")) as f:
        config = json.load(f)
    weights = state_dicts(config, 3, "cpu")
    parts = program.build_parts(config, weights)
    for part, names in config["parts"].items():
        named("reference", names["reference"]).build(config).load_state_dict(weights[part],
                                                                             strict=True)
        for name_, value in parts[part].state_dict().items():
            assert torch.equal(value, weights[part][name_]), (part, name_)
    voc = weights["vocoder"]
    assert "conv_post.bias" not in voc and parts["vocoder"].conv_post.bias is None
    assert parts["tts"].cfg.n_feats == 128 and voc["conv_pre.weight"].shape == (1536, 128, 7)
    # the head's weight at 100 times the default spread, N(0, 1/(3 · 24 · 7))
    std = float(voc["conv_post.weight"].std())
    assert std == pytest.approx(100 / math.sqrt(3 * 24 * 7), rel=0.1)


def test_stage_spans_tile_the_vocoder_span():
    run_cell(tiny_cell(CELL, trace=True), seed=2**33 + 9, seconds=0.0, trace=True,
             device="cpu")
    calls = [c for c in profiling.calls() if c.spans[0].name == "tts"][-2:]
    assert calls
    for call in calls:
        vocoder = next(s for s in call.spans if s.name == "tts.vocoder")
        stages = [s for s in call.spans if s.name == "vocoder.stage"]
        assert [s.attrs["stage"] for s in stages] == list(range(6))
        assert all(s.parent == vocoder.id for s in stages)
        assert [s.attrs["rate"] for s in stages] == [8, 4, 2, 2, 2, 2]
        assert [s.attrs["channels"] for s in stages] == [64, 32, 16, 8, 4, 2]  # tiny: 128 wide
        frames = call.root.attrs["frame_bucket"]
        assert [s.attrs["samples"] for s in stages] == [frames * r for r in
                                                        (8, 32, 64, 128, 256, 512)]
        assert sum(s.device_s for s in stages) == pytest.approx(vocoder.device_s, rel=0.01)
