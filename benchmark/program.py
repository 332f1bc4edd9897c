"""The system under test, part by part: each part that a configuration
names under ``parts`` is built by its program module
(``benchmark/programs/<name>.py``, ``build(config)``) without storage,
and the benchmark's seeded state dict becomes its parameters and
buffers (loaded strictly), so the modules' own init never runs. A
traffic mix's driver puts the parts together behind the program's
entry."""

from __future__ import annotations

import torch

from benchmark.registry import named


def tuples(v):
    return tuple(tuples(x) for x in v) if isinstance(v, list) else v


def build_parts(config: dict, weights: dict) -> dict:
    """{part: the program's module holding ``weights[part]``, on their device}"""
    parts = {}
    for part, names in config["parts"].items():
        with torch.device("meta"):
            module = named("programs", names["program"]).build(config)
        module.load_state_dict(weights[part], strict=True, assign=True)
        parts[part] = module
    return parts
