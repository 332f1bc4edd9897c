"""Seeded weights, made on the device in two draws.

The names, shapes and dtypes come from the plain reference's module
(`benchmark.reference`), built on the meta device. Every floating entry
is drawn by the first rule of the configuration's ``init`` list whose
pattern matches its name (``re.search``):

  ["pattern", "fan_in", gain]        normal, std gain / sqrt(3 · fan_in)
                                      (PyTorch's default spread; a bias
                                      takes its weight's fan-in)
  ["pattern", "normal", mean, std]
  ["pattern", "uniform", low, high]
  ["pattern", "constant", value]

and an entry no rule matches by ``["", "fan_in", 1.0]``. Normal entries
are slices of one ``torch.randn`` and uniform ones of one ``torch.rand``,
both from one ``torch.Generator`` on the device; integer entries are 0.
`state_dicts` makes one state dict per part that the configuration names
under ``parts``, in the layout of the part's reference module
(``benchmark/reference/<name>.py``), from the rules ``init[<part>]``.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from benchmark.registry import named


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for ``tags`` under the run's ``seed``."""
    state = np.random.SeedSequence([seed, *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _fan_in(name: str, shapes: dict) -> int:
    shape = shapes[name]
    if len(shape) < 2:
        prefix, _, last = name.rpartition(".")
        shape = shapes.get(f"{prefix}.{last.replace('bias', 'weight', 1)}", shape)
    return max(1, math.prod(shape[1:]))


def make_state_dict(module_fn, rules: list, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict of ``module_fn()`` (a reference module) with every
    entry drawn from ``seed`` by ``rules``."""
    with torch.device("meta"):
        layout = {k: (tuple(v.shape), v.dtype) for k, v in module_fn().state_dict().items()}
    shapes = {k: s for k, (s, _) in layout.items()}
    plan, n_normal, n_uniform = {}, 0, 0
    for name, (shape, dtype) in layout.items():
        if not dtype.is_floating_point:
            plan[name] = ("zeros",)
            continue
        rule = next((r for r in rules if re.search(r[0], name)), ["", "fan_in", 1.0])
        kind, n = rule[1], math.prod(shape)
        if kind == "fan_in":
            plan[name] = ("normal", n_normal, 0.0, rule[2] / math.sqrt(3 * _fan_in(name, shapes)))
            n_normal += n
        elif kind == "normal":
            plan[name] = ("normal", n_normal, rule[2], rule[3])
            n_normal += n
        elif kind == "uniform":
            plan[name] = ("uniform", n_uniform, rule[2], rule[3] - rule[2])
            n_uniform += n
        elif kind == "constant":
            plan[name] = ("constant", rule[2])
        else:
            raise ValueError(f"unknown init kind {kind!r} in rule {rule}")
    g = torch.Generator(device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    out = {}
    for name, (shape, dtype) in layout.items():
        p, n = plan[name], math.prod(shape)
        if p[0] == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif p[0] == "constant":
            out[name] = torch.full(shape, p[1], dtype=dtype, device=device)
        else:
            draws = normal if p[0] == "normal" else uniform
            out[name] = (draws[p[1]: p[1] + n] * p[3] + p[2]).reshape(shape).to(dtype)
    return out


def state_dicts(config: dict, seed: int, device) -> dict:
    """{part: its seeded state dict}, in the reference's names (the
    program uses the same names); the ``i``-th part draws from the seed
    ``derive_seed(seed, i + 1)``."""
    out = {}
    for i, (part, names) in enumerate(config["parts"].items()):
        build = named("reference", names["reference"]).build
        out[part] = make_state_dict(lambda: build(config), config["init"].get(part, []),
                                    derive_seed(seed, i + 1), device)
    return out
