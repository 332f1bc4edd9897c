"""The one traffic generator: turns a traffic file's parameters and the
run's seed into the batches a closed loop sends.

A traffic file (`benchmark/traffic/<name>.json`) names its ``driver``
(``benchmark/drivers/<driver>.py``, which sends the batches) and gives
``loop`` ("closed": the next call goes as soon as the last returns),
``callers`` (1), ``batch`` (sentences per call), ``pool`` (the sentences),
``distinct_batches`` (how many different batches the seed draws; the
calls cycle through them), ``solver`` and ``steps`` (the sampler),
``temperature``, ``max_frames`` (the frame cap passed to each call) and
``ref_frames`` (frames of the seeded style features, for a model that
takes them). Each batch is ``batch`` sentences drawn from the pool
without replacement; each call gets its own noise seed.
"""

from __future__ import annotations

import numpy as np

from benchmark.weights import derive_seed

BATCH_TAG, CALL_TAG = 3, 4


def batches(traffic: dict, seed: int, style: bool, n_mels: int) -> list[dict]:
    """[{"texts": [...], "ref_feats": [(mel (n_mels, T), lf0 (T,)), ...] or None}]"""
    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError("the generator drives one closed-loop caller")
    rng = np.random.default_rng(derive_seed(seed, BATCH_TAG))
    pool, t = traffic["pool"], traffic["ref_frames"]
    out = []
    for _ in range(traffic["distinct_batches"]):
        texts = [pool[i] for i in rng.choice(len(pool), traffic["batch"], replace=False)]
        feats = None
        if style:
            feats = [(rng.standard_normal((n_mels, t)).astype(np.float32),
                      rng.standard_normal(t).astype(np.float32)) for _ in texts]
        out.append({"texts": texts, "ref_feats": feats})
    return out


def call_seed(seed: int, call: int) -> int:
    """The noise seed of the ``call``-th call of a run."""
    return derive_seed(seed, CALL_TAG, call)
