"""Experiment metric logging (port of dex_tts_tpu/utils/logging.py).

The counterpart of the reference's plaintext log.txt and its optional
Neptune hook (reference: DEX-TTS/src/utils.py:48-55, src/train.py:101-103):
a JSON-lines metrics file that any dashboard can tail, and optionally an
external backend (neptune or wandb), imported only when it is asked for.
"""

from __future__ import annotations

import json
import os
import time

BACKENDS = ("neptune", "wandb")


class MetricsLogger:
    """Appends one JSON object per `log` call to ``<exp_dir>/metrics.jsonl``.
    ``backend`` ("neptune" or "wandb") also sends each metric there; its
    package is imported here, and a missing one raises."""

    def __init__(self, exp_dir: str, backend: str | None = None, **backend_kwargs):
        if backend is not None and backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.path = os.path.join(exp_dir, "metrics.jsonl")
        os.makedirs(exp_dir, exist_ok=True)
        self._run = None
        if backend == "neptune":
            import neptune

            self._run = neptune.init_run(**backend_kwargs)
        elif backend == "wandb":
            import wandb

            self._run = wandb.init(**backend_kwargs)
        self._backend = backend

    def log(self, step: int, metrics: dict, prefix: str = "") -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            record[f"{prefix}{k}"] = float(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._run is None:
            return
        values = {k: v for k, v in record.items() if k not in ("step", "time")}
        if self._backend == "neptune":
            for k, v in values.items():
                self._run[k].append(v, step=step)
        else:
            self._run.log(values, step=step)

    def close(self) -> None:
        if self._run is None:
            return
        if self._backend == "neptune":
            self._run.stop()
        else:
            self._run.finish()
        self._run = None
