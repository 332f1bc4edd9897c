"""Cooperative preemption handling for training loops (a copy of
dex_tts_tpu/train/preemption.py).

Maintenance events and spot reclamation deliver SIGTERM with a grace
window. `PreemptionGuard` turns SIGTERM/SIGINT into a flag that the epoch
loop polls between steps; `Trainer.fit` and `train_vocoder` then save
`last` (and a `preempt` tag) and return, so a resume continues from the
interrupted step's checkpoint.
"""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Install handlers for ``signals``; ``triggered`` flips on delivery.

    The handlers replace the previous ones (the point is to supersede the
    default kill); `restore` reinstates them. Only usable from the main
    thread (CPython's signal rule): construct it in the entry point, not
    in workers."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.triggered = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handle)

    def _handle(self, signum, frame):
        self.triggered = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}
