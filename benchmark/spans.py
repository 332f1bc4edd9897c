"""What the harness records around the program's calls, from outside: the
program's files are not touched.

`Recorder` wraps one Synthesizer's methods (instance attributes):
``prepare_batch`` (the token ids each call sends to the device, for the
correctness comparison) and ``frame_bucket`` (the bucket the pre-pass
chose) in every run; with ``layer_spans`` (the traced run) also a host
clock around those two, device time by CUDA events around the model's
``synthesize`` and the vocoder's ``forward``, and a profiler span around
each of the four.

`kernel_spans` wraps module-level functions of the program, named by the
per-layer metric files (``SPANS``), for a profiled call: each call gets a
profiler span ``bench.<name>``, the shapes and dtypes of its tensor
arguments and its other keyword arguments.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import torch
from torch.profiler import record_function

class _DeviceTimer:
    """Device time between two points of the stream (CUDA events), or the
    host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, start):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return (start, ev)
        return time.perf_counter() - start

    def seconds(self, mark) -> float:
        return mark[0].elapsed_time(mark[1]) / 1e3 if self.cuda else mark


class Recorder:
    def __init__(self, synth, layer_spans: bool):
        self.layer_spans = layer_spans
        self.timer = _DeviceTimer(synth.device)
        self.calls: list[dict] = []
        self._open: dict = {}  # the call being recorded; a scratch dict outside calls
        self._wrap(synth, "prepare_batch", self._host("prep", self._keep_inputs))
        self._wrap(synth, "frame_bucket", self._host("prepass", self._keep_bucket))
        if layer_spans:
            self._wrap(synth.model, "synthesize", self._device("text_to_mel"))
            self._wrap(synth.vocoder, "forward", self._device("vocoder"))

    @staticmethod
    def _wrap(obj, name, make):
        setattr(obj, name, make(getattr(obj, name)))

    def begin_call(self) -> None:
        self._open = {"marks": {}}
        self.calls.append(self._open)

    def end_call(self) -> dict:
        """Close the current call (after its results reached the host)."""
        call, self._open = self._open, {}
        for layer, marks in call.pop("marks").items():
            call[layer + "_s"] = sum(self.timer.seconds(m) for m in marks)
        return call

    def _keep_inputs(self, out):
        inputs, b = out
        self._open.update(x=inputs["x"][:b], x_lengths=inputs["x_lengths"][:b])

    def _keep_bucket(self, out):
        self._open["bucket"] = out

    def _host(self, layer, keep):
        def make(fn):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                if not self.layer_spans:
                    out = fn(*args, **kwargs)
                    keep(out)
                    return out
                with record_function(f"bench.{layer}"):
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    self._open[layer + "_s"] = time.perf_counter() - t0
                keep(out)
                return out
            return wrapped
        return make

    def _device(self, layer):
        def make(fn):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                with record_function(f"bench.{layer}"):
                    start = self.timer.start()
                    out = fn(*args, **kwargs)
                    mark = self.timer.stop(start)
                self._open.setdefault("marks", {}).setdefault(layer, []).append(mark)
                return out
            return wrapped
        return make


@contextlib.contextmanager
def kernel_spans(targets: dict):
    """``targets``: span name → (module path, function name). Yields
    span name → per call {"args": [(shape, dtype) of each positional
    tensor], "kwargs": the keyword arguments that are not tensors}."""
    seen = {name: [] for name in targets}
    saved = []
    try:
        for name, (module, attr) in targets.items():
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                seen[_name].append({
                    "args": [(tuple(a.shape), str(a.dtype).removeprefix("torch."))
                             for a in args if isinstance(a, torch.Tensor)],
                    "kwargs": {k: v for k, v in kwargs.items()
                               if not isinstance(v, torch.Tensor)}})
                with record_function(f"bench.{_name}"):
                    return _fn(*args, **kwargs)

            setattr(mod, attr, wrapped)
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
