"""Reduction of one profiled call's `torch.profiler` trace.

The Chrome trace gives host events (``cpu_op``, ``user_annotation`` for
the harness's ``bench.*`` spans, ``cuda_runtime`` / ``cuda_driver`` for
launches) and device events (``kernel``, ``gpu_memcpy``, ``gpu_memset``);
a launch and the device work it started share a ``correlation`` id.
From them: the device's busy seconds in the call's window (the union of
its device intervals), the window's length, device seconds by operation
name, idle gaps by what the host was launching when each gap ended, and
the device seconds of the work launched inside each ``bench.*`` span.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CALL_SPAN = "bench.call"


class Trace:
    def __init__(self, events: list[dict]):
        spans = defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation" and e["name"].startswith("bench."):
                spans[e["name"][6:]].append((e["ts"], e["ts"] + e["dur"], e["tid"]))
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self.span_starts = {k: [s for s, _, _ in v] for k, v in self.spans.items()}
        call = self.spans.get("call", [(0.0, 0.0, None)])[0]
        self.t0, self.t1 = call[0], call[1]
        self.device = sorted(
            ((e["ts"], e["ts"] + e["dur"], e["name"], e.get("args", {}).get("correlation"))
             for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"),
            key=lambda d: (d[0], d[1]))
        self.launches = {e["args"]["correlation"]: (e["ts"], e["tid"]) for e in events
                         if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.ops = sorted(((e["ts"], e["ts"] + e["dur"], e["tid"], e["name"]) for e in events
                           if e.get("cat") == "cpu_op"), key=lambda o: (o[0], o[1]))
        self.op_starts = [o[0] for o in self.ops]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _intervals(self):
        """Merged device intervals, clipped to the window (µs)."""
        merged = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._intervals()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        by_name = defaultdict(float)
        for s, e, name, _ in self.device:
            by_name[name] += (e - s) / 1e6
        return sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:top]

    def _host_label(self, ts: float, tid) -> str:
        """The innermost ``bench.*`` span and the innermost ``cpu_op`` on
        thread ``tid`` that contain the host time ``ts``."""
        layer, latest = "host", -float("inf")
        for name, intervals in self.spans.items():
            i = bisect.bisect_right(self.span_starts[name], ts) - 1
            if name != "call" and i >= 0:
                s, e, t = intervals[i]
                if t == tid and ts <= e and s > latest:
                    layer, latest = name, s
        i = bisect.bisect_right(self.op_starts, ts)
        op = "no op"
        for s, e, t, name in reversed(self.ops[max(0, i - 64):i]):
            if t == tid and s <= ts <= e:
                op = name  # the latest-starting op that contains ts is the innermost
                break
        return f"{layer}: {op}"

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds summed by what the host was launching when the gap
        ended (the launch of the next device operation)."""
        starts = {}
        for s, _, _, corr in self.device:
            starts.setdefault(s, corr)
        gaps = defaultdict(float)
        edge = self.t0
        for s, e in self._intervals():
            if s > edge:
                launch = self.launches.get(starts.get(s))
                label = self._host_label(*launch) if launch else "host: no launch seen"
                gaps[label] += (s - edge) / 1e6
            edge = e
        if self.t1 > edge:
            gaps["host: after the last device operation"] += (self.t1 - edge) / 1e6
        return sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:top]

    def span_device_s(self, name: str) -> float:
        """Device seconds of the work launched inside the ``bench.<name>``
        spans (0 where none was seen)."""
        intervals, starts = self.spans.get(name, []), self.span_starts.get(name, [])
        total = 0.0
        for s, e, _, corr in self.device:
            launch = self.launches.get(corr)
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch[0]) - 1
            if i >= 0 and launch[0] <= intervals[i][1] and launch[1] == intervals[i][2]:
                total += (e - s) / 1e6
        return total


@contextlib.contextmanager
def profiled(directory: str | None = None):
    """Profile the enclosed block (host and device) inside a
    ``bench.call`` span; yields a list that holds the `Trace` afterwards.
    The Chrome trace passes through a temporary file, deleted at once."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    result = []
    with profile(activities=activities) as prof:
        with record_function(CALL_SPAN):
            yield result
    fd, path = tempfile.mkstemp(suffix=".json", dir=directory)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            result.append(Trace(json.load(f)["traceEvents"]))
    finally:
        os.unlink(path)
