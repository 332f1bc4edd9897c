"""The program's own spans and counters (`dex_tts_tpu_torch.utils.profiling`),
for the per-layer metrics named ``<layer>.span``.

Importing this module turns the program's tracing on. Only the per-layer
metric readers import it, and `benchmark.run.load_cell` loads them for a
traced run (``--trace 1``) alone, so the runs that give the end-to-end
metrics stay untraced. A program without the tracer (no ``set_tracing``,
no ``calls``) leaves it off and every reader silent (None).

The program records one root span ``tts`` per `Synthesizer.tts` call,
with the frame bucket it chose, and under it (host clock, or device time
by CUDA events, the host clock on the CPU): ``tts.prep``,
``tts.prepass``, ``tts.text_to_mel`` > ``text_to_mel.encode`` and one
``sampler.step`` per step > ``denoiser`` > ``dit``, ``tts.vocoder``,
``tts.readback``; the counter ``cast_bytes`` on the innermost open span.
"""

from __future__ import annotations

import bisect
import importlib

try:
    _profiling = importlib.import_module("dex_tts_tpu_torch.utils.profiling")
except ImportError:
    _profiling = None

if callable(getattr(_profiling, "set_tracing", None)):
    _profiling.set_tracing(True)

ROOT = "tts"
# the largest disagreement of the two offsets between the program's clock
# and the profiled call's trace (bench.prep ↔ tts.prep, bench.vocoder ↔
# tts.vocoder) that `trace_offset_us` accepts
OFFSET_TOLERANCE_US = 500.0


def _roots() -> list | None:
    calls = getattr(_profiling, "calls", None)
    if not callable(calls):
        return None
    return [c for c in calls() if c.spans and c.spans[0].name == ROOT]


def window(run) -> list | None:
    """The root records of the window's calls, oldest first: the last
    ``len(run.calls) + 1`` roots without the last (the profiled call),
    each at the frame bucket the harness saw for its call; None where the
    program recorded none or they do not match."""
    roots, n = _roots(), len(run.calls)
    if not roots or not n or len(roots) < n + 1:
        return None
    calls = roots[-n - 1:-1]
    for call, seen in zip(calls, run.calls):
        if call.spans[0].attrs.get("frame_bucket") != seen.get("bucket"):
            return None
    return calls


def profiled(run):
    """The root record of the profiled call (the last), or None."""
    roots = _roots()
    return roots[-1] if roots and run.trace is not None else None


def total_ms(call, name: str, device: bool) -> float | None:
    """Milliseconds in the spans ``name`` of one call, device or host
    time; None where the call has no such span."""
    spans = [s for s in call.spans if s.name == name]
    if not spans or (device and any(s.device_s is None for s in spans)):
        return None
    return 1e3 * sum(s.device_s if device else s.host_s for s in spans)


def self_ms(call, name: str) -> float | None:
    """Device milliseconds of the spans ``name`` of one call, less those
    of their direct children (a layer's self time)."""
    ids = {s.id for s in call.spans if s.name == name}
    total = total_ms(call, name, device=True)
    if total is None:
        return None
    children = [s for s in call.spans if s.parent in ids]
    if any(s.device_s is None for s in children):
        return None
    return total - 1e3 * sum(s.device_s for s in children)


def counted(call, name: str) -> int:
    """The counter ``name`` summed over every span of one call."""
    return sum(s.counts.get(name, 0) for s in call.spans)


def mean_per_call(run, value) -> float | None:
    """The mean of ``value(call)`` over the window's calls; None where
    there is no window or a call gives None."""
    calls = window(run)
    if not calls:
        return None
    values = [value(c) for c in calls]
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)


def trace_offset_us(run, call) -> float | None:
    """Microseconds to add to the program's clock (``perf_counter_ns`` /
    1e3) to reach the profiled call's trace: from ``bench.prep`` against
    ``tts.prep``, held against ``bench.vocoder`` against ``tts.vocoder``;
    None where either pair is missing or they disagree by more than
    `OFFSET_TOLERANCE_US`."""
    offsets = []
    for bench, program in (("prep", "tts.prep"), ("vocoder", "tts.vocoder")):
        marks = run.trace.spans.get(bench)
        span = next((s for s in call.spans if s.name == program), None)
        if not marks or span is None:
            return None
        offsets.append(marks[0][0] - span.t0 / 1e3)
    if abs(offsets[0] - offsets[1]) > OFFSET_TOLERANCE_US:
        return None
    return offsets[0]


def idle_launched_in_ms(run, call, name: str) -> float | None:
    """Device idle milliseconds in the profiled call whose ending launch
    the host made inside a span ``name``: the gaps between the trace's
    merged device intervals, each labelled by the host time of the launch
    of the operation that ended it. None without device operations or a
    clock offset."""
    trace = run.trace
    intervals = trace._intervals()
    offset = trace_offset_us(run, call) if intervals else None
    if offset is None:
        return None
    spans = sorted((s.t0 / 1e3 + offset, s.t1 / 1e3 + offset)
                   for s in call.spans if s.name == name)
    starts = [s for s, _ in spans]
    first = {}
    for s, _, _, corr in trace.device:
        first.setdefault(s, corr)
    idle, edge = 0.0, trace.t0
    for s, e in intervals:
        if s > edge:
            launch = trace.launches.get(first.get(s))
            if launch is not None:
                i = bisect.bisect_right(starts, launch[0]) - 1
                if i >= 0 and launch[0] <= spans[i][1]:
                    idle += s - edge
        edge = e
    return idle / 1e3
