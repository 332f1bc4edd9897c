"""The program's own spans and counters, and the profiler's trace.

  * `span(name, device=None, **attrs)`: a named span at a layer boundary.
    With tracing on it records its name, id, parent, call id (the id of
    its root span: every span of one `Synthesizer.tts` call shares it),
    host start and end (`time.perf_counter_ns`), attributes and counts,
    and, while a profiler runs, opens a `torch.profiler.record_function`
    range of the same name, which places it over the kernels on the
    device trace's clock. ``device`` (the torch.device the enclosed work runs
    on) adds the span's device time: on a CUDA device a pair of CUDA
    events on its current stream, turned into seconds only when the next
    root span opens or the record is read, so nothing synchronises; on
    any other device the host time. With tracing off, `span` returns one
    shared no-op context and records nothing.
  * `count(name, n)`: adds ``n`` to the innermost open span of the
    calling thread; `count_casts` counts parameter casts (``cast_bytes``).
    Hot call sites guard them with ``if profiling.TRACING:``.
  * `set_tracing(on)`, `tracing(on)`: the switch (off at import).
  * `calls()`: the last `MAX_CALLS` root spans' records (`Call`), oldest
    first, with their device times resolved.
  * `trace(dir)`: `torch.profiler` over the enclosed block, with tracing
    on, CPU activity and, where CUDA is available, the card's (kernels,
    copies); a Chrome trace (Perfetto, chrome://tracing) written into
    ``dir`` at the end.

Open spans are kept per thread. Each root's record holds a
(`perf_counter_ns`, `time_ns`) pair taken together (`Call.clock`), which
maps its spans onto the wall clock that the Chrome trace's
``baseTimeNanoseconds`` + ``ts`` follow.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACING = False
MAX_CALLS = 1024

_NOOP = contextlib.nullcontext()
_local = threading.local()
_ids = itertools.count(1)
_lock = threading.Lock()
_calls: collections.deque = collections.deque(maxlen=MAX_CALLS)
_pending: list = []  # closed calls whose device spans still hold CUDA events
_events: list = []  # free CUDA events


class Span:
    """One span's record. ``t0``, ``t1``: host nanoseconds
    (`time.perf_counter_ns`); ``device_s``: device seconds, None for a
    host-only span; ``counts``: what `count` added while it was the
    innermost open span."""

    __slots__ = ("name", "id", "parent", "call", "t0", "t1", "attrs", "counts", "device_s",
                 "_marks")

    def __init__(self, name, id, parent, call, attrs):
        self.name, self.id, self.parent, self.call, self.attrs = name, id, parent, call, attrs
        self.t0 = self.t1 = 0
        self.counts: dict = {}
        self.device_s = None
        self._marks = None

    @property
    def host_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"host_s={self.host_s:.6f}, device_s={self.device_s}, counts={self.counts})")


class Call:
    """A root span and every span under it, in the order they opened
    (``spans[0]`` is the root). ``clock``: (`time.perf_counter_ns`,
    `time.time_ns`) read together when the root opened."""

    __slots__ = ("spans", "clock", "_last")

    def __init__(self):
        self.spans: list[Span] = []
        self.clock = (time.perf_counter_ns(), time.time_ns())
        self._last = None  # the CUDA event recorded last

    @property
    def root(self) -> Span:
        return self.spans[0]

    def wall_ns(self, perf_ns: int) -> int:
        """A `perf_counter_ns` reading of this call on the `time_ns` clock."""
        return self.clock[1] + perf_ns - self.clock[0]


def _event() -> torch.cuda.Event:
    try:
        return _events.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _resolve(wait: bool) -> None:
    """Device seconds of the closed calls' CUDA-timed spans; without
    ``wait`` a call whose last event has not completed stays pending."""
    with _lock:
        keep = []
        for call in _pending:
            if not wait and not call._last.query():
                keep.append(call)
                continue
            call._last.synchronize()
            call._last = None
            for s in call.spans:
                if s._marks is not None:
                    start, end = s._marks
                    s.device_s = start.elapsed_time(end) / 1e3
                    s._marks = None
                    _events.extend((start, end))
        _pending[:] = keep


class _Open:
    __slots__ = ("name", "device", "attrs", "rec", "rf", "stream")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self) -> Span:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            call = _local.call
            rec = Span(self.name, next(_ids), stack[-1].id, stack[0].id, self.attrs)
        else:
            if _pending:
                _resolve(wait=False)
            call = _local.call = Call()
            sid = next(_ids)
            rec = Span(self.name, sid, None, sid, self.attrs)
        call.spans.append(rec)
        stack.append(rec)
        self.rec = rec
        # the host clock brackets the profiler's range, whose first opening
        # in a profile can take a millisecond after its own start stamp
        rec.t0 = time.perf_counter_ns()
        self.rf = record_function(self.name) if torch.autograd._profiler_enabled() else None
        if self.rf is not None:
            self.rf.__enter__()
        cuda = self.device is not None and self.device.type == "cuda"
        self.stream = torch.cuda.current_stream(self.device) if cuda else None
        if cuda:
            start = _event()
            start.record(self.stream)
            rec._marks = (start, None)
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        if self.stream is not None:
            end = _event()
            end.record(self.stream)
            rec._marks = (rec._marks[0], end)
            _local.call._last = end
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec.t1 = time.perf_counter_ns()
        if self.device is not None and self.stream is None:
            rec.device_s = rec.host_s
        stack = _local.stack
        stack.pop()
        if not stack:
            call = _local.call
            _local.call = None
            with _lock:
                _calls.append(call)
                if call._last is not None:
                    _pending.append(call)
        return False


def span(name: str, device: torch.device | None = None, **attrs):
    """A span named ``name`` over the enclosed block (module docstring);
    the ``with`` yields its `Span` record, or None with tracing off."""
    if not TRACING:
        return _NOOP
    return _Open(name, device, attrs)


def note(**attrs) -> None:
    """Set attributes on the innermost open span of this thread."""
    stack = getattr(_local, "stack", None) if TRACING else None
    if stack:
        stack[-1].attrs.update(attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to the count ``name`` of the innermost open span of this
    thread (nothing outside a span)."""
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def count_casts(dtype: torch.dtype, *tensors) -> None:
    """Count under ``cast_bytes`` the bytes that casting ``tensors``
    (parameters or buffers; None skipped) to ``dtype`` makes, those
    already in ``dtype`` left out."""
    n = sum(t.numel() for t in tensors if t is not None and t.dtype != dtype)
    if n:
        count("cast_bytes", n * dtype.itemsize)


def set_tracing(on: bool) -> None:
    global TRACING
    TRACING = bool(on)


@contextlib.contextmanager
def tracing(on: bool = True):
    """Tracing ``on`` (or off) inside the block, as it was after it."""
    before = TRACING
    set_tracing(on)
    try:
        yield
    finally:
        set_tracing(before)


def calls() -> list[Call]:
    """The recorded root calls, oldest first, device times resolved."""
    _resolve(wait=True)
    with _lock:
        return list(_calls)


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with `torch.profiler`, tracing on; the
    Chrome trace goes to ``<log_dir>/trace_<pid>_<ns>.json``. Yields the
    profiler, whose ``trace_path`` is set once the block has ended."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tracing(), profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
