"""The per-layer metrics that read the program's own spans
(`benchmark.program_spans`, ``benchmark/metrics/*.span.py``): untraced
runs leave the program untraced, traced tiny cells give every reader a
value, a program without the tracer leaves them silent, and the idle
attribution against a hand-made trace."""

import json
import os
import subprocess
import sys
import types

import pytest

from benchmark import program_spans
from benchmark.run import ROOT, Run, load_module, run_cell
from benchmark.tests.tiny import tiny_cell, workloads
from benchmark.trace import Trace
from dex_tts_tpu_torch.utils.profiling import Call, Span

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPAN_METRICS = [m["name"] for m in json.load(f)["per_layer"]
                    if m["name"].endswith(".span")]
DEVICE_ONLY = {"sampler_idle_ms.span"}  # needs launches, which the CPU does not make


def metric(name):
    return load_module(os.path.join(ROOT, "benchmark", "metrics", name + ".py"))


def test_only_a_traced_cell_turns_the_program_tracing_on():
    code = ("from benchmark.run import ROOT, load_cell\n"
            "from benchmark.tests.tiny import workloads\n"
            "from dex_tts_tpu_torch.utils import profiling\n"
            "for w in workloads():\n"
            "    load_cell(ROOT, w, False)\n"
            "print(profiling.TRACING)\n"
            "load_cell(ROOT, workloads()[0], True)\n"
            "print(profiling.TRACING)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "True"]


@pytest.fixture(scope="module")
def tiny_results():
    return {w: run_cell(tiny_cell(w, trace=True), seed=2**33 + 7, seconds=0.0, trace=True,
                        device="cpu") for w in workloads()}


@pytest.mark.parametrize("workload", workloads())
def test_every_span_reader_reads_a_tiny_cell(tiny_results, workload):
    result = tiny_results[workload]
    assert result["correct"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SPAN_METRICS) - set(got) == DEVICE_ONLY
    parts = sum(got[f"{n}_ms.span"] for n in ("encode", "sampler", "unet", "dit"))
    assert parts == pytest.approx(got["text_to_mel_ms.span"], rel=0.01)
    for name in ("text_to_mel", "vocoder"):  # the harness's own spans around the same calls
        assert got[f"{name}_ms.span"] == pytest.approx(got[f"{name}_ms.synth"], rel=0.02)
    assert got["weight_cast_mb.span"] == 0.0  # the tiny cells run in float32
    assert all(got[n] > 0 for n in SPAN_METRICS if n not in DEVICE_ONLY | {"weight_cast_mb.span"})


def _span(call, name, parent, t0_us, t1_us):
    """A program span at trace time ``t0_us``..``t1_us`` (µs), on a
    program clock 1 s ahead of the trace's."""
    s = Span(name, len(call.spans) + 1, parent, 1, {"frame_bucket": 64} if parent is None else {})
    s.t0, s.t1 = int((t0_us + 1e6) * 1e3), int((t1_us + 1e6) * 1e3)
    call.spans.append(s)
    return s.id


def _profiled(vocoder_at=8_000):
    """A 10 ms profiled call: two sampler steps (2-4 ms, 4-6 ms) and five
    kernels; the gaps ended by launches inside the steps are 1.0 ms
    (before the kernel at 2.5 ms) and 0.2 ms (before the one at 3.2 ms)."""
    call = Call()
    root = _span(call, "tts", None, 50, 9_900)
    _span(call, "tts.prep", root, 90, 300)
    for t0 in (2_000, 4_000):
        _span(call, "sampler.step", root, t0, t0 + 2_000)
    _span(call, "tts.vocoder", root, 7_950, 9_000)
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": 0, "dur": 10_000,
           "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "bench.prep", "ts": 100, "dur": 190,
           "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "bench.vocoder", "ts": vocoder_at,
           "dur": 900, "tid": 1}]
    kernels = [(1, 900, 1_000, 500), (2, 2_100, 2_500, 500), (3, 3_100, 3_200, 300),
               (4, 6_500, 7_000, 500), (5, 8_050, 8_100, 100)]
    for corr, launch, start, dur in kernels:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 5, "tid": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": start, "dur": dur,
                   "args": {"correlation": corr}})
    return call, Trace(ev)


def _run(trace, calls=()):
    return Run(setup_s=1.0, window_s=1.0, calls=list(calls), kernel_calls={}, trace=trace,
               flops_per_call=None)


def test_sampler_idle_counts_the_gaps_launched_inside_the_steps(monkeypatch):
    call, trace = _profiled()
    monkeypatch.setattr(program_spans, "_profiling", types.SimpleNamespace(calls=lambda: [call]))
    assert metric("sampler_idle_ms.span").read(_run(trace)) == pytest.approx(1.2)
    # the call's whole idle: 1.0 + 1.0 + 0.2 + 3.5 + 0.6 + 1.8 ms
    assert (trace.window_s - trace.busy_s) * 1e3 == pytest.approx(8.1)
    # the two clock offsets 0.6 ms apart: the spans cannot be placed
    call, trace = _profiled(vocoder_at=8_650)
    assert metric("sampler_idle_ms.span").read(_run(trace)) is None


def test_the_window_is_the_calls_before_the_profiled_one(monkeypatch):
    call, _ = _profiled()
    calls = [call] * 3
    monkeypatch.setattr(program_spans, "_profiling", types.SimpleNamespace(calls=lambda: calls))
    run = _run(None, [{"bucket": 64}, {"bucket": 64}])
    assert program_spans.window(run) == calls[:2]
    assert program_spans.mean_per_call(run, lambda c: 3.0) == 3.0
    assert program_spans.window(_run(None, [{"bucket": 128}] * 2)) is None
    assert program_spans.window(_run(None, [{"bucket": 64}] * 3)) is None


@pytest.mark.parametrize("module", [None, types.SimpleNamespace(trace=lambda d: None)],
                         ids=["no tracer module", "the tracer without spans"])
def test_without_the_programs_spans_every_reader_is_silent(monkeypatch, module):
    _, trace = _profiled()
    monkeypatch.setattr(program_spans, "_profiling", module)
    run = _run(trace, [{"bucket": 64, "wall_s": 1.0, "audio_s": 10.0}])
    for name in SPAN_METRICS:
        assert metric(name).read(run) is None, name
