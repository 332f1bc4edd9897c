"""The yardstick's arithmetic against hand-worked numbers: the roofline
bounds, the metric readers, the FLOP count and the trace reduction."""

import os

import pytest
import torch
import torch.utils.flop_counter

from benchmark import roofline
from benchmark.run import ROOT, Run, load_module
from benchmark.trace import Trace

# BigVGAN's snake inputs (B, T, C) at a 16 × 768-frame call and the
# launches per call at each: 3 AMP blocks × 6 snakes, + activation_post
SNAKE_STAGES = [((16, 3072, 768), 18), ((16, 12288, 384), 18), ((16, 24576, 192), 18),
                ((16, 49152, 96), 18), ((16, 98304, 48), 18), ((16, 196608, 24), 19)]


def metric(name):
    return load_module(os.path.join(ROOT, "benchmark", "metrics", name + ".py"))


def test_attention_bound_at_the_dex_shape():
    # 4·16·2·3840²·128 = 241,591,910,400 operations at 989 TFLOP/s
    assert roofline.attention_bound_ms(16, 3840, 2, 128, "bfloat16") == pytest.approx(
        241_591_910_400 / 989e12 * 1e3)
    assert round(roofline.attention_bound_ms(16, 3840, 2, 128, "bfloat16"), 4) == 0.2443
    # bytes bound it where T is short: 4 tensors of 16·8·2·128 bf16
    assert roofline.attention_bound_ms(16, 8, 2, 128, "bfloat16") == pytest.approx(
        4 * 16 * 8 * 2 * 128 * 2 / 3.35e12 * 1e3)


def test_snake_bound_summed_over_one_bigvgan_call():
    total = sum(n * roofline.snake_bound_ms(*shape, "bfloat16") for shape, n in SNAKE_STAGES)
    assert sum(n for _, n in SNAKE_STAGES) == 109
    assert round(total, 3) == 10.592


def test_roofline_float32_takes_the_faster_rate():
    ops = 1e12
    assert roofline.roofline_ms(0, ops, "float32") == pytest.approx(
        min(3 * ops / 495e12, ops / 67e12) * 1e3)


def _events():
    """A hand-made trace: a 10 ms call, two launches inside an
    "attention" span (kernels of 2 and 3 ms), one outside (1 ms)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": 0, "dur": 10_000,
           "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "bench.attention", "ts": 100, "dur": 200,
           "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 400, "dur": 50, "tid": 1}]
    for corr, ts in ((1, 150), (2, 250), (3, 420)):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                   "dur": 5, "tid": 1, "args": {"correlation": corr}})
    for corr, ts, dur in ((1, 1_000, 2_000), (2, 3_000, 3_000), (3, 7_000, 1_000)):
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
                   "args": {"correlation": corr}})
    return ev


def test_trace_reduction():
    t = Trace(_events())
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.006)
    assert t.span_device_s("attention") == pytest.approx(0.005)
    assert t.device_ops()[0] == ["k2", pytest.approx(0.003)]
    gaps = dict(t.idle_gaps())
    assert gaps["attention: no op"] == pytest.approx(0.001)  # before k1, launched in the span
    assert gaps["host: aten::mm"] == pytest.approx(0.001)  # before k3
    assert gaps["host: after the last device operation"] == pytest.approx(0.002)


def _run(**kw):
    base = dict(setup_s=12.5, window_s=30.0, calls=[{"wall_s": 15.0, "audio_s": 750.0}] * 2,
                kernel_calls={}, trace=None, flops_per_call=None)
    return Run(**{**base, **kw})


def test_readers():
    assert metric("rtf").read(_run()) == pytest.approx(0.02)
    assert metric("setup_s").read(_run()) == 12.5
    calls = [{"wall_s": 2.0, "prep_s": 0.002, "text_to_mel_s": 1.5},
             {"wall_s": 3.0, "prep_s": 0.004, "text_to_mel_s": 2.5}]
    assert metric("prep_ms.synth").read(_run(calls=calls)) == pytest.approx(3.0)
    assert metric("text_to_mel_ms.synth").read(_run(calls=calls)) == pytest.approx(2000.0)
    assert metric("vocoder_ms.synth").read(_run(calls=calls)) is None
    # 129.464 TFLOP over 2.5 s at 989.4 TFLOP/s
    mfu = metric("mfu.synth").read(_run(calls=calls, flops_per_call=129.464e12))
    assert mfu == pytest.approx(100 * 129.464e12 / 2.5 / 989.4e12)
    t = Trace(_events())
    assert metric("device_idle.synth").read(_run(trace=t)) == pytest.approx(40.0)
    kc = {"attention": [{"args": [((16, 3840, 3, 2, 128), "bfloat16")], "kwargs": {}}]}
    share = metric("attention_roofline.synth").read(_run(trace=t, kernel_calls=kc))
    assert share == pytest.approx(100 * roofline.attention_bound_ms(16, 3840, 2, 128,
                                                                    "bfloat16") / 5.0)
    # no snake call seen: the reader is silent, it never reports 0
    assert metric("snake_roofline.synth").read(_run(trace=t, kernel_calls={"snake": []})) is None


def test_flop_count_of_a_product_and_a_convolution():
    linear, conv = torch.nn.Linear(64, 32), torch.nn.Conv1d(8, 16, 3, padding=1)
    with torch.utils.flop_counter.FlopCounterMode(display=False) as counter:
        linear(torch.zeros(4, 64))
        conv(torch.zeros(2, 8, 10))
    assert counter.get_total_flops() == 2 * 4 * 64 * 32 + 2 * 2 * 16 * 10 * 8 * 3
