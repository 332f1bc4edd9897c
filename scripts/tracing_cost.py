"""What the program's own tracing (`dex_tts_tpu_torch.utils.profiling`)
costs on the card, and how closely its spans sit on the profiler's clock.

    python3 scripts/tracing_cost.py cost --workload <cell> [--pairs 3] [--seconds 50] [--seed N]
    python3 scripts/tracing_cost.py clock [bench.py's flags]

``cost``: builds the benchmark cell as `benchmark.run` does (weights from
the seed, the program's parts, the traffic's loop and its warm-up), then runs
windows of ``--seconds`` back to back with tracing off and on in turns
(off, on, on, off, off, on, ...) and prints, per window, the mean wall
time per call; the last line is JSON: per pair the two means and on / off
- 1, the median of those ratios, and for each traced window its slowest
call against its median one, layer by layer (host and device ms of each
span name), which places a stalled call.

``clock``: runs `dex_tts_tpu_torch.bench` with ``--profile`` in this
process, then holds every span that the profiled call recorded against
the Chrome trace's ``user_annotation`` of the same name (both in opening
order): the last line is JSON with the number of spans and the largest
distance between a span's start mapped onto the wall clock (`Call.clock`)
and the event's ``baseTimeNanoseconds`` + ``ts``, in microseconds.
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def cost(workload: str, pairs: int, seconds: float, seed: int) -> dict:
    import torch

    from benchmark import program
    from benchmark.registry import named
    from benchmark.run import load_cell
    from benchmark.weights import state_dicts
    from dex_tts_tpu_torch.utils import profiling

    cell = load_cell(ROOT, workload, trace=False)
    device = torch.device("cuda")
    parts = program.build_parts(cell.config, state_dicts(cell.config, seed, device))
    driver = named("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, parts, seed, device, ROOT, False)
    del parts
    driver.warm_up()
    torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    order = [on for k in range(pairs) for on in ((False, True) if k % 2 == 0 else (True, False))]
    means = {False: [], True: []}
    slowest = []
    for on in order:
        driver.rec.calls.clear()
        profiling.set_tracing(on)
        window_s, calls = driver.window(seconds)
        profiling.set_tracing(False)
        mean = sum(c["wall_s"] for c in calls) / len(calls)
        means[on].append(mean)
        print(f"tracing {'on ' if on else 'off'}: {len(calls)} calls in {window_s:.3f} s, "
              f"mean wall per call {mean:.6f} s", file=sys.stderr, flush=True)
        if on:
            slowest.append(_slowest(profiling.calls()[-len(calls):]))
    ratios = [b / a - 1 for a, b in zip(means[False], means[True])]
    return {"workload": workload, "seconds": seconds, "seed": seed,
            "pairs": [{"off_s": a, "on_s": b, "on_over_off": r}
                      for a, b, r in zip(means[False], means[True], ratios)],
            "median_on_over_off": statistics.median(ratios), "slowest_traced_calls": slowest}


def _slowest(calls) -> dict:
    """The slowest and the median call of a traced window, each as span
    name → [host ms, device ms] summed over the call."""
    def layers(call):
        out = {}
        for s in call.spans:
            host, device = out.get(s.name, [0.0, 0.0])
            out[s.name] = [host + s.host_s * 1e3, device + (s.device_s or 0.0) * 1e3]
        return out

    by_wall = sorted(calls, key=lambda c: c.root.host_s)
    return {"slowest": layers(by_wall[-1]), "median": layers(by_wall[len(by_wall) // 2]),
            "slowest_index": calls.index(by_wall[-1])}


def clock(bench_argv: list[str]) -> dict:
    from dex_tts_tpu_torch import bench
    from dex_tts_tpu_torch.utils import profiling

    directory = tempfile.mkdtemp()
    seen = len(profiling.calls())
    bench.main(bench_argv + ["--profile", directory])
    calls = profiling.calls()[seen:]
    (path,) = glob.glob(os.path.join(directory, "*.json"))
    with open(path) as f:
        chrome = json.load(f)
    base = chrome["baseTimeNanoseconds"]
    spans = [(call, s) for call in calls for s in call.spans]
    names = {s.name for _, s in spans}
    events = sorted((e for e in chrome["traceEvents"]
                     if e.get("cat") == "user_annotation" and e["name"] in names),
                    key=lambda e: (e["ts"], -e["dur"]))
    if [e["name"] for e in events] != [s.name for _, s in spans]:
        raise RuntimeError("the trace's annotations do not match the recorded spans")
    deviations = [(call.wall_ns(s.t0) - (base + e["ts"] * 1e3)) / 1e3
                  for (call, s), e in zip(spans, events)]
    return {"spans": len(spans), "calls": len(calls),
            "largest_deviation_us": max(map(abs, deviations)),
            "deviation_us_by_span": [[s.name, d] for (_, s), d in zip(spans, deviations)]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("cost")
    c.add_argument("--workload", required=True)
    c.add_argument("--pairs", type=int, default=3)
    c.add_argument("--seconds", type=float, default=50.0)
    c.add_argument("--seed", type=int, default=2**32 + 21)
    sub.add_parser("clock")
    args, rest = p.parse_known_args(argv)
    if args.mode == "cost":
        if rest:
            p.error(f"unrecognized arguments: {' '.join(rest)}")
        print(json.dumps(cost(args.workload, args.pairs, args.seconds, args.seed)))
    else:
        print(json.dumps(clock(rest)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
