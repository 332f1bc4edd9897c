"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything a cell needs is found by name
(`benchmark.registry`): from ``BENCHMARK.json`` the configuration file,
the traffic file ``benchmark/traffic/<traffic>.json``, the limits
``benchmark/limits/<workload>.json`` and one reader per metric,
``benchmark/metrics/<metric>.py``; from the configuration file the
program and reference module of each part (``parts``); from the traffic
file the driver (``driver``, ``benchmark/drivers/<name>.py``). The run
makes the weights from the seed on the card, builds the program's parts,
lets the driver put them behind the program's entry and warm up every
shape the traffic uses (set-up), drives the traffic for ``--seconds``,
then (``--trace 1``) profiles one more call, reads the peak memory and
lets the driver free the program and compare what the window produced
with the plain reference. The last line of standard output is the JSON
result; the numbers compared, each beside its limit, are the last lines
of standard error.
"""

import time

START = time.perf_counter()  # set-up counts from here, before torch loads

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark.registry import ROOT, load_module, named  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dex_tts_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: dict  # name → (unit, reader module), in BENCHMARK.json's order


@dataclasses.dataclass
class Run:
    """What a metric reader (``read(run)``) gets."""

    setup_s: float
    window_s: float  # wall of the window's calls, end to end
    calls: list  # the driver's record per window call (wall_s, and what it returned)
    kernel_calls: dict  # traced: span name → per call, the tensor arguments' (shape, dtype)
    trace: object  # traced: `benchmark.trace.Trace` of one profiled call
    flops_per_call: float | None  # traced: the reference's FLOPs for one call


def load_cell(root: str, workload: str, trace: bool) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    read = lambda *p: json.load(open(os.path.join(root, *p)))
    chosen = {}
    for m in bench["per_layer"] if trace else bench["end_to_end"]:
        if workload in m.get("workloads", [workload]):
            path = os.path.join(root, "benchmark", "metrics", m["name"] + ".py")
            chosen[m["name"]] = (m["unit"], load_module(path))
    return Cell(workload, entry["chips"], read(config["file"]),
                read("benchmark", "traffic", entry["traffic"] + ".json"),
                read("benchmark", "limits", workload + ".json"), chosen)


def jax_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """→ (every number within its limit, {name: {"value", "limit"}}); a
    number the check did not give reads infinite."""
    table = {k: {"value": values.get(k, math.inf), "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, root: str = ROOT,
             start: float = START, control: bool = False) -> dict:
    """One run of ``cell`` → the result (the keys of the printed line).
    With ``control``, also the control's numbers on the checked call
    (``readings``; `benchmark.calibrate`)."""
    import torch

    from benchmark import program, spans
    from benchmark import trace as tracing
    from benchmark.weights import state_dicts

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = {"imports": time.perf_counter() - start}
    weights = state_dicts(cell.config, seed, device)
    sync()
    phases["weights"] = time.perf_counter() - start
    parts = program.build_parts(cell.config, weights)
    del weights
    driver = named("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, parts, seed, device, root, trace)
    del parts
    phases["program"] = time.perf_counter() - start
    driver.warm_up()
    sync()
    # what set-up made (torch's modules, the weights' records) leaves the
    # collector's view for the window, so a full collection there scans only
    # what the window's calls made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - start
    phases["warm-up"] = setup_s
    print("set-up, seconds from start:", json.dumps(phases), file=sys.stderr)

    collections = []
    clock = lambda phase, info: collections.append((phase, info["generation"],
                                                    time.perf_counter()))
    gc.callbacks.append(clock)
    window_s, calls = driver.window(seconds)
    gc.callbacks.remove(clock)
    gc.unfreeze()
    gc_s = [0.0, 0.0, 0.0]
    for (_, g, t0), (_, _, t1) in zip(collections[::2], collections[1::2]):
        gc_s[g] += t1 - t0
    walls = [c["wall_s"] for c in calls]
    slowest = max(range(len(walls)), key=walls.__getitem__)
    print(f"window: {len(calls)} calls in {window_s:.3f} s; wall per call min / median / max "
          f"{min(walls):.4f} / {sorted(walls)[len(walls) // 2]:.4f} / {walls[slowest]:.4f} s "
          f"(call {slowest}); collector s by generation {[round(t, 4) for t in gc_s]}",
          file=sys.stderr)
    kernel_calls, profile = {}, None
    if trace:
        targets = {}
        for _, module in cell.metrics.values():
            targets.update(getattr(module, "SPANS", {}))
        with tracing.profiled() as result, spans.kernel_spans(targets) as kernel_calls:
            driver.profiled_call()
            sync()
        profile = result[0]
        print("calls per kernel span in the profiled call:",
              json.dumps({k: len(v) for k, v in kernel_calls.items()}), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted = driver.attempted()
    leftover = jax_modules()

    t_ref = time.perf_counter()
    values, flops = driver.check(count_flops=trace, control=control)
    del driver
    print(f"check: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    correct, table = judge(values, cell.limits)

    run = Run(setup_s=setup_s, window_s=window_s, calls=calls, kernel_calls=kernel_calls,
              trace=profile, flops_per_call=flops)
    metrics = {}
    for name, (unit, module) in cell.metrics.items():
        value = module.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=profile.busy_s, window_s=profile.window_s)
        result["breakdown"] = {"device_ops": profile.device_ops(),
                               "idle_gaps": profile.idle_gaps()}
    result["jax_modules"] = leftover
    if control:
        result["readings"] = values
    result["checks"] = table
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(ROOT, args.workload, bool(args.trace))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed % 2**64, args.seconds, bool(args.trace), "cuda")
    leftover = sorted(set(result.pop("jax_modules")) | set(jax_modules()))
    if leftover:
        print(f"loaded after the window: {', '.join(leftover)}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"{name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
