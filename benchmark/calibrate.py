"""Readings for the limits of the correctness comparison, on the card, in
one process:

    python3 -m benchmark.calibrate --workload <name> --seeds 11 12 ... [--control 3]

For each seed, one run of the cell with a window of one call (the timed
path at the cell's own sizes: its batch, bucket and sampler) and the
numbers that `benchmark.check` compares; for the first ``--control``
seeds also the control's numbers (the reference one precision below the
configuration's, in the program's place). One JSON line per seed; the
last line gives, per number, the largest program reading and the
smallest control reading. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark.run import ROOT, load_cell, run_cell


def reading(cell, seed: int, control: bool, device="cuda") -> dict:
    """{"seed", "program": {...}, "control": {...} (with ``control``)}"""
    t0 = time.perf_counter()
    result = run_cell(cell, seed, 0.0, False, device, start=t0, control=control)
    row = {"seed": seed, "program": {k: v["value"] for k, v in result["checks"].items()},
           "correct": result["correct"], "seconds": time.perf_counter() - t0}
    row["items"] = {k: result["readings"][k + "_items"] for k in ("mel", "wav")} \
        if control else {}
    if control:
        row["control"] = result["readings"]["control"]
    return row


def summary(rows: list[dict]) -> dict:
    """Per number: the largest program reading, the smallest control one."""
    names = list(rows[0]["program"])
    lower = {k: max(r["program"][k] for r in rows) for k in names}
    controls = [r["control"] for r in rows if "control" in r]
    upper = {k: min(c[k] for c in controls) for k in names} if controls else {}
    return {"lower": lower, "upper": upper}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    cell = load_cell(ROOT, args.workload, trace=False)
    rows = []
    for i, seed in enumerate(args.seeds):
        rows.append(reading(cell, seed, i < args.control))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps(summary(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
