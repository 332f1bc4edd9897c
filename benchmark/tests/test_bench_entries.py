"""Every entry of BENCHMARK.json resolves to its files by name, and the
file keeps the contract's form."""

import json
import os
import re

import pytest

from benchmark.registry import named
from benchmark.run import ROOT, load_cell, load_module

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("benchmark/") and NAME.match(config["name"])
    with open(os.path.join(ROOT, config["file"])) as f:
        body = json.load(f)
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
    for part, names in body["parts"].items():
        assert callable(named("programs", names["program"]).build)
        assert callable(named("reference", names["reference"]).build)
        assert body["precision"][part] in ("float32", "bfloat16")
    assert all(k.split(".")[0] in body["parts"] for k in body["precision"])


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
@pytest.mark.parametrize("trace", [False, True])
def test_workload_resolves(workload, trace):
    assert set(workload) == {"name", "config", "traffic", "chips", "why"}
    assert len(workload["why"]) <= 200 and workload["chips"] == 1
    cell = load_cell(ROOT, workload["name"], trace)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    assert callable(named("drivers", cell.traffic["driver"]).Driver)
    assert cell.traffic["batch"] <= len(cell.traffic["pool"])
    for _, module in cell.metrics.values():
        assert callable(module.read)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    module = load_module(os.path.join(ROOT, "benchmark", "metrics", metric["name"] + ".py"))
    assert callable(module.read)
    if metric in BENCH["per_layer"]:
        assert metric["moves"] == "rtf" and "\n" not in metric["layer"]
    else:
        assert metric["source"] in ("host_clock", "device_trace") and metric["bound"] <= 0.25
    for span in getattr(module, "SPANS", {}).values():
        module_path, attr = span
        assert module_path.startswith("dex_tts_tpu_torch.") and attr.isidentifier()


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for w in BENCH["workloads"]:
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in BENCH["per_layer"])
