"""Nothing a run loads is JAX or the JAX package, compared by the whole
top-level module name; the plain reference loads nothing of the program
either."""

import ast
import json
import os
import subprocess
import sys

from benchmark.run import FORBIDDEN, ROOT

DRY_RUN = """
import json, sys
from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell, workloads
for w in workloads():
    run_cell(tiny_cell(w, trace=True), seed=3, seconds=0.0, trace=True, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
REFERENCE = """
import json, sys
import benchmark.reference
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_dry_run_loads_no_jax():
    loaded = _top_level(DRY_RUN)
    assert "dex_tts_tpu_torch" in loaded  # the program did run
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & (set(FORBIDDEN) | {"dex_tts_tpu_torch"})


def test_no_reference_source_imports_the_program():
    directory = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(directory):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(directory, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in FORBIDDEN and top != "dex_tts_tpu_torch", (name, mod)
