"""Finding the benchmark's pieces by the names that `BENCHMARK.json` and
the configuration and traffic files give:

  benchmark/metrics/<metric>.py        a per-layer or end-to-end metric's reader
  benchmark/programs/<name>.py         a part of the program under test
                                       (a configuration's ``parts``)
  benchmark/reference/<name>.py        the plain reference of a part
                                       (a configuration's ``parts``)
  benchmark/drivers/<name>.py          how a traffic mix drives the program
                                       (a traffic file's ``driver``)
"""

from __future__ import annotations

import functools
import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(path: str):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def named(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, loaded once."""
    return load_module(os.path.join(ROOT, "benchmark", kind, name + ".py"))
