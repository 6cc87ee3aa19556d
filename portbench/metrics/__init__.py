"""Per-layer metric readers, one module a metric, named as the metric is
in ``BENCHMARK.json`` and found by that name: ``read(trace)`` takes a
``portbench.trace.Trace`` and returns the value, or None where it finds
nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

import importlib.util
import os

_DIR = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(_DIR, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
