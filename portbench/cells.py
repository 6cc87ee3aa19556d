"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout,
one file a configuration under ``portbench/configs/`` and one a traffic
mix under ``portbench/traffic/``, each found by its name."""

from __future__ import annotations

import dataclasses
import json
import os
import re

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads``: its configuration and traffic files,
    the end-to-end metrics it reports and the per-layer metrics its traced
    run reads."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def config_path(name: str) -> str:
    return os.path.join(PKG_DIR, "configs", f"{name}.json")


def traffic_path(name: str) -> str:
    return os.path.join(PKG_DIR, "traffic", f"{name}.json")


def _reported(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell named ``workload``; raises ``KeyError`` for a name
    ``BENCHMARK.json`` does not list."""
    bench = benchmark() if bench is None else bench
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config=load_json(config_path(entry["config"])),
        traffic=load_json(traffic_path(entry["traffic"])),
        end_to_end=[m for m in bench["end_to_end"]
                    if _reported(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, workload)])
