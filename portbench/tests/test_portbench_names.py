"""BENCHMARK.json against the benchmark's contract: names, units and
keys; every cell's configuration, traffic mix and per-layer readers
found by name."""

from __future__ import annotations

import os

import pytest

from portbench import cells, jobs

BENCH = cells.benchmark()
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry["name"]
    for w in BENCH["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            yield "reduced", k


@pytest.mark.parametrize("group,name", list(_names()))
def test_name_characters(group, name):
    assert cells.NAME.match(name), (group, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert cells.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric) <= METRIC_KEYS
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_top_level_keys_and_unique_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = cells.load_cell(cell)
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    conf = {x["name"]: x for x in BENCH["configs"]}[entry["config"]]
    assert c.config["name"] == entry["config"]
    assert c.config["reduced"] == conf["reduced"]
    assert os.path.samefile(os.path.join(cells.ROOT, conf["file"]),
                            cells.config_path(entry["config"]))
    assert c.traffic["mode"] in jobs.JOBS
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    numbers = {"samples_gap", "radiance_rel_p50", "radiance_rel_p90",
               "radiance_bias"}
    if c.traffic["mode"] == "interactive":
        numbers.add("ldr_off_share")
    assert set(c.traffic["limits"]) == numbers


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(metric):
    from portbench.metrics import reader

    assert callable(reader(metric["name"]))
    moves = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in moves
