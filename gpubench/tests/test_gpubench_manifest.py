"""BENCHMARK.json against the benchmark's contract: names, units, bounds,
and every file that a cell, configuration or metric names."""

import json
import os
import re

import pytest

from gpubench import run

MANIFEST = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) < 65536
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["command"][:3] == ["python3", "-m", "gpubench.run"]


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in MANIFEST["configs"]]
                         + [w["traffic"] for w in MANIFEST["workloads"]])
def test_name(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
        assert "\n" not in metric["layer"] and 0 < len(metric["layer"]) <= 200
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           metric["name"] + ".py"))


def test_setup_metric_is_there():
    names = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = run.resolve(workload, MANIFEST)
    assert cell["chips"] == 1
    assert cell["traffic"]["feed"] == "resident"
    assert cell["per_layer"] == [m["name"] for m in MANIFEST["per_layer"]]
    assert cell["limits"], "every cell has its limits file"
    for metric in cell["per_layer"]:
        assert callable(run.reader(metric))


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    path = os.path.join(run.ROOT, conf["file"])
    assert conf["file"].startswith("gpubench/")
    data = json.load(open(path))
    assert set(conf["reduced"]) == set(data["reduced"])
    assert data["source"] == conf["source"]
    assert any(w["config"] == conf["name"] for w in MANIFEST["workloads"])
