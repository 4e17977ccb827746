"""The result line of a run, from a CPU dry run at the CPU's size: the keys
a reader of the result takes, the metrics of the cell, the compared
numbers last."""

import json

import pytest

from gpubench import run

CARD = {"name": "cpu dry run", "power_limit": None}


@pytest.fixture(scope="module")
def traced():
    cell = run.shrink(run.resolve("s3d.infonce.resident"))
    return cell, run.run_cell(cell, 2 ** 31 + 5, 1.0, True, device="cpu")


def test_end_to_end_line(traced):
    cell, out = traced
    line = run.result_line(cell, out, CARD, traced=False)
    json.loads(json.dumps(line))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"clips_per_s", "setup_s"}  # no card peak
    assert line["attempted"] == out["steps"] > 0
    assert line["device"]["platform"] == "gpu"
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert set(line["checks"]) == set(cell["limits"])


def test_traced_line(traced):
    cell, out = traced
    line = run.result_line(cell, out, CARD, traced=True)
    assert list(line)[-1] == "checks"
    assert len(line["breakdown"]["device_ops"]) <= 10
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # the CPU has no device trace: only the host-clock metrics are read
    assert set(line["metrics"]) == {"loader.wait_ms", "loop.step_ms_p90"}
    assert line["device"]["window_s"] > 0


def test_window_steps_are_the_loops(traced):
    cell, out = traced
    feed = out["feed"]
    assert len(feed.recorded) == cell["traffic"]["checked_steps"]
    assert len(out["info"]["step_s"]) == (feed.warm_steps + feed.steps
                                          + cell["traffic"]["trace_steps"])
