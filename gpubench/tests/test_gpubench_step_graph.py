"""On the card: the program's pretrain step replays its CUDA graph in the
timed window, and the calls that the tap reads back to the host for the
check of `correct` come before the graph's capture. Run on the card's
machine with `python3 -m pytest gpubench/tests -m cuda`."""

import pytest

from gpubench import check, run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    run.cache_env()
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["s3d.infonce.resident",
                                      "s3d.coclr.resident"])
def test_the_window_replays_after_the_checked_calls(card, workload):
    cell = run.resolve(workload)
    t = cell["traffic"]
    out = run.run_cell(cell, 2 ** 31 + 919, 2.0, False, device=card)
    ok, shown = check.judge(out["values"], cell["limits"])
    assert ok, shown
    modes = out["info"]["step_graph"]
    capture = modes.index("capture")
    assert modes.count("capture") == 1
    assert t["checked_steps"] <= capture < t["warm_steps"]
    assert modes[:capture] == ["eager"] * capture
    window = modes[t["warm_steps"]:t["warm_steps"] + out["steps"]]
    assert out["steps"] > 0 and window == ["replay"] * out["steps"]
    assert run.reader("step.graph_replay_pct")(
        run.Context(out["feed"], out["info"], None, None)) == 100.0
