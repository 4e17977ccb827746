"""On the card, at a cell's own size: one seed of the program is correct
and the control (the reference in fp8) is not. Run on the card's machine
with `python3 -m pytest gpubench/tests -m cuda`."""

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
                                      "r50.infonce.resident"])
def test_control_fails_at_the_cells_size(card, workload):
    cell = run.resolve(workload)
    cell["traffic"] = dict(cell["traffic"],
                           warm_steps=cell["traffic"]["checked_steps"])
    out = run.run_cell(cell, 2 ** 31 + 313, 0.0, False, device=card)
    ok, shown = check.judge(out["values"], cell["limits"])
    assert ok, shown
    ctl = check.run_reference(out["recorded"], out["feed"].recorded, card,
                              prec=check.FP8, start=out["start"])
    values = dict(check.numbers(ctl, out["reference"], card), loader=0.0)
    ok, shown = check.judge(values, {k: v for k, v in cell["limits"].items()
                                     if k in values})
    assert not ok, shown
