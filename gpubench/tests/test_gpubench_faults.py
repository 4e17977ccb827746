"""A run without the look for a card, at the CPU's size, with the timed
path sound and broken underneath: `correct` must come out true when sound
and false under each fault the cells can have (a step that leaves its state
unchanged, half of the batch left out, of the batch's rows in the loss, an
augmented clip altered where the augmentation produces it, the pool
kernel's output scaled, encoder_k's EMA left out, an enqueued key
altered), and false for the control (the reference in
fp8 put in the program's place). Judged by each cell's own limits."""

import json
import os

import pytest

from gpubench import check, run

MANIFEST = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2 ** 31 + 77


def _run(workload, fault=None):
    cell = run.shrink(run.resolve(workload, MANIFEST))
    out = run.run_cell(cell, SEED, 0.0, False, device="cpu", fault=fault)
    return cell, out


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(workload):
    cell, out = _run(workload)
    ok, shown = check.judge(out["values"], cell["limits"])
    assert ok, shown
    ctl = check.run_reference(out["recorded"], out["feed"].recorded, "cpu",
                              prec=check.FP8, start=out["start"])
    values = dict(check.numbers(ctl, out["reference"], "cpu"), loader=0.0)
    ok, shown = check.judge(values, cell["limits"])
    assert not ok, shown


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "pool_scaled", "loss_half", "ema_skipped",
                                   "enqueue_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    cell, out = _run(workload, fault)
    ok, shown = check.judge(out["values"], cell["limits"])
    assert not ok, shown


def test_unfilled_coclr_queue_is_not_correct():
    """CoCLR's timed call resuming from a checkpoint whose queues were left
    as drawn (the fill's state unchanged) fails `fill_keys`."""
    from gpubench.reference.step import RefMoCo

    cell, out = _run("s3d.coclr.resident")
    start = out["start"]
    c = cell["config"]
    drawn = RefMoCo(c["net"], c["moco_dim"], c["moco_k"], SEED, "coclr",
                    "cpu")
    state = dict(start["state"], queue=drawn.queue.t(),
                 queue_second=drawn.queue_second.t())
    values = dict(out["values"], **check.start_and_fill(
        out["recorded"], dict(start, state=state), out["reference"].filled))
    ok, shown = check.judge(values, cell["limits"])
    assert not ok and shown["fill_keys"]["value"] > \
        shown["fill_keys"]["limit"], shown
