"""The pretrain step replayed as a CUDA graph (coclr_tpu_torch/parallel/
train_step.py StepGraph).

On the CPU: when the graph engages, what its key holds, that a new key
releases the old graph, that run_pretrain reports how each step ran, that
CoCLR's self-drop as a device flag equals the host branch it replaced, and
that Adam, which runs outside the graph, leaves the state alone while
CoCLR's gate is closed.

On the card (marked `cuda`; they skip without one): the graph path against
the eager path from the same state and batches, for InfoNCE, UberNCE and
CoCLR with its gate closed and open at a small size and InfoNCE at the
benchmark cell's size; a change of lr and CoCLR's gate opening in the
middle of a run; a checkpoint written after replays, resumed. cuDNN runs deterministic there, so both
paths run the same kernels on the same data. The file imports neither jax
nor coclr_tpu, so on a machine with a card and no JAX it runs without the
suite's conftest:

    python -m pytest --noconftest tests/test_torch_step_graph.py -q
"""

import numpy as np
import pytest
import torch

from coclr_tpu_torch.config import PretrainConfig
from coclr_tpu_torch.kernels import pool
from coclr_tpu_torch.models import moco
from coclr_tpu_torch.ops.seqpar import SPAxes
from coclr_tpu_torch.parallel import train_step
from coclr_tpu_torch.parallel.train_step import (eager_step, make_optimizer,
                                                 pretrain_step, step_mode)
from coclr_tpu_torch.utils.checkpoint import (make_payload, resume_from,
                                              save_checkpoint)

CUDA = torch.device("cuda")


def _tiny(variant="infonce", sp=None):
    return moco.MoCo("tiny", 8, 16, torch.float32,
                     gen=torch.Generator().manual_seed(0), variant=variant,
                     sp=sp).train()


@pytest.mark.parametrize("case", ["card", "cpu", "ddp", "perm", "data_group",
                                  "process_group", "sp"])
def test_graph_engages_on_one_card_in_one_process(case, monkeypatch):
    """Only clips on a card, in one process, with encoders that carry no
    sequence-parallel spec, take the graph."""
    model = _tiny(sp=SPAxes() if case == "sp" else None)
    kw = {"ddp": object(), "perm": torch.arange(4),
          "data_group": object()}
    kw = {k: v for k, v in kw.items() if k == case}
    if case == "process_group":
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    device = torch.device("cpu") if case == "cpu" else CUDA
    assert train_step.graph_engages(model, device, **kw) == (case == "card")


def _inputs(b=2, t=4, s=16, variant="infonce", dtype=torch.float32):
    gen = torch.Generator().manual_seed(1)
    batch = {"seq": torch.randn(b, 2, t, s, s, 3, generator=gen).to(dtype),
             "label": torch.arange(b)}
    return train_step.step_inputs(batch, PretrainConfig(model=variant), variant)


@pytest.mark.parametrize("change", ["shape", "dtype", "moco_t", "topk"])
def test_a_new_key_recaptures_and_releases_the_old_graph(change):
    """A change of an input's shape or dtype, or of a constant of the step,
    gives a new StepGraph, which warms up and captures anew; the old one
    lets go of its graph, its buffers and the gradients in its pool. The
    same key keeps the same StepGraph."""
    model, cfg = _tiny(), PretrainConfig()
    inputs = _inputs()
    key = train_step.step_key(model, inputs, cfg)
    old = train_step.graph_for(model, key, inputs)
    assert train_step.graph_for(model, key, inputs) is old
    assert old.static["x1"].shape == (2, 3, 4, 16, 16)
    assert old.static["x1"].is_contiguous()
    old.graph, old.outputs, old.calls, old.mode = object(), {}, 9, "replay"
    for p in model.encoder_q.parameters():
        p.grad = torch.zeros_like(p)
    assert step_mode(model) == "replay"

    if change == "shape":
        inputs = _inputs(b=4)
    elif change == "dtype":
        inputs = _inputs(dtype=torch.bfloat16)
    else:
        cfg = PretrainConfig(**{change: {"moco_t": 0.1, "topk": 3}[change]})
    new_key = train_step.step_key(model, inputs, cfg)
    assert new_key != key
    new = train_step.graph_for(model, new_key, inputs)
    assert new is not old and new.calls == 0 and new.graph is None
    assert step_mode(model) == "eager"
    assert old.graph is None and old.outputs is None and old.static is None
    assert all(p.grad is None for p in model.encoder_q.parameters())


def test_the_key_leaves_out_what_only_adam_reads():
    """The learning rate and CoCLR's gate reach Adam only, which runs
    outside the graph: neither is in the key, so an epoch's new lr or the
    gate's opening replays the graph that is there."""
    import inspect

    assert list(inspect.signature(train_step.step_key).parameters) == [
        "model", "inputs", "cfg"]
    model, inputs = _tiny(), _inputs()
    key = train_step.step_key(model, inputs, PretrainConfig(lr=1e-3))
    assert key == train_step.step_key(model, inputs, PretrainConfig(lr=1e-4))


def test_a_graph_dies_with_its_model():
    import gc

    model = _tiny()
    inputs = _inputs()
    key = train_step.step_key(model, inputs, PretrainConfig())
    train_step.graph_for(model, key, inputs)
    assert len(train_step._GRAPHS) >= 1
    before = len(train_step._GRAPHS)
    del model
    gc.collect()
    assert len(train_step._GRAPHS) == before - 1


class _Batches:
    """A loader of fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_run_pretrain_on_cpu_reports_every_step_eager(tmp_path, monkeypatch,
                                                      capsys):
    from coclr_tpu_torch.train.pretrain import run_pretrain

    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    batches = [{"seq": rng.randint(0, 256, (2, 2, 4, 32, 32, 3), np.uint8),
                "aug_base": rng.randint(0, 2, (2, 2)).astype(np.uint8)}
               for _ in range(5)]
    cfg = PretrainConfig(net="tiny", seq_len=4, img_dim=32, batch_size=2,
                         moco_k=8, moco_dim=8, epochs=2, print_freq=100,
                         compute_dtype="float32")
    _, _, info = run_pretrain(cfg, loader=_Batches(batches), device="cpu")
    assert info["step_graph"] == ["eager"] * 10
    assert len(info["step_graph"]) == len(info["step_s"])
    assert info["reserved_bytes"] == []
    epoch_lines = [line for line in capsys.readouterr().out.splitlines()
                   if line.startswith("Epoch: [")]
    assert [line.split()[-2:] for line in epoch_lines] == [
        ["captures:0", "replays:0"]] * 2


def test_the_benchmark_reads_back_only_eager_warm_up_calls():
    """gpubench/tap.py takes pretrain_step's place for a run's first
    `checked_steps` calls and reads tensors back to the host in them, which
    no capture can hold: every traffic file keeps those calls among the
    eager warm-ups."""
    import glob
    import json
    import os

    root = os.path.join(os.path.dirname(__file__), "..", "gpubench",
                        "traffic")
    files = sorted(glob.glob(os.path.join(root, "*.json")))
    assert files
    for path in files:
        with open(path) as f:
            checked = json.load(f)["checked_steps"]
        assert 0 < checked <= train_step.WARMUP_CALLS, path


@pytest.mark.parametrize("drop_self", [True, False])
def test_self_drop_flag_equals_the_host_branch(drop_self):
    """CoCLR's self-drop read from a 0-d device flag gives the mask and the
    loss of the host branch it replaced, bit for bit: rows with one
    positive keep it, rows with several lose the self-positive."""
    gen = torch.Generator().manual_seed(3)
    b, k = 6, 32
    mask = (torch.rand(b, 1 + k, generator=gen) < 0.1).to(torch.float32)
    mask[:, 0] = 1.0
    mask[:2, 1:] = 0.0  # the self-positive alone
    logits = torch.randn(b, 1 + k, generator=gen)

    used = mask
    if drop_self:  # the host branch
        used = mask.clone()
        used[:, 0] = torch.where(mask.sum(dim=1) != 1, 0.0, mask[:, 0])
    flag = torch.tensor(drop_self)
    got = train_step.drop_self_positive(mask, flag)
    assert torch.equal(got, used)
    assert torch.equal(moco.multi_nce_loss(logits, got),
                       moco.multi_nce_loss(logits, used))
    assert bool((got[:2, 0] == 1).all())
    assert bool((got[2:, 0] == 0).all()) == drop_self


@pytest.mark.parametrize("update", [False, True])
def test_eager_step_runs_the_body_then_adam(update):
    """eager_step is step_body, then adam_step: with CoCLR's gate closed the
    backward runs (the gradients are there) and the parameters and Adam's
    state stay as they were; open, Adam steps at the lr given."""
    cfg = PretrainConfig(net="tiny", moco_k=16, moco_dim=8)
    model = _tiny()
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    before = [p.detach().clone() for p in model.encoder_q.parameters()]
    batch = torch.randn(2, 2, 4, 16, 16, 3,
                        generator=torch.Generator().manual_seed(2))
    metrics = eager_step(model, opt, batch, 5e-4, cfg, update=update)
    assert set(metrics) == {"loss", "top1", "top5"}
    assert int(model.queue_ptr) == 2
    params = list(model.encoder_q.parameters())
    assert all(p.grad is not None for p in params)
    moved = [not torch.equal(p, b) for p, b in zip(params, before)]
    assert any(moved) == update and all(moved) == update
    assert bool(opt.state) == update
    assert opt.param_groups[0]["lr"] == (5e-4 if update else cfg.lr)


# --- on the card ------------------------------------------------------------

SMALL = dict(b=4, t=8, s=64, k=64, dim=16)
CELL = dict(b=32, t=32, s=128, k=2048, dim=128)  # s3d.infonce.resident


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph has no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


def _model(variant, size, full_queue, dev):
    """S3D's MoCo; CoCLR's queue full (its gate open) with `full_queue`,
    UberNCE's queue labelled with the batches' classes."""
    model = moco.MoCo("s3d", size["dim"], size["k"], torch.bfloat16,
                      gen=torch.Generator().manual_seed(0), variant=variant)
    if variant == "coclr" and full_queue:
        model.queue_label.fill_(1)
        model.queue_vname.copy_(torch.arange(size["k"]) % 6)
    if variant == "ubernce":
        model.queue_label.copy_(torch.arange(size["k"]) % 3)
    return model.to(dev).train()


def _batches(variant, size, n, dev):
    gen = torch.Generator(dev).manual_seed(11)
    shape = (size["b"], 2, size["t"], size["s"], size["s"], 3)
    clips = lambda: torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)
    out = []
    for _ in range(n):
        if variant == "coclr":
            out.append({"seq_rgb": clips(), "seq_flow": clips(),
                        "vname": torch.randint(0, 6, (size["b"],), device=dev,
                                               generator=gen,
                                               dtype=torch.int32)})
        elif variant == "ubernce":
            out.append({"seq": clips(),
                        "label": torch.randint(0, 3, (size["b"],), device=dev,
                                               generator=gen)})
        else:
            out.append({"seq": clips()})
    return out


def _run(step, model, opt, batches, lrs, cfg, updates, trace_from=None):
    """Steps of `step` over the batches at lrs[i], CoCLR's gate updates[i];
    (metrics on the host, step modes, pool-backward launches through the
    wrapper, and with `trace_from` the pool-backward kernels a step in a
    device trace of the steps from that one on)."""
    from torch.profiler import ProfilerActivity, profile

    from coclr_tpu_torch.utils.profiling import read_trace

    launches = pool.KERNEL.launches
    metrics, modes, prof = [], [], None
    for i, (batch, lr, update) in enumerate(zip(batches, lrs, updates)):
        if i == trace_from:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        m = step(model, opt, batch, lr, cfg, drop_self=i % 3 != 1,
                 update=update)
        metrics.append(m)
        modes.append(step_mode(model))
    torch.cuda.synchronize()
    traced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        kernels = read_trace(prof, len(batches) - trace_from)["kernels"]
        traced = kernels["pool1d_bwd_kernel"]["launches_per_step"]
    host = [{k: float(v) for k, v in m.items()} for m in metrics]
    return host, modes, pool.KERNEL.launches - launches, traced


def _assert_same(graph_model, graph_opt, eager_model, eager_opt,
                 graph_metrics=None, eager_metrics=None):
    """The graph path's state against the eager path's, bit for bit: queue
    pointer, labels and names, queues, encoder_q, encoder_k, BatchNorm
    statistics, Adam's moments and step count, and the metrics."""
    for name in ("queue_ptr", "queue_label", "queue_vname"):
        if hasattr(eager_model, name):
            assert torch.equal(getattr(graph_model, name),
                               getattr(eager_model, name)), name
    groups = {"queue": [], "encoder_q": [], "encoder_k": [], "bn_stats": [],
              "adam": [], "metrics": []}
    g_state, e_state = graph_model.state_dict(), eager_model.state_dict()
    for key, want in e_state.items():
        got = g_state[key]
        if key.startswith("queue_") and key != "queue_second":
            continue
        if key in ("queue", "queue_second"):
            group = "queue"
        elif "running_" in key or "num_batches" in key:
            group = "bn_stats"
        else:
            group = key.split(".")[0]
        if group in groups:
            groups[group].append((key, got, want))
    for p, q in zip(graph_model.encoder_q.parameters(),
                    eager_model.encoder_q.parameters()):
        for name in ("exp_avg", "exp_avg_sq", "step"):
            if name in eager_opt.state.get(q, {}):
                groups["adam"].append((name, graph_opt.state[p][name],
                                       eager_opt.state[q][name]))
    for i, (gm, em) in enumerate(zip(graph_metrics or [], eager_metrics or [])):
        assert gm.keys() == em.keys()
        for k in gm:
            groups["metrics"].append((f"{k}@{i}", torch.tensor(gm[k]),
                                      torch.tensor(em[k])))
    for group, pairs in groups.items():
        for key, got, want in pairs:
            assert torch.equal(got, want), (group, key)


CASES = {"infonce": ("infonce", SMALL, True, True),
         "ubernce": ("ubernce", SMALL, True, True),
         "coclr-closed": ("coclr", SMALL, False, False),
         "coclr-open": ("coclr", SMALL, True, True),
         "infonce-cell": ("infonce", CELL, True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graph_steps_equal_eager_steps_on_card(dev, case):
    """8 steps through the graph path (3 eager warm-ups, the capture, 4
    replays) against 8 eager steps from the same state and batches. The
    wrapper launches the pool kernel in the steps that run Python, and a
    device trace of the last 4 steps shows it 37 times a step on both
    paths."""
    variant, size, full, update = CASES[case]
    cfg = PretrainConfig(net="s3d", model=variant, moco_k=size["k"],
                         moco_dim=size["dim"], topk=3)
    lrs = [1e-3] * 8
    batches = _batches(variant, size, len(lrs), dev)
    runs = []
    for step in (pretrain_step, eager_step):
        model = _model(variant, size, full, dev)
        opt = make_optimizer(cfg, model.encoder_q.parameters())
        runs.append((model, opt) + _run(step, model, opt, batches, lrs, cfg,
                                        [update] * len(lrs), trace_from=4))
    (gm, go, g_metrics, g_modes, g_launch, g_traced), (
        em, eo, e_metrics, e_modes, e_launch, e_traced) = runs
    assert g_modes == ["eager"] * 3 + ["capture"] + ["replay"] * 4
    assert e_modes == ["eager"] * 8
    assert g_launch == 37 * 4 and e_launch == 37 * 8
    assert g_traced == e_traced == 37
    _assert_same(gm, go, em, eo, g_metrics, e_metrics)


@pytest.mark.cuda
def test_an_lr_change_and_the_gate_opening_replay_and_equal_eager_on_card(
        dev):
    """CoCLR with its gate closed for 5 steps, then open; the lr changes at
    step 7. Adam runs outside the graph, so neither change recaptures."""
    cfg = PretrainConfig(net="s3d", model="coclr", moco_k=SMALL["k"],
                         moco_dim=SMALL["dim"], topk=3)
    lrs = [1e-3] * 7 + [5e-4] * 3
    updates = [False] * 5 + [True] * 5
    batches = _batches("coclr", SMALL, len(lrs), dev)
    runs = []
    for step in (pretrain_step, eager_step):
        model = _model("coclr", SMALL, False, dev)
        opt = make_optimizer(cfg, model.encoder_q.parameters())
        runs.append((model, opt) + _run(step, model, opt, batches, lrs, cfg,
                                        updates))
    (gm, go, g_metrics, g_modes, g_launch, _), (em, eo, e_metrics, _,
                                                e_launch, _) = runs
    assert g_modes == ["eager"] * 3 + ["capture"] + ["replay"] * 6
    assert g_launch == 37 * 4 and e_launch == 37 * len(lrs)
    _assert_same(gm, go, em, eo, g_metrics, e_metrics)


@pytest.mark.cuda
def test_a_checkpoint_written_after_replays_resumes_on_card(dev, tmp_path):
    """A checkpoint written after two replays resumes with resume_from into
    equal state; both models then take two more steps (replays on the
    first, eager warm-ups on the second) and stay equal."""
    cfg = PretrainConfig(net="s3d", model="coclr", moco_k=SMALL["k"],
                         moco_dim=SMALL["dim"], topk=3)
    batches = _batches("coclr", SMALL, 8, dev)
    model = _model("coclr", SMALL, True, dev)
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    _, modes, _, _ = _run(pretrain_step, model, opt, batches[:6], [1e-3] * 6,
                          cfg, [True] * 6)
    assert modes[-1] == "replay"
    path = str(tmp_path / "epoch0.pth.tar")
    save_checkpoint(make_payload(model, opt, 0, 0.0, 7), filename=path)

    back = moco.MoCo("s3d", SMALL["dim"], SMALL["k"], torch.bfloat16,
                     gen=torch.Generator().manual_seed(1),
                     variant="coclr").to(dev).train()
    back_opt = make_optimizer(cfg, back.encoder_q.parameters())
    assert resume_from(path, back, back_opt) == (1, 7, 0.0)
    _assert_same(model, opt, back, back_opt)
    m1, modes1, _, _ = _run(pretrain_step, model, opt, batches[6:],
                            [1e-3] * 2, cfg, [True] * 2)
    m2, modes2, _, _ = _run(pretrain_step, back, back_opt, batches[6:],
                            [1e-3] * 2, cfg, [True] * 2)
    assert modes1 == ["replay"] * 2 and modes2 == ["eager"] * 2
    _assert_same(model, opt, back, back_opt, m1, m2)
