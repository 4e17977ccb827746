"""Per-op device-time profile of a training step on the card, the port's
counterpart of tools/profile_step.py:

    python -m coclr_tpu_torch.tools.profile_step --workload finetune
    python -m coclr_tpu_torch.tools.profile_step --workload infonce --net r50

It builds the step of one workload on a device-resident batch (random uint8
clips from a seeded numpy generator), as the JAX tool does: the finetune
step (`--train_what ft`, SGD at lr 1e-3, wd 1e-3, dropout 0.9, a 101-way
head), or the pretraining step of infonce, coclr or k400 (InfoNCE with
moco-k 16384; 2048 for the others; topk 5), in bfloat16 (float32 on the
CPU, where the repository holds the port in float32). It warms the
step up for 3 steps, and on the card the pretraining step on until it
replays its CUDA graph (parallel/train_step.py), traces `--steps` steps
with torch.profiler (utils/profiling.py) and reads the trace back.

Output: one JSON line with the JAX tool's keys (device_us_per_step,
categories_us_per_step, top_ops_us_per_step, trace_path, workload, steps,
clips_per_step, wall_us_per_step, clips_per_sec_device), plus `busy` (the
union of device intervals over the window's wall time), `launches_per_step`
(host launch calls, device ops, and each of the port's kernels), `device`
`net`, `warmup_steps` and `replayed_steps` (the steps, warm-ups included,
that replayed the pretraining step's CUDA graph, whose kernels no wrapper
launches from the host); a table goes to stderr and the trace stays under --logdir for
Perfetto. `wall_us_per_step` is the traced window's wall time per step
with the profiler on, which inflates the host's time: it is not the speed
of the step or of the loop. `top_ops_us_per_step` lists [name (first 160
characters), us per step, launches per step].

The CoCLR step is traced with a full queue (the queue-fill gate open): the
JAX program computes the update and discards it until the queue is full,
the port skips it, so the full-queue step is the one with the same device
work.

Runs on the card unless `--device cpu` is given; on the CPU only host ops
are traced, so the device fields are zero and empty ("device": "cpu").
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

WORKLOADS = ("finetune", "infonce", "coclr", "k400")
NUM_CLASS = 101


def _build_finetune(dev, net, batch_size, seq_len, img, dtype):
    """The classifier's `ft` step (eval/main_classifier.py's hot loop)."""
    import torch

    from coclr_tpu_torch.config import EvalConfig
    from coclr_tpu_torch.evalsuite import driver, steps

    cfg = EvalConfig(net=net, dataset="ucf101", seq_len=seq_len, img_dim=img,
                     batch_size=batch_size, train_what="ft", optim="sgd",
                     lr=1e-3, wd=1e-3, dropout=0.9, compute_dtype=dtype)
    model = driver.build_model(cfg).to(dev)
    opt = steps.make_classifier_optimizer(cfg, model)
    rng = np.random.RandomState(0)
    seq = torch.from_numpy(rng.randint(0, 255, (batch_size, seq_len, img, img, 3),
                                       np.uint8)).to(dev)
    label = torch.from_numpy(rng.randint(0, NUM_CLASS, (batch_size,))).to(dev)
    gen = torch.Generator(dev)
    box = [None]

    def run(i):
        gen.manual_seed(i)
        box[0] = steps.train_step(model, opt,
                                  steps.preprocess_train(seq, gen, cfg.dtype),
                                  label, 1e-3, drop_gen=gen)

    return run, box, batch_size, lambda: "eager", False


def _build_pretrain(dev, variant, net, batch_size, seq_len, img, dtype):
    """The pretraining step of `variant` (k400: InfoNCE with moco-k 16384)."""
    import torch

    from coclr_tpu_torch.config import PretrainConfig
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.ops.augment import make_pretrain_preprocess
    from coclr_tpu_torch.parallel.train_step import (graph_engages,
                                                     make_optimizer,
                                                     pretrain_step, step_mode)

    model_name = "infonce" if variant == "k400" else variant
    cfg = PretrainConfig(net=net, model=model_name, seq_len=seq_len,
                         img_dim=img, batch_size=batch_size,
                         moco_k=16384 if variant == "k400" else 2048,
                         compute_dtype=dtype, bn_shuffle="gather", topk=5)
    model = MoCo(net, cfg.moco_dim, cfg.moco_k, cfg.dtype,
                 variant=model_name).to(dev).train()
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    preprocess = make_pretrain_preprocess(cfg)
    rng = np.random.RandomState(0)
    host = {"aug_base": rng.randint(0, 2, (batch_size, 2)).astype(np.uint8),
            "label": rng.randint(0, NUM_CLASS, (batch_size,)).astype(np.int32)}
    clips = (batch_size, 2, seq_len, img, img, 3)
    if variant == "coclr":
        for key in ("seq_rgb", "seq_flow"):
            host[key] = rng.randint(0, 255, clips, np.uint8)
        host["vname"] = rng.randint(0, 9999, (batch_size,)).astype(np.int32)
        model.queue_label.fill_(1)  # the gate open: see the module docstring
    else:
        host["seq"] = rng.randint(0, 255, clips, np.uint8)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    gen = torch.Generator(dev)
    box = [None]

    def run(i):
        gen.manual_seed(i)
        box[0] = pretrain_step(model, opt, preprocess(batch, gen), 1e-3, cfg,
                               drop_self=True, update=True)

    return (run, box, batch_size * 2, lambda: step_mode(model),
            graph_engages(model, dev))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m coclr_tpu_torch.tools.profile_step",
        description="Per-op device-time profile of a training step.")
    ap.add_argument("--workload", default="finetune", choices=WORKLOADS)
    ap.add_argument("--net", default="s3d",
                    choices=["s3d", "s3dg", "r50", "r3d50", "tiny"])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--seq_len", type=int, default=32)
    ap.add_argument("--img_dim", type=int, default=128)
    ap.add_argument("--logdir", default="")
    ap.add_argument("--topk", type=int, default=25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Profile one workload; prints the JSON line and returns it as a dict."""
    args = build_parser().parse_args(argv)
    from coclr_tpu_torch.utils import prepare_run, profiling

    dev = prepare_run(args.device)
    shape = dict(net=args.net, batch_size=args.batch_size,
                 seq_len=args.seq_len, img=args.img_dim,
                 dtype="bfloat16" if dev.type == "cuda" else "float32")
    if args.workload == "finetune":
        run, box, clips, mode, graph = _build_finetune(dev, **shape)
    else:
        run, box, clips, mode, graph = _build_pretrain(dev, args.workload,
                                                       **shape)

    def fence():
        loss = float(box[0]["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"{args.workload}: the loss is not finite "
                               f"({loss})")

    # warm: cuDNN's choices, allocations, the kernels' builds and the
    # pretrain step's CUDA graph capture stay out
    warm, modes = 0, []
    while warm < 3 or (graph and modes[-1] != "replay"):
        if warm == 16:
            raise RuntimeError(f"{args.workload}: the step did not replay "
                               f"its CUDA graph in {warm} warm-up steps")
        run(warm)
        modes.append(mode())
        warm += 1
    fence()

    logdir = args.logdir or tempfile.mkdtemp(prefix="coclr_prof_")
    with profiling.device_trace(logdir, dev) as window:
        t0 = time.perf_counter()
        for i in range(args.steps):
            run(100 + i)
            modes.append(mode())
        fence()
        wall = time.perf_counter() - t0
    prof = profiling.read_trace(window.path, args.steps, args.topk,
                                wall_us=wall * 1e6)

    device_us = prof["device_us_per_step"]
    out = {
        "device_us_per_step": round(device_us, 1),
        "categories_us_per_step": {
            k: round(v, 1) for k, v in prof["categories_us_per_step"].items()},
        "top_ops_us_per_step": [[name[:160], round(us, 1), n]
                                for name, us, n in prof["top_ops_us_per_step"]],
        "trace_path": window.path,
        "workload": args.workload,
        "steps": args.steps,
        "clips_per_step": clips,
        "wall_us_per_step": round(wall * 1e6 / args.steps, 1),
        "clips_per_sec_device": (round(clips / (device_us * 1e-6), 1)
                                 if device_us else None),
        "busy": round(prof["busy"], 4),
        "launches_per_step": {
            "host_launch_calls": prof["host_launches_per_step"],
            "device_ops": prof["device_ops_per_step"],
            **{k: v["launches_per_step"] for k, v in prof["kernels"].items()}},
        "device": dev.type,
        "net": args.net,
        "warmup_steps": warm,
        "replayed_steps": modes.count("replay"),
    }
    for k, v in out["categories_us_per_step"].items():
        sys.stderr.write(f"{k:>28s}  {v:>10.1f} us/step\n")
    sys.stderr.write(
        f"{'TOTAL device':>28s}  {device_us:>10.1f} us/step (wall "
        f"{out['wall_us_per_step']:.1f} with the profiler on; busy "
        f"{out['busy']:.1%}; {out['launches_per_step']['device_ops']:.0f} "
        f"device ops, {out['launches_per_step']['host_launch_calls']:.0f} "
        f"host launch calls per step)\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
