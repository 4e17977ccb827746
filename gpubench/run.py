"""Benchmark of the PyTorch port's pretraining on one or more NVIDIA cards.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell, its configuration (configs/<name>.json), its traffic
(traffic/<name>.json), its limits (limits/<cell>.json) and, with
`--trace 1`, its per-layer metrics (metrics/<name>.py) by the names that
BENCHMARK.json gives. Drives the port's own entry,
coclr_tpu_torch.train.pretrain.run_pretrain, with the port's Loader wrapped
in feed.Feed, checks the first steps against the plain reference
(check.py), and prints one JSON line last on standard output. It never
runs without a card: no CUDA, or fewer cards than the cell asks for, is an
error and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gpubench")
FORBIDDEN = ("jax", "jaxlib", "flax", "coclr_tpu")


def cache_env(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels under build/kernels there by itself)."""
    cache = os.path.join(root, "build", "gpubench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def resolve(workload: str, manifest: dict = None) -> dict:
    """The cell named `workload` with its configuration, traffic, limits
    and per-layer metric names, all found by name."""
    if manifest is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    limits_path = os.path.join(HERE, "limits", workload + ".json")
    limits = {}
    if os.path.exists(limits_path):
        limits = {k: v["limit"] for k, v in load_json(
            "limits", workload + ".json").items()}
    layer = [m["name"] for m in manifest["per_layer"]
             if workload in m.get("workloads", [workload])]
    return {"name": workload, "chips": cell["chips"], "config": config,
            "traffic": load_json("traffic", cell["traffic"] + ".json"),
            "limits": limits, "per_layer": layer}


def shrink(cell: dict) -> dict:
    """The cell at a size the CPU runs in seconds (tests and rehearsals):
    its widths as published, its clips, batch, queue and data cut down,
    float32 compute."""
    c = dict(cell["config"], seq_len=8, img_dim=32, batch_size=4, moco_k=16,
             compute_dtype="float32")
    t = dict(cell["traffic"], samples=8, epoch_samples=64, videos=4, frames=16,
             frame_hw=[48, 64], texture_scale=4, unique_frames=2, classes=2,
             workers=2, warm_steps=4, trace_steps=2)
    if "fill_steps" in t:
        t["fill_steps"] = c["moco_k"] // c["batch_size"]
    return dict(cell, config=c, traffic=t)


def reader(name: str):
    """metrics/<name>.py's `read(ctx)`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("gpubench_metric_" +
                                                  name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_info():
    import torch

    info = {"name": torch.cuda.get_device_name(0), "power_limit": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def port_config(cell: dict, seed: int):
    from coclr_tpu_torch.config import PretrainConfig

    c, t = cell["config"], cell["traffic"]
    return PretrainConfig(
        net=c["net"], model=t["variant"], dataset="ucf101-2clip",
        seq_len=c["seq_len"], batch_size=c["batch_size"], lr=c["lr"],
        wd=c["wd"], moco_k=c["moco_k"], moco_dim=c["moco_dim"],
        moco_t=c["moco_t"], moco_m=c["moco_m"], img_dim=c["img_dim"],
        compute_dtype=c["compute_dtype"], topk=c.get("topk", 5),
        workers=t["workers"], worker_mode=t["worker_mode"], epochs=1,
        seed=seed, prefix="gpubench")


class Context:
    """What a per-layer metric reader reads: the Feed (its waits), the
    loop's info (step_s), the traced window (trace.Window) and the step's
    work (work_counts)."""

    def __init__(self, feed, info, window, counts):
        self.feed, self.info = feed, info
        self.window, self.counts = window, counts

    @property
    def window_step_s(self):
        lo = self.feed.warm_steps
        return self.info["step_s"][lo:lo + self.feed.steps]


def work_counts(cell):
    from gpubench import counts

    c, t = cell["config"], cell["traffic"]
    b, seq, img = c["batch_size"], c["seq_len"], c["img_dim"]
    frames = b * 2 * seq * (1 if t["variant"] == "infonce" else 2)
    item = 2 if c["compute_dtype"] == "bfloat16" else 4
    return {"flops": counts.step_flops(c["net"], b, seq, img, c["moco_dim"],
                                       c["moco_k"], t["variant"]),
            "pool_bytes": counts.pool_bwd_bytes(
                counts.pool_launches(c["net"], b, seq, img), item),
            "jitter_bytes": counts.jitter_bytes(frames, img, item)}


def fill_queue(pretrain, cell, seed, loader, device, on_card) -> dict:
    """CoCLR's gate, opened in set-up: run_pretrain over `fill_steps`
    gated steps (each enqueues its batch; the optimizer does not step while
    a queue slot is empty), whose checkpoint the timed call resumes from.
    Returns the checkpoint's path, its state and iteration, and the fill
    batches' source ids."""
    import torch

    from gpubench.feed import Feed

    t = cell["traffic"]
    feed = Feed(loader, t["fill_steps"], t["fill_steps"], 0.0, 0, on_card,
                keep=("vname",))
    model, optimizer, info = pretrain.run_pretrain(
        port_config(cell, seed), loader=feed, device=device)
    del model, optimizer
    gc.collect()
    path = os.path.abspath(os.path.join(info["exp_path"], "model",
                                        "epoch0.pth.tar"))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {"path": path, "state": ckpt["state_dict"],
            "iteration": ckpt["iteration"],
            "vnames": [b["vname"] for b in feed.recorded]}


def _no_save(payload, **kw):
    """Stands in for the program's save_checkpoint after the window."""


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device: str = "cuda", fault: str = None) -> dict:
    """One run of `cell`: set-up, the window, the check. Returns the result
    line's fields and the numbers compared."""
    import torch

    from coclr_tpu_torch.data.loader import Loader
    from coclr_tpu_torch.kernels import pool as kernel_pool
    from coclr_tpu_torch.models import moco as port_moco
    from coclr_tpu_torch.train import pretrain

    from gpubench import check
    from gpubench.feed import Feed, make_resident
    from gpubench.reference.models import STEM
    from gpubench.tap import StepTap

    on_card = torch.device(device).type == "cuda"
    c, t = cell["config"], cell["traffic"]
    workdir = tempfile.mkdtemp(prefix="gpubench-")
    cwd = os.getcwd()
    try:
        dataset = make_resident(t, c, seed, device)
        loader = Loader(dataset, batch_size=c["batch_size"],
                        num_workers=t["workers"], seed=seed,
                        worker_mode=t["worker_mode"])
        cfg = port_config(cell, seed)
        os.chdir(workdir)  # run_pretrain writes log-<prefix>/ under the cwd
        start = None
        if t.get("fill_steps"):
            start = fill_queue(pretrain, cell, seed, loader, device, on_card)
            cfg.resume, cfg.epochs = start["path"], 2
        feed = Feed(loader, t["warm_steps"], t["checked_steps"], seconds,
                    t["trace_steps"] if traced else 0, on_card,
                    first_epoch=1 if start else 0)
        tap = StepTap(pretrain, t["checked_steps"], fault, STEM[c["net"]],
                      pool=kernel_pool, moco=port_moco).install()
        tap.local["iteration"] = start["iteration"] if start else 1
        # the checkpoint that run_pretrain writes after the loop (twice:
        # epoch and best) is outside the window; not writing it keeps a
        # run's disk writes to its data (a full check of r50 would write
        # 16 GB of checkpoints)
        save, pretrain.save_checkpoint = pretrain.save_checkpoint, _no_save
        try:
            model, optimizer, info = pretrain.run_pretrain(
                cfg, loader=feed, device=device)
        finally:
            tap.uninstall()
            pretrain.save_checkpoint = save
            os.chdir(cwd)
        setup_s = feed.t_open - T_START
        del model, optimizer
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        clips = feed.steps * 2 * c["batch_size"]
        out = {"steps": feed.steps,
               "e2e": {"clips_per_s": clips / max(feed.window_s, 1e-9),
                       "setup_s": setup_s},
               "peak_bytes": feed.peak_bytes, "feed": feed, "info": info}
        if feed.peak_bytes is not None:
            out["e2e"]["peak_mem_gib"] = feed.peak_bytes / 2 ** 30
        run = {"config": c, "traffic": t, "seed": seed, "dataset": dataset,
               "epochs": feed.epochs}
        t_ref = time.perf_counter()
        values = {"loader": float(check.loader_mismatch(run, feed.recorded))}
        ref = check.run_reference(run, feed.recorded, device, start=start)
        if start is not None:
            values.update(check.start_and_fill(run, start, ref.filled))
        got = check.Readings.of_tap(tap)
        values.update(check.numbers(got, ref, device))
        values["pool_bwd"] = check.pool_gap(tap.pool, device)
        values.update(check.local_numbers(tap.local, run, device))
        out["worst_leaves"] = check.worst_leaves(got, ref)
        out["values"] = values
        out["reference"] = ref
        out["recorded"] = run
        out["start"] = start
        out["reference_s"] = time.perf_counter() - t_ref
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def per_layer(cell, out):
    feed = out["feed"]
    ctx = Context(feed, out["info"], feed.window, work_counts(cell))
    metrics = {}
    for name in cell["per_layer"]:
        value = reader(name)(ctx)
        if value is not None:
            metrics[name] = value
    return metrics


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = resolve(args.workload)
    cache_env()
    import torch

    if not torch.cuda.is_available():
        print("gpubench: CUDA is not available; no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"gpubench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found; no result", file=sys.stderr)
        return 3
    card = card_info()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    result = result_line(cell, out, card, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    for name, value in out["values"].items():
        if name not in result["checks"]:
            print(f"gpubench: not compared: {name} {value!r}", file=sys.stderr)
    print(f"gpubench: set-up {out['e2e']['setup_s']:.2f} s, {out['steps']} "
          f"steps in the window, reference check {out['reference_s']:.1f} s, "
          f"card {card['name']} at {card['power_limit']} W", file=sys.stderr)
    if args.trace:
        print("gpubench: device seconds by category in the traced window "
              + json.dumps(out["feed"].window.categories()), file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def result_line(cell: dict, out: dict, card: dict, traced: bool) -> dict:
    """The result's JSON object: end-to-end metrics, or with `traced` the
    per-layer ones and the breakdown; the compared numbers last."""
    from gpubench import check

    correct, shown = check.judge(out["values"], cell["limits"])
    manifest = _manifest()
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"]
             + manifest["per_layer"]}
    device = {"platform": "gpu", "kind": card["name"], "count": cell["chips"],
              "memory_peak_bytes": out["peak_bytes"],
              "power_limit_w": card["power_limit"]}
    result = {"correct": correct, "attempted": out["steps"], "failed": 0}
    if traced:
        window = out["feed"].window
        metrics = per_layer(cell, out)
        device["busy_s"] = window.busy_s
        device["window_s"] = window.window_s
        result["breakdown"] = {"device_ops": window.top_ops(10),
                               "idle_gaps": window.idle_gaps(10)}
    else:
        metrics = out["e2e"]
    result["metrics"] = {k: {"value": v, "unit": units[k]}
                         for k, v in metrics.items()}
    result["device"] = device
    result["checks"] = shown
    return result


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


if __name__ == "__main__":
    sys.exit(main())
