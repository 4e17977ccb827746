"""Settle whether a CoCLR drive's retrieval collapse comes from the port:
reproduce it over seeds on the card and read the collapsed checkpoint.

    python tests/torch_collapse_probe.py --out <dir> [--seeds 1 3 4] \\
        [--workroot <new dir>] [drive flags]

runs `drive_coclr_cycle --skip_downstream` for every seed at once (each in
its own workdir <workroot>/cp<seed>; by default the workroot is a new
directory under the temporary directory, removed at the end; a given one
must hold no cp<seed> yet, so that no drive resumes from another run's
logs and checkpoints; the drives are host-bound, so they share the card,
the probe seed's at the host's first priority). The
drive is deterministic on the card for a given seed, so the probe seed's
phases are the ones a drive of that seed gives alone. Once the probe
seed's (the first of --seeds) inits exist, with that seed's training
draws (`--seed`):

- `epochs`: its Cycle-1 FlowMining again, one epoch a process (`--epochs
  1`, then `--resume epoch<e-1>.pth.tar --epochs e + 1`), a retrieval and
  its feature health after each epoch, so the epoch where the hub share
  jumps shows;
- `fp32`: the same FlowMining from the same inits with `--compute_dtype
  float32`, then its retrieval;

and once the drive's own Cycle-1 FlowMining has finished, on its
checkpoint (the one whose RGB retrieval a collapse shows in):
`modes`, the BatchNorm running statistics against its init's, and its
features in eval mode (running statistics) and in train mode (batch
statistics), each in bfloat16 and float32, with their health and R@k; and
`export`, the checkpoint cut to about 53 MiB so that it travels off the
card's machine (`flowmining_state.pt`: encoder_q in float32, the sampler
in bfloat16, the queues), for the comparison with the JAX package on the
CPU (tests/torch_collapse_parity.py), beside its retrieval's feature
cache.
A retrieval counts as collapsed where its features are not finite, its hub
share is above 0.5 or its R@50 below 1.

Everything it learns goes to <out>/collapse_probe.json (rewritten after
each step), the probe's logs to <out>/logs, and each drive's logs and
report to <out>/seed<seed>.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from coclr_tpu_torch.tools import drive_coclr_cycle as drive  # noqa: E402

HUB_LIMIT = 0.5
# the probe's own FlowMining runs: prefixes that no drive prefix globs
# (drive.latest_ckpt takes log-<prefix>*)
EPOCHS_PREFIX, FP32_PREFIX = "ep_cf", "fp32_cf"


def collapsed(phase) -> bool:
    """A retrieval collapsed: non-finite features, a hub share above 0.5,
    or R@50 below 1."""
    h = phase.get("features") or {}
    return (phase.get("nonfinite_features", False)
            or (h.get("hub_share") or 0.0) > HUB_LIMIT
            or phase.get("R@50", 1.0) < 1.0)


def workdir_of(out_workroot, seed):
    return os.path.join(out_workroot, f"cp{seed}")


class Record:
    """The probe's JSON record, begun empty and written whole after every
    update."""

    def __init__(self, path):
        self.path = path
        self.data = {}
        self.lock = threading.Lock()

    def put(self, key, value):
        with self.lock:
            self.data[key] = value
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.data, f, indent=1)
            os.replace(tmp, self.path)


def meta_root(wd):
    """The split-metadata root the drive in `wd` made (COCLR_META_ROOT)."""
    return os.path.join(wd, "meta_root")


def run_logged(argv, log, cwd):
    """A port CLI in a subprocess from the drive workdir `cwd` (the
    repository first on PYTHONPATH, the drive's split metadata), its output
    in `log`; raises on failure with the log's tail."""
    env = dict(os.environ, COCLR_META_ROOT=meta_root(cwd))
    env["PYTHONPATH"] = drive.REPO + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t0 = time.time()
    with open(log, "w") as f:
        p = subprocess.run([sys.executable] + argv, cwd=cwd, env=env,
                           stdout=f, stderr=subprocess.STDOUT)
    text = open(log).read()
    if p.returncode != 0:
        raise RuntimeError(f"{argv[:2]} failed (rc={p.returncode}):\n"
                           + text[-3000:])
    return text, time.time() - t0


def retrieve(args, wd, ckpt, dataset, feat_dir, log):
    """The drive's retrieval of `ckpt`: R@k, its feature health and the
    seconds it took."""
    text, wall = run_logged(
        drive.cli_argv("main_classifier",
                       drive.retrieval_args(args, os.path.join(wd, "data"),
                                            ckpt, dataset, feat_dir),
                       args.device), log, wd)
    return {**drive.parse_retrieval(text), **drive.feature_marks(feat_dir),
            "wall_s": round(wall, 2)}


def flowmining_argv(args, wd, prefix, rgb_init, flow_init, epochs,
                    extra=()):
    """main_coclr's Cycle-1 FlowMining flags as the drive gives them."""
    return drive.cli_argv(
        "main_coclr",
        ["--topk", "5", "--dataset", "ucf101-2stream-2clip",
         "--epochs", str(epochs), "--name_prefix", "Cycle1-FlowMining_",
         "--prefix", prefix, "--pretrain", rgb_init, flow_init, *extra,
         *drive.common_args(args, os.path.join(wd, "data"))], args.device)


def inits(wd):
    return (drive.latest_ckpt(wd, "cyc_nce_rgb"),
            drive.latest_ckpt(wd, "cyc_nce_flow"))


def probe_epochs(args, wd, rec, logs):
    """FlowMining one epoch a process, a retrieval after each epoch."""
    rgb_init, flow_init = inits(wd)
    prefix = EPOCHS_PREFIX
    out = []
    prev = None
    for e in range(args.epochs_coclr):
        extra = ["--resume", prev] if prev else []
        text, wall = run_logged(
            flowmining_argv(args, wd, prefix, rgb_init, flow_init, e + 1,
                            extra), os.path.join(logs, f"epochs_train{e}.log"),
            wd)
        ep = drive.parse_epochs(text)
        prev = drive.latest_ckpt(wd, prefix)
        r = retrieve(args, wd, prev, "ucf101",
                     os.path.join(wd, f"feat_ep{e}"),
                     os.path.join(logs, f"epochs_retrieval{e}.log"))
        out.append({"epoch": e, "ckpt": os.path.basename(prev),
                    "train": ep[-1] if ep else None,
                    "train_wall_s": round(wall, 2), **r})
        rec.put("epochs", out)


def probe_fp32(args, wd, rec, logs):
    """FlowMining from the same inits in float32, then its retrieval."""
    rgb_init, flow_init = inits(wd)
    prefix = FP32_PREFIX
    text, wall = run_logged(
        flowmining_argv(args, wd, prefix, rgb_init, flow_init,
                        args.epochs_coclr, ["--compute_dtype", "float32"]),
        os.path.join(logs, "fp32_train.log"), wd)
    ckpt = drive.latest_ckpt(wd, prefix)
    r = retrieve(args, wd, ckpt, "ucf101", os.path.join(wd, "feat_fp32"),
                 os.path.join(logs, "fp32_retrieval.log"))
    res = {"epochs": drive.parse_epochs(text), "train_wall_s": round(wall, 2),
           "ckpt": ckpt, **r}
    rec.put("fp32", res)


def bn_ranges(path):
    """The ranges of encoder_q's BatchNorm running statistics in a
    checkpoint: per layer and over all layers, with the largest
    |mean| / std (how far the folded affine's offset cancels its scale)."""
    import torch

    from coclr_tpu_torch.utils.checkpoint import load_checkpoint

    sd = load_checkpoint(path)["state_dict"]
    layers = {}
    for key, var in sd.items():
        if key.startswith("encoder_q.") and key.endswith(".running_var"):
            mean = sd[key[:-len("running_var")] + "running_mean"]
            ratio = mean.abs() / torch.sqrt(var + 1e-5)
            layers[key[len("encoder_q."):-len(".running_var")]] = {
                "var_min": float(var.min()), "var_max": float(var.max()),
                "mean_min": float(mean.min()), "mean_max": float(mean.max()),
                "mean_over_std_max": float(ratio.max())}
    vals = list(layers.values())
    return {"layers": len(vals),
            "var_min": min(v["var_min"] for v in vals),
            "var_max": max(v["var_max"] for v in vals),
            "mean_min": min(v["mean_min"] for v in vals),
            "mean_max": max(v["mean_max"] for v in vals),
            "mean_over_std_max": max(v["mean_over_std_max"] for v in vals),
            "per_layer": layers}


def mode_features(args, wd, ckpt, dataset):
    """Features of `ckpt` on the drive's splits with the backbone's
    BatchNorm in eval mode (running statistics) and in train mode (the
    batch statistics of each 32-clip batch), each in bfloat16 and float32:
    R@k and feature health of each, as the drive's retrieval computes
    them."""
    import torch

    from coclr_tpu_torch import main_classifier
    from coclr_tpu_torch.data import hostaug
    from coclr_tpu_torch.evalsuite import driver, retrieval
    from coclr_tpu_torch.evalsuite.feature_health import feature_health
    from coclr_tpu_torch.ops.augment import (apply_eval_jitter,
                                             draw_eval_jitter_params)
    from coclr_tpu_torch.parallel.train_step import to_ncdhw
    from coclr_tpu_torch.utils import prepare_run

    device = prepare_run(args.device)
    data_root = os.path.join(wd, "data")
    os.environ["COCLR_META_ROOT"] = meta_root(wd)
    out = {}
    datasets = None
    for dtype in ("bfloat16", "float32"):
        cfg = main_classifier.cfg_from_args(main_classifier.parse_args(
            drive.retrieval_args(args, data_root, ckpt, dataset, "unused")
            + ["--compute_dtype", dtype]))
        if datasets is None:
            policy = hostaug.EvalClipPolicy(img_dim=cfg.img_dim, mode="test",
                                            crop_where=5)
            datasets = {split: driver.build_eval_dataset(cfg, split,
                                                         policy=policy)
                        for split in ("train", "test")}
        base = driver.load_pretrained_backbone(driver.build_model(cfg), ckpt)
        for bn in ("eval", "train"):
            model = copy.deepcopy(base).to(device)
            feats = {}
            for split, ds in datasets.items():
                gen = torch.Generator(device).manual_seed(0)
                # the probe's head pins its backbone to eval mode; set it
                model.eval()
                model.backbone.train(bn == "train")

                @torch.no_grad()
                def fn(clips, model=model, gen=gen, cfg=cfg):
                    p = draw_eval_jitter_params(gen, clips.shape[0],
                                                **retrieval.EXTRACT_JITTER)
                    x = apply_eval_jitter(clips, p, cfg.dtype)
                    return model(to_ncdhw(x))[1]

                feats[split] = retrieval.video_means(
                    fn, ds, retrieval.CLIP_BATCH, cfg.workers, device)[0]
            labels = {split: [ds.encode_action(ds.video_subset.iloc[i][2])
                              for i in range(len(ds))]
                      for split, ds in datasets.items()}
            rk = retrieval.nn_retrieval(feats["test"], labels["test"],
                                        feats["train"], labels["train"],
                                        device=device)
            out[f"{bn}_{dtype}"] = {
                **{f"R@{k}": v for k, v in rk.items()},
                "features": feature_health(feats["train"], feats["test"])}
            del model
    return out


def export(ckpt, out_path, moco_k, moco_dim=128):
    """`ckpt` (a CoCLR checkpoint of the port) cut to about 53 MiB for the
    comparison on another machine: encoder_q in float32 (each tensor
    once), the sampler in bfloat16, the queues and the pointer; encoder_k
    is left out (its EMA lags encoder_q)."""
    import torch

    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  load_reference_state_dict)

    model = MoCo("s3d", moco_dim, moco_k, torch.float32, variant="coclr")
    load_reference_state_dict(model, load_checkpoint(ckpt)["state_dict"])
    sampler = copy.deepcopy(model.sampler).to(torch.bfloat16)
    payload = {"source": os.path.basename(ckpt),
               "encoder_q": model.encoder_q.state_dict(),
               "sampler_bf16": sampler.state_dict(),
               "buffers": {k: getattr(model, k).clone() for k in
                           ("queue", "queue_ptr", "queue_label",
                            "queue_vname", "queue_second")}}
    torch.save(payload, out_path)
    return os.path.getsize(out_path)


def wait_for(path, marker, proc, poll=15):
    """Wait until `path` holds `marker`; False if `proc` ended first
    without it."""
    while True:
        if os.path.exists(path) and marker in open(path).read():
            return True
        if proc is not None and proc.poll() is not None:
            return os.path.exists(path) and marker in open(path).read()
        time.sleep(poll)


def build_parser():
    ap = drive.build_parser()
    ap.set_defaults(epochs_nce=12, epochs_coclr=6, moco_k=128, n_classes=4,
                    n_groups=24, n_clips=6, test_groups=3, cycles=2)
    ap.add_argument("--out", required=True,
                    help="directory of collapse_probe.json and the logs")
    ap.add_argument("--seeds", nargs="+", type=int, default=[1, 3, 4],
                    help="a drive for each; the first is the probe seed")
    ap.add_argument("--workroot", default=None,
                    help="each seed's drive runs in <workroot>/cp<seed>, "
                    "which must not exist yet (default: a new temporary "
                    "directory, removed at the end)")
    return ap


def make_workroot(args):
    """The directory of the drives' workdirs: a new temporary one (removed
    by main at the end) unless --workroot names one, which then must hold
    no workdir of these seeds (a drive there would resume from another
    run's logs, and the probe read its checkpoints). Returns whether the
    probe made it."""
    if args.workroot is None:
        args.workroot = tempfile.mkdtemp(prefix="collapse_probe_")
        return True
    taken = [workdir_of(args.workroot, s) for s in args.seeds
             if os.path.exists(workdir_of(args.workroot, s))]
    if taken:
        raise SystemExit(f"collapse_probe: {taken} exist already; give a "
                         "new --workroot or none")
    return False


def probe_args(args):
    """The flags of the probe's own runs: the probe seed's drive seed (the
    first of --seeds), so that they draw as that drive's phases do."""
    pargs = copy.copy(args)
    pargs.seed = args.seeds[0]
    return pargs


def drive_argv(args, seed):
    return ["-m", "coclr_tpu_torch.tools.drive_coclr_cycle",
            "--workdir", workdir_of(args.workroot, seed),
            "--epochs_nce", str(args.epochs_nce),
            "--epochs_coclr", str(args.epochs_coclr),
            "--moco_k", str(args.moco_k), "--n_classes", str(args.n_classes),
            "--n_groups", str(args.n_groups), "--n_clips", str(args.n_clips),
            "--test_groups", str(args.test_groups),
            "--cycles", str(args.cycles), "--workers", str(args.workers),
            "--seq_len", str(args.seq_len), "--img_dim", str(args.img_dim),
            "--batch_size", str(args.batch_size),
            "--seed", str(seed), "--skip_downstream", "--device", args.device,
            "--out_prefix", f"DRIVE_coclr_cycle_seed{seed}"]


def main(argv=None):
    args = build_parser().parse_args(argv)
    made = make_workroot(args)
    os.makedirs(args.out, exist_ok=True)
    logs = os.path.join(args.out, "logs")
    os.makedirs(logs, exist_ok=True)
    rec = Record(os.path.join(args.out, "collapse_probe.json"))
    rec.put("card", drive.card_name(args.device))
    t0 = time.time()
    pargs = probe_args(args)
    env = dict(os.environ)
    env["PYTHONPATH"] = drive.REPO + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = {}
    for seed in args.seeds:
        os.makedirs(workdir_of(args.workroot, seed), exist_ok=True)
        f = open(os.path.join(logs, f"drive_seed{seed}.out"), "w")
        # the probe seed's chain first: the other drives yield the host
        nice = 0 if seed == pargs.seed else 10
        procs[seed] = subprocess.Popen(
            [sys.executable] + drive_argv(args, seed), env=env, stdout=f,
            stderr=subprocess.STDOUT, preexec_fn=lambda n=nice: os.nice(n))
    errors = {}

    def guarded(name, fn, *a):
        try:
            t = time.time()
            fn(*a)
            rec.put(f"{name}_wall_s", round(time.time() - t, 2))
        except Exception as e:  # recorded, and the run goes on
            errors[name] = repr(e)[-3000:]
            rec.put("errors", errors)

    wd = workdir_of(args.workroot, pargs.seed)
    proc = procs[pargs.seed]

    def read_flowmining():
        """modes and export of the drive's Cycle-1 FlowMining checkpoint."""
        ckpt = drive.latest_ckpt(wd, "cyc_cf")
        rec.put("modes", {"seed": pargs.seed, "ckpt": ckpt,
                          "bn": bn_ranges(ckpt),
                          "bn_init": bn_ranges(inits(wd)[0])})
        rec.put("modes", {**rec.data["modes"],
                          **mode_features(pargs, wd, ckpt, "ucf101")})
        rec.put("export_bytes", export(
            ckpt, os.path.join(args.out, "flowmining_state.pt"),
            args.moco_k))

    threads = []

    def start(name, fn, *a):
        th = threading.Thread(target=guarded, args=(name, fn, *a))
        th.start()
        threads.append(th)

    if wait_for(
            os.path.join(wd, "drivelogs", "nce_flow.log"), "finished", proc):
        start("epochs", probe_epochs, pargs, wd, rec, logs)
        start("fp32", probe_fp32, pargs, wd, rec, logs)
    if wait_for(
            os.path.join(wd, "drivelogs", "coclr_flowmining.log"),
            "finished", proc):
        start("read", read_flowmining)
    drives = {}
    for seed, p in procs.items():
        rc = p.wait()
        path = os.path.join(workdir_of(args.workroot, seed),
                            f"DRIVE_coclr_cycle_seed{seed}.json")
        report = json.load(open(path)) if os.path.exists(path) else {}
        phases = report.get("phases", {})
        keep = os.path.join(args.out, f"seed{seed}")
        for name in ("drivelogs", f"DRIVE_coclr_cycle_seed{seed}.json",
                     f"DRIVE_coclr_cycle_seed{seed}.md"):
            src = os.path.join(workdir_of(args.workroot, seed), name)
            if os.path.isdir(src):
                shutil.copytree(src, os.path.join(keep, name),
                                dirs_exist_ok=True)
            elif os.path.exists(src):
                os.makedirs(keep, exist_ok=True)
                shutil.copy(src, keep)
        retr = [t for t in phases if t.startswith("retrieval_")]
        drives[seed] = {"rc": rc, "total_wall_min":
                        report.get("total_wall_min"),
                        "collapsed": [t for t in retr
                                      if collapsed(phases[t])],
                        "r50_below_1": [t for t in retr
                                        if phases[t].get("R@50", 1.0) < 1.0],
                        "phases": phases}
        rec.put("drives", drives)
    rec.put("collapse_count", {
        "seeds": sorted(drives),
        "collapsed_seeds": sorted(s for s, d in drives.items()
                                  if d["collapsed"]),
        "r50_below_1_seeds": sorted(s for s, d in drives.items()
                                    if d["r50_below_1"])})
    feat = os.path.join(wd, "feat_retrieval_rgb_coclr")
    if os.path.isdir(feat):
        shutil.copytree(feat, os.path.join(args.out, "feat_flowmining"),
                        dirs_exist_ok=True)
    for th in threads:
        th.join()
    if made:
        shutil.rmtree(args.workroot, ignore_errors=True)
    rec.put("wall_min", round((time.time() - t0) / 60, 2))
    print(json.dumps({k: v for k, v in rec.data.items()
                      if k in ("card", "collapse_count", "errors",
                               "wall_min")}), flush=True)


if __name__ == "__main__":
    main()
