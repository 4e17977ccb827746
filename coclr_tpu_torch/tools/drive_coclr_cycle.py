"""One full CoCLR cycle drive through the port's CLIs, the counterpart of
tools/drive_coclr_cycle.py:

    python -m coclr_tpu_torch.tools.drive_coclr_cycle --workdir /tmp/cyc \\
        [--epochs_nce 18] [--epochs_coclr 12] [--seq_len 32] [--img_dim 128]

Scripted version of the reference's training recipe (the reference
README.md:28-56): two InfoNCE inits (RGB + Flow) -> CycleN-FlowMining
(CoCLR trains RGB with the flow sampler) -> CycleN-RGBMining (--reverse:
trains Flow with the mined-RGB sampler) -> NN retrieval before and after
for both modalities -> the downstream chain (linear probe or finetune,
ten-crop TTA, two-stream fusion, the feature probe). Every stage runs as
`python -m coclr_tpu_torch.{main_nce, main_coclr, main_classifier,
merge_2stream_prob, feature_linear_probe}` in a subprocess with
cwd=--workdir, exercising the queue-fill gate, the two-checkpoint surgery
chained across phases, and the --reverse path end to end.

Data: the learnable synthetic UCF (class-coded drift-speed gratings,
coclr_tpu_torch/data/synthetic.py) whose flow modality shares the class
code (the CoCLR mining premise), so retrieval and sampling accuracies are
learning signals, not just plumbing checks.

Flags, defaults, the phase graph and the printed grammar are the JAX
drive's. Where the port differs:
- `--device {cuda,cpu}` (default cuda) goes to every CLI; without CUDA the
  drive raises unless it is given `--device cpu`, and on the CPU the
  training and eval CLIs also get `--compute_dtype float32`. A failing
  phase stops the drive with its log tail; nothing reruns on another
  device.
- Checkpoints are the port's `epoch<N>.pth.tar` / `model_best_*.pth.tar`
  (never `preempt.pth.tar`).
- The report `<out_prefix>.json` (and the summarizer's `.md`) goes under
  --workdir unless --out_prefix is absolute; its `config` names the card
  (`nvidia-smi --query-gpu=name,power.limit`, or "cpu"), and each phase
  run in this launch has its subprocess's seconds (`wall_s`) beside
  `wall_min`.
- Each retrieval phase also carries `features`, the health of the
  features it cached in <workdir>/feat_<tag> (evalsuite/feature_health.py:
  the non-finite count, the per-dimension std after centering, the
  effective rank, the hub share), and `nonfinite_features: true` where any
  value is not finite: its R@k then means nothing.

The drive resumes: a phase whose saved log (<workdir>/drivelogs/<tag>.log)
shows completion is skipped, so an interrupted run relaunches cheaply.
Keep --workdir short: the classifier's experiment directory embeds the
pretrained checkpoint's path in one file name component.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXT = ".pth.tar"

# progress-meter lines: "Epoch:[3][0/17]  Time ...  Loss 4.1 (4.3)  acc@1
# 0.50 (0.48) ..." — parenthesized values are the epoch running averages
# \s* : progress lines right-align the step ("[  0/287]") — without it the
# early-epoch lines are silently dropped
EPOCH_RE = re.compile(r"Epoch:\[(\d+)\]\[\s*\d+/\d+\].*?Loss [\d.]+ "
                      r"\(([\d.]+)\).*?acc@1 [\d.]+ \(([\d.]+)\)")
# CoCLR phases additionally log the running self-positive accuracy; shared
# with summarize_coclr_drive so the two parsers cannot drift
SELF_RE = re.compile(r"Epoch:\[(\d+)\]\[\s*\d+/\d+\].*?Self-acc@1 [\d.]+ "
                     r"\(([\d.]+)\)")
NN_RE = re.compile(r"(\d+)NN acc = ([\d.]+)")


def run_cli(tag, args_list, cwd, log_dir, done_marker=None, validate=None,
            partial_ok=None):
    os.makedirs(log_dir, exist_ok=True)
    log_file = os.path.join(log_dir, f"{tag}.log")
    # resume: a phase whose saved log already shows completion is not rerun
    # (the log is the record of what actually ran). `validate` guards
    # against degenerate completions: a 0-video run still prints "finished"
    # with zero progress lines, and must rerun. `partial_ok(prev)`: accept
    # an unfinished log too (wall-clock-bounded drives: an init cut after N
    # full epochs is still a valid init; the report gives the epochs that
    # actually ran).
    if done_marker and os.path.exists(log_file):
        prev = open(log_file).read()
        if done_marker in prev and (validate is None or validate(prev)):
            print(f"[drive] {tag}: already complete, skipping", flush=True)
            return prev, None
        if partial_ok is not None and partial_ok(prev):
            print(f"[drive] {tag}: accepting partial run (wall-clock cut); "
                  "the artifact reports the epochs that actually ran",
                  flush=True)
            return prev, None
    print(f"[drive] {tag}: {' '.join(args_list)}", flush=True)
    t0 = time.time()
    # prepend the repository to PYTHONPATH (so `-m coclr_tpu_torch...`
    # resolves from any cwd); replacing it would drop site hooks
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with open(log_file, "w") as f:
        p = subprocess.run([sys.executable] + args_list, cwd=cwd, env=env,
                           stdout=f, stderr=subprocess.STDOUT)
    wall = time.time() - t0
    text = open(log_file).read()
    if p.returncode != 0:
        print(text[-4000:], flush=True)
        raise RuntimeError(f"{tag} failed (rc={p.returncode}); log {log_file}")
    if validate is not None and not validate(text):
        # a 0-video join (stale workdir data, wrong split metadata) exits 0
        # and prints "finished" after 0-step epochs: a failure, not a result
        print(text[-2000:], flush=True)
        raise RuntimeError(
            f"{tag} completed degenerately (0 progress lines); stale "
            f"workdir data or wrong split metadata? log {log_file}")
    print(f"[drive] {tag} done in {wall/60:.1f} min", flush=True)
    return text, wall


def parse_epochs(text):
    """Last (= epoch-average) Loss/acc@1 of each epoch's progress lines."""
    per = {}
    for e, l, a in EPOCH_RE.findall(text):
        per[int(e)] = {"epoch": int(e), "loss": float(l), "acc1": float(a)}
    return [per[k] for k in sorted(per)]


def parse_retrieval(text):
    return {f"R@{k}": float(v) for k, v in NN_RE.findall(text)}


def feature_marks(feat_dir):
    """The report keys of the features a retrieval cached in `feat_dir`
    (the drive gives each retrieval its own): {'features': their health}
    and, where any value is not finite, 'nonfinite_features': True (the
    phase's R@k then means nothing); {} where the directory holds no
    cache."""
    from coclr_tpu_torch.evalsuite.feature_health import cache_health

    found = cache_health(feat_dir)
    if not found:
        return {}
    health = found[0]
    marks = {"features": health}
    if not health["finite"]:
        marks["nonfinite_features"] = True
    return marks


def seed_report(out_path, args_dict):
    """Start the incremental report from the existing artifact, if any.

    A relaunch into the same workdir (e.g. extending --cycles) must not
    wipe fields that resumed phases cannot reconstruct from logs (wall_min
    and the accumulated total_wall_min). Config reflects the CURRENT
    launch; returns (report, prior_total_wall_min).
    """
    report = {"config": args_dict, "phases": {}}
    prior_wall_min = 0.0
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                old = json.load(f)
            report["phases"] = old.get("phases", {})
            prior_wall_min = float(old.get("total_wall_min") or 0.0)
        except (ValueError, OSError):
            pass
    return report, prior_wall_min


def model_ckpts(pattern, name):
    """Checkpoints `name` (a glob: 'epoch*' or 'model_best_*') in the
    `model/` directories under `pattern`, at any depth; never
    preempt.pth.tar."""
    found = glob.glob(os.path.join(pattern, "*", "model", name + EXT))
    found += glob.glob(os.path.join(pattern, "**", "model", name + EXT),
                       recursive=True)
    return sorted(set(found))


def latest_ckpt(workdir, prefix):
    pats = model_ckpts(os.path.join(workdir, f"log-{prefix}*"), "epoch*")
    if not pats:
        raise RuntimeError(f"no checkpoint under {workdir}/log-{prefix}*")

    # most-recently-written, NOT max epoch number: a relaunch with fewer
    # epochs must not pick up a stale higher-epoch ckpt from an aborted
    # earlier launch that shares the exp dir
    return max(pats, key=os.path.getmtime)


def checkpoint_chain(workdir, cycle=1):
    """The two-checkpoint surgery of cycle `cycle`, read back from its
    files: FlowMining's sampler is the flow checkpoint it was given and
    its encoder_q moved off the RGB one; RGBMining's (--reverse) sampler is
    FlowMining's encoder_q and its encoder_q moved off the flow one.
    Returns {check: bool} and the checkpoints read."""
    from coclr_tpu_torch.utils.checkpoint import load_checkpoint

    def prefix(c, kind):  # the drive's --prefix of cycle c's phases
        return f"cyc_{kind}" if c == 1 else f"cyc{c}_{kind}"

    before = ((prefix(cycle - 1, "cf"), prefix(cycle - 1, "cr")) if cycle > 1
              else ("cyc_nce_rgb", "cyc_nce_flow"))
    paths = {name: latest_ckpt(workdir, p) for name, p in
             (("rgb_in", before[0]), ("flow_in", before[1]),
              ("flowmining", prefix(cycle, "cf")),
              ("rgbmining", prefix(cycle, "cr")))}
    sd = {name: load_checkpoint(p)["state_dict"] for name, p in paths.items()}

    def part(state, prefix):
        return {k[len(prefix):]: v for k, v in state.items()
                if k.startswith(prefix)}

    def same(a, b):
        return a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and bool((a[k] == b[k]).all())
            for k in a)

    def moved(a, b):
        return a.keys() == b.keys() and not same(a, b)

    q = {name: part(s, "encoder_q.") for name, s in sd.items()}
    checks = {
        "flowmining_sampler_is_flow_in": same(
            part(sd["flowmining"], "sampler."), q["flow_in"]),
        "flowmining_encoder_q_moved_off_rgb_in": moved(
            q["flowmining"], q["rgb_in"]),
        "rgbmining_sampler_is_flowmining": same(
            part(sd["rgbmining"], "sampler."), q["flowmining"]),
        "rgbmining_encoder_q_moved_off_flow_in": moved(
            q["rgbmining"], q["flow_in"]),
    }
    return checks, paths


def report_path(workdir, out_prefix, ext=".json"):
    """<out_prefix><ext> under the workdir (an absolute prefix stays)."""
    return os.path.join(os.path.abspath(workdir), out_prefix + ext)


def card_name(device):
    """`name, power limit` of the card as nvidia-smi gives them, or 'cpu'."""
    if device == "cpu":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown card"


def cli_argv(module, argv, device, dtype=True):
    """`python` arguments of the port's CLI `module` on `device`: every CLI
    runs there, and on the CPU (where `dtype`) in float32, as the
    repository holds the port there."""
    return (["-m", f"coclr_tpu_torch.{module}", *argv]
            + (["--compute_dtype", "float32"] if dtype and device == "cpu"
               else []) + ["--device", device])


def common_args(args, data_root):
    """The flags every pretraining phase of the drive shares."""
    return ["--net", "s3d", "--moco-k", str(args.moco_k),
            "--seq_len", str(args.seq_len), "--ds", "1",
            "--batch_size", str(args.batch_size),
            "--img_dim", str(args.img_dim), "-j", str(args.workers),
            "--data_root", data_root, "--save_freq", "2",
            "--seed", str(args.seed),
            "--num_devices", str(args.num_devices)]


def retrieval_args(args, data_root, ckpt, dataset, feat_dir):
    """main_classifier's flags for the retrieval of `ckpt` on `dataset`,
    its features cached in `feat_dir`."""
    return ["--net", "s3d", "--dataset", dataset,
            "--max_windows", str(args.retrieval_max_windows),
            "--seq_len", str(args.seq_len), "--ds", "1",
            "--img_dim", str(args.img_dim),
            "--batch_size", str(args.batch_size),
            "--data_root", data_root, "-j", str(args.workers),
            "--num_devices", str(args.num_devices),
            "--test", ckpt, "--retrieval", "--dirname", feat_dir]


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/coclr_cycle")
    ap.add_argument("--epochs_nce", default=18, type=int)
    ap.add_argument("--epochs_nce_flow", default=0, type=int,
                    help="flow-init epochs (0 = same as --epochs_nce)")
    ap.add_argument("--epochs_coclr", default=12, type=int)
    ap.add_argument("--seq_len", default=32, type=int)
    ap.add_argument("--img_dim", default=128, type=int)
    ap.add_argument("--batch_size", default=32, type=int)
    ap.add_argument("--moco_k", default=2048, type=int)
    ap.add_argument("--n_classes", default=4, type=int)
    ap.add_argument("--n_groups", default=24, type=int)
    ap.add_argument("--n_clips", default=6, type=int)
    ap.add_argument("--test_groups", default=1, type=int,
                    help="held-out groups in the synthetic split; >1 widens "
                         "the retrieval query set (n_classes*test_groups*"
                         "n_clips queries) at zero training cost")
    ap.add_argument("--workers", default=8, type=int)
    ap.add_argument("--epochs_probe", default=10, type=int)
    ap.add_argument("--cycles", default=1, type=int,
                    help="mining cycles: each runs FlowMining then RGBMining"
                         " --reverse from the latest checkpoints, then both "
                         "retrievals (the reference's published checkpoints "
                         "keep cycling, README.md:148-161)")
    ap.add_argument("--seed", default=0, type=int,
                    help="synthetic-data AND training seed; a drive at a "
                         "different seed is an independent replication")
    ap.add_argument("--out_prefix", default="DRIVE_coclr_cycle",
                    help="basename of the <prefix>.json/.md report under "
                         "--workdir (absolute: that path)")
    ap.add_argument("--short_frac", default=0.0, type=float,
                    help="fraction of train clips rendered too short, to "
                         "exercise the reference drop-short filter at scale "
                         "(lmdb_dataset.py:84-108); test split unaffected")
    ap.add_argument("--downstream_train_what", default="last",
                    choices=["last", "ft"],
                    help="downstream classifier mode: 'last' = frozen-"
                         "backbone linear probe; 'ft' = the reference's "
                         "headline finetune recipe (backbone at lr/10)")
    ap.add_argument("--tta_max_windows", default=0, type=int,
                    help=">0: ten-crop TTA decodes only the center N hop "
                         "windows per video (eval --max_windows)")
    ap.add_argument("--schedule_nce", default=[], nargs="*", type=int,
                    help="LR decay milestones for the nce_rgb init phase "
                         "(reference drops x0.1 at 250/280 of 300 epochs, "
                         "README.md:28-32; scale to the drive's epochs)")
    ap.add_argument("--retrieval_last_cycle_only", action="store_true",
                    help="run per-cycle retrievals only after the LAST "
                         "cycle")
    ap.add_argument("--skip_tta", action="store_true",
                    help="downstream: run the classifiers but skip the "
                         "ten-crop TTA + fusion (about 10 test-set passes)")
    ap.add_argument("--skip_downstream", action="store_true",
                    help="stop after the post-cycle retrievals")
    ap.add_argument("--retrieval_max_windows", default=0, type=int,
                    help=">0: retrieval features use only the CENTER N hop "
                         "windows per video (eval --max_windows); same "
                         "setting on both sides of every init-vs-mined "
                         "comparison")
    ap.add_argument("--accept_partial_nce", action="store_true",
                    help="on restart, accept an UNfinished NCE init whose "
                         "log shows >=1 full epoch and a saved checkpoint "
                         "instead of rerunning it")
    ap.add_argument("--priority", default="", choices=["", "rgb"],
                    help="'rgb': wall-clock-bounded phase order: complete "
                         "the RGB evidence chain (flowmining -> rgb init + "
                         "post-mining retrievals) BEFORE the flow-side "
                         "phases (cycles=1 only)")
    ap.add_argument("--num_devices", default=0, type=int,
                    help="passed through to the training and eval CLIs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every CLI runs: cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from coclr_tpu_torch.utils import resolve_device

    resolve_device(args.device)  # raises when CUDA is asked for and missing

    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    data_root = os.path.join(wd, "data")
    db = os.path.join(data_root, "UCF101", "ucf101_frame.lmdb")
    dbf = os.path.join(data_root, "UCF101", "ucf101_tvl1_frame.lmdb")

    if not (os.path.exists(db) and os.path.exists(dbf)):
        from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

        print("[drive] staging learnable synthetic UCF...", flush=True)
        out = make_synthetic_ucf(
            os.path.join(wd, "gen"), n_classes=args.n_classes,
            n_groups=args.n_groups, n_clips=args.n_clips,
            n_frames=args.seq_len + 16, size=(136, 180), flow=True,
            content="learnable", seed=args.seed,
            test_groups=args.test_groups, in_memory=True,
            short_frac=args.short_frac, progress=True)
        os.makedirs(os.path.dirname(db), exist_ok=True)
        os.replace(out["db_path"], db)
        os.replace(out["db_path_flow"], dbf)
        print(f"[drive] staged at {data_root}", flush=True)

    # per-drive split-metadata root (COCLR_META_ROOT, inherited by every
    # child CLI through run_cli's environment), never a global link
    meta_dir = os.path.join(wd, "gen", "meta")
    meta_root = os.path.join(wd, "meta_root")
    if os.path.isdir(meta_dir):
        os.makedirs(meta_root, exist_ok=True)
        meta_link = os.path.join(meta_root, "ucf101")
        if os.path.islink(meta_link):
            os.unlink(meta_link)
        if not os.path.exists(meta_link):
            os.symlink(meta_dir, meta_link)
    os.environ["COCLR_META_ROOT"] = meta_root

    def cli(module, *argv, dtype=True):
        return cli_argv(module, argv, args.device, dtype)

    common = common_args(args, data_root)
    log_dir = os.path.join(wd, "drivelogs")
    out_path = report_path(wd, args.out_prefix)
    report, prior_wall_min = seed_report(
        out_path, dict(vars(args), card=card_name(args.device)))

    def dump_report():
        # incremental: a drive cut by the clock still leaves the finished
        # phases' results on disk for the summarizer
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)

    def phase(tag, module, extra, prefix=None):
        # accept_partial_nce: a cut init with >=1 FULL epoch in the log and
        # a saved checkpoint counts (checkpoints are written on save_freq
        # epoch boundaries, so latest_ckpt picks the matching weights)
        partial = None
        if args.accept_partial_nce and prefix is not None:
            def partial(prev, _p=prefix):
                # the checkpoint proves >=1 full epoch ran, but a stale one
                # can outlive a degenerate log (0-video join), so the
                # CURRENT log must also show progress lines
                return bool(parse_epochs(prev)) and bool(model_ckpts(
                    os.path.join(wd, f"log-{_p}*"), "epoch*"))
        text, wall = run_cli(tag, cli(module, *extra, *common), wd, log_dir,
                             done_marker="finished",
                             validate=lambda t: bool(parse_epochs(t)),
                             partial_ok=partial)
        # resumed phases merge into the prior artifact entry (preserving
        # the original launch's wall_min); re-run phases replace it
        ph = dict(report["phases"].get(tag, {})) if wall is None else {}
        ph["epochs"] = parse_epochs(text)
        if wall is None:
            ph["resumed"] = True
        else:
            ph["wall_min"] = round(wall / 60, 1)
            ph["wall_s"] = round(wall, 2)
        report["phases"][tag] = ph
        dump_report()
        return text

    def retrieval(tag, ckpt, dataset):
        feat_dir = os.path.join(wd, "feat_" + tag)
        text, wall = run_cli(
            tag, cli("main_classifier",
                     *retrieval_args(args, data_root, ckpt, dataset,
                                     feat_dir)),
            wd, log_dir, done_marker="NN acc")
        ph = dict(report["phases"].get(tag, {})) if wall is None else {}
        ph.update(parse_retrieval(text))
        ph.pop("nonfinite_features", None)
        ph.update(feature_marks(feat_dir))
        if ph.get("nonfinite_features"):
            print(f"[drive] {tag}: {ph['features']['nonfinite']} non-finite "
                  "feature values: its R@k means nothing", flush=True)
        if wall is None:
            ph["resumed"] = True
        else:
            ph["wall_min"] = round(wall / 60, 1)
            ph["wall_s"] = round(wall, 2)
        report["phases"][tag] = ph
        dump_report()

    def summarize():
        from coclr_tpu_torch.tools import summarize_coclr_drive

        summarize_coclr_drive.main(
            ["--workdir", wd, "--out_prefix", args.out_prefix,
             "--chance", str(round(1.0 / args.n_classes, 4))])

    t_start = time.time()
    # 1+2: InfoNCE inits (README.md:28-40)
    nce_rgb_extra = []
    if args.schedule_nce:
        nce_rgb_extra = ["--schedule"] + [str(s) for s in args.schedule_nce]
    phase("nce_rgb", "main_nce",
          ["--model", "infonce", "--dataset", "ucf101-2clip",
           "--epochs", str(args.epochs_nce), "--prefix", "cyc_nce_rgb"]
          + nce_rgb_extra,
          prefix="cyc_nce_rgb")
    rgb_init = latest_ckpt(wd, "cyc_nce_rgb")
    phase("nce_flow", "main_nce",
          ["--model", "infonce", "--dataset", "ucf101-f-2clip",
           "--epochs", str(args.epochs_nce_flow or args.epochs_nce),
           "--prefix", "cyc_nce_flow"],
          prefix="cyc_nce_flow")
    flow_init = latest_ckpt(wd, "cyc_nce_flow")

    if args.priority == "rgb":
        # wall-clock-bounded order: the phases whose results compose into
        # the RGB mining-effect claim first (flowmining, then rgb init +
        # post-mining retrievals), the flow-side phases after
        assert args.cycles == 1, "--priority rgb supports cycles=1"
        phase("coclr_flowmining", "main_coclr",
              ["--topk", "5", "--dataset", "ucf101-2stream-2clip",
               "--epochs", str(args.epochs_coclr),
               "--name_prefix", "Cycle1-FlowMining_",
               "--prefix", "cyc_cf",
               "--pretrain", rgb_init, flow_init])
        rgb_latest = latest_ckpt(wd, "cyc_cf")
        retrieval("retrieval_rgb_init", rgb_init, "ucf101")
        retrieval("retrieval_rgb_coclr", rgb_latest, "ucf101")
        phase("coclr_rgbmining", "main_coclr",
              ["--topk", "5", "--reverse",
               "--dataset", "ucf101-2stream-2clip",
               "--epochs", str(args.epochs_coclr),
               "--name_prefix", "Cycle1-RGBMining_",
               "--prefix", "cyc_cr",
               "--pretrain", flow_init, rgb_latest])
        flow_latest = latest_ckpt(wd, "cyc_cr")
        retrieval("retrieval_flow_init", flow_init, "ucf101-f")
        retrieval("retrieval_flow_coclr", flow_latest, "ucf101-f")
        # this branch returns before the downstream chain (the priority
        # order exists to bound wall-clock)
        report["total_wall_min"] = round(
            prior_wall_min + (time.time() - t_start) / 60, 1)
        report["chance_R@1"] = round(1.0 / args.n_classes, 4)
        dump_report()
        print(f"[drive] report -> {out_path}", flush=True)
        summarize()
        print(json.dumps(report, indent=1), flush=True)
        return

    retrieval("retrieval_rgb_init", rgb_init, "ucf101")
    retrieval("retrieval_flow_init", flow_init, "ucf101-f")

    # 3+4 (per cycle): CycleN-FlowMining trains RGB with the latest flow
    # sampler; CycleN-RGBMining (--reverse) trains Flow with the just-mined
    # RGB (README.md:42-56; published checkpoints keep cycling :148-161).
    # Cycle 1 keeps the tags and prefixes of the JAX drive's artifacts.
    rgb_latest, flow_latest = rgb_init, flow_init
    for cyc in range(1, args.cycles + 1):
        if cyc == 1:
            fm_tag, rm_tag = "coclr_flowmining", "coclr_rgbmining"
            fm_prefix, rm_prefix, retr = "cyc_cf", "cyc_cr", "coclr"
        else:
            fm_tag = f"cycle{cyc}_flowmining"
            rm_tag = f"cycle{cyc}_rgbmining"
            fm_prefix, rm_prefix = f"cyc{cyc}_cf", f"cyc{cyc}_cr"
            retr = f"cycle{cyc}"
        phase(fm_tag, "main_coclr",
              ["--topk", "5", "--dataset", "ucf101-2stream-2clip",
               "--epochs", str(args.epochs_coclr),
               "--name_prefix", f"Cycle{cyc}-FlowMining_",
               "--prefix", fm_prefix,
               "--pretrain", rgb_latest, flow_latest])
        rgb_latest = latest_ckpt(wd, fm_prefix)

        phase(rm_tag, "main_coclr",
              ["--topk", "5", "--reverse",
               "--dataset", "ucf101-2stream-2clip",
               "--epochs", str(args.epochs_coclr),
               "--name_prefix", f"Cycle{cyc}-RGBMining_",
               "--prefix", rm_prefix,
               "--pretrain", flow_latest, rgb_latest])
        flow_latest = latest_ckpt(wd, rm_prefix)

        if not args.retrieval_last_cycle_only or cyc == args.cycles:
            retrieval(f"retrieval_rgb_{retr}", rgb_latest, "ucf101")
            retrieval(f"retrieval_flow_{retr}", flow_latest, "ucf101-f")
    rgb_c1, flow_c1 = rgb_latest, flow_latest  # downstream: final ckpts

    # 5: the downstream chain on the cycle checkpoints: linear probe (or
    # finetune) + ten-crop TTA per modality, two-stream probability fusion,
    # feature-space probe on the cached retrieval features (reference
    # recipe README.md:92-127)
    if not args.skip_downstream:
        eval_common = ["--net", "s3d", "--seq_len", str(args.seq_len),
                       "--ds", "1", "--img_dim", str(args.img_dim),
                       "--batch_size", str(args.batch_size),
                       "--data_root", data_root, "-j", str(args.workers),
                       "--num_devices", str(args.num_devices)]
        prob_json = {}
        tw = args.downstream_train_what
        cls_prefix = "cycp" if tw == "last" else "cycft"
        for mod, ckpt, dataset in (("rgb", rgb_c1, "ucf101"),
                                   ("flow", flow_c1, "ucf101-f")):
            tag = (f"probe_{mod}_coclr" if tw == "last"
                   else f"finetune_{mod}_coclr")
            run_cli(tag, cli("main_classifier",
                             "--dataset", dataset, "--train_what", tw,
                             "--pretrain", ckpt,
                             "--epochs", str(args.epochs_probe),
                             "--prefix", f"{cls_prefix}_{mod}", *eval_common),
                    wd, log_dir,
                    done_marker=f"val epoch {args.epochs_probe - 1}:")
            exp = os.path.join(wd, f"log-eval-{cls_prefix}_{mod}")
            bests = glob.glob(os.path.join(exp, "*", "model",
                                           "model_best_*" + EXT))
            if not bests:
                # no epoch ever beat val top1 0.0 (possible at smoke scale)
                # -> no model_best was written; test the last epoch instead
                bests = glob.glob(os.path.join(exp, "*", "model",
                                               "epoch*" + EXT))
            if not bests:
                raise RuntimeError(f"no classifier ckpt for {mod}")
            best = max(bests, key=os.path.getmtime)
            if args.skip_tta:
                continue
            run_cli(tag + "_tencrop",
                    cli("main_classifier",
                        "--dataset", dataset, "--test", best, "--ten_crop",
                        # --train_what selects the head structure (final_bn
                        # / l2norm / dropout) the checkpoint was trained
                        # with (main_classifier.py:102-109)
                        "--train_what", tw,
                        "--max_windows", str(args.tta_max_windows),
                        *eval_common),
                    wd, log_dir, done_marker="Mean: Acc@1")
            jsons = glob.glob(os.path.join(os.path.dirname(best),
                                           "*-prob-ten.json"))
            prob_json[mod] = max(jsons, key=os.path.getmtime)

        if not args.skip_tta:
            run_cli("merge_2stream",
                    cli("merge_2stream_prob",
                        "--mode", "c", "--prob1", prob_json["rgb"],
                        "--prob2", prob_json["flow"],
                        "--class_ind", os.path.join(meta_dir, "ClassInd.txt"),
                        dtype=False),
                    wd, log_dir, done_marker="merged accuracy")

        # features cached by the LAST cycle's rgb retrieval (tag grammar of
        # the cycle loop above; cycle 1 keeps its historical name)
        retr_last = "coclr" if args.cycles == 1 else f"cycle{args.cycles}"
        feat_dir = os.path.join(wd, f"feat_retrieval_rgb_{retr_last}")
        run_cli("feature_probe_rgb",
                cli("feature_linear_probe",
                    "--test", os.path.join(feat_dir, "x"),
                    "--dirname", feat_dir, "--lr", "0.1", "--epochs", "60",
                    dtype=False),
                wd, log_dir, done_marker="Final best acc")

    report["total_wall_min"] = round(
        prior_wall_min + (time.time() - t_start) / 60, 1)
    report["chance_R@1"] = round(1.0 / args.n_classes, 4)
    dump_report()
    print(f"[drive] report -> {out_path}", flush=True)
    # fold the downstream results in and write the markdown from the saved
    # logs (the summarizer is the single source of truth for the report)
    summarize()
    print(json.dumps(report, indent=1), flush=True)


if __name__ == "__main__":
    main()
