"""Summarize a single-phase SCALE pretrain drive from a captured stdout log
of the port's main_nce into DRIVE_<name>.{json,md}, the counterpart of
tools/summarize_scale_drive.py:

    python -m coclr_tpu_torch.tools.summarize_scale_drive --log <stdout.log> \
        --name k400_scale --batch_size 32 --moco_k 16384 --note "..."

A scale drive is one `python -m coclr_tpu_torch.main_nce` run whose point
is the data path and queue dynamics at cardinality: dataset size,
steps/epoch, steady-state step time and host wait, loss/accuracy drift,
and where the moco queue first wraps (K / batch_size steps; InfoNCE
enqueues one key clip per sample per step; the reference regime is
main_nce.py --dataset k400 --moco-k 16384, the reference README.md:52-56).
The port's meter lines have the JAX package's grammar. Both files go to
--out_root, by default the directory of --log.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

# the instantaneous (non-running-average) meter values of every progress
# line: Epoch:[e][ s/S]  Time cur (avg)  Data cur (avg)  Loss cur (avg)
#       acc@1 cur (avg)  acc@5 cur (avg)
LINE_RE = re.compile(
    r"Epoch:\[(\d+)\]\[\s*(\d+)/(\d+)\]\s+Time ([\d.]+) \(([\d.]+)\)\s+"
    r"Data ([\d.]+) \(([\d.]+)\)\s+Loss ([\d.]+) \(([\d.]+)\)\s+"
    r"acc@1 ([\d.]+) \(([\d.]+)\)\s+acc@5 ([\d.]+) \(([\d.]+)\)")


def parse_lines(text):
    rows = []
    for m in LINE_RE.finditer(text):
        e, s, total = int(m.group(1)), int(m.group(2)), int(m.group(3))
        rows.append({
            "epoch": e, "step": s, "steps_total": total,
            "time": float(m.group(4)), "time_avg": float(m.group(5)),
            "data": float(m.group(6)), "data_avg": float(m.group(7)),
            "loss": float(m.group(8)), "loss_avg": float(m.group(9)),
            "acc1": float(m.group(10)), "acc1_avg": float(m.group(11)),
            "acc5": float(m.group(12)), "acc5_avg": float(m.group(13)),
        })
    return rows


def quarter_mean(rows, key, lo_frac, hi_frac):
    n = len(rows)
    lo, hi = int(n * lo_frac), max(int(n * hi_frac), int(n * lo_frac) + 1)
    vals = [r[key] for r in rows[lo:hi]]
    return sum(vals) / len(vals)


def summarize(log_path, name, batch_size, moco_k, clips_per_sample=2,
              warmup_skip=10, notes=()):
    with open(log_path) as f:
        text = f.read()
    rows = parse_lines(text)
    if not rows:
        raise SystemExit(f"no progress lines parsed from {log_path}")
    steps_total = rows[-1]["steps_total"]
    # steady state: instantaneous Time after the warmup steps (the first
    # steps carry cuDNN's algorithm search, the loader's warm-up and
    # cold-cache effects)
    steady = [r for r in rows if r["step"] >= warmup_skip]
    t = sorted(r["time"] for r in steady)
    t_med = t[len(t) // 2]
    clips_per_step = batch_size * clips_per_sample
    fill_step = moco_k // batch_size
    near_fill = [r for r in rows if abs(r["step"] - fill_step) <= 25]
    report = {
        "name": name,
        "log": os.path.basename(log_path),
        "batch_size": batch_size,
        "moco_k": moco_k,
        "dataset_videos": steps_total * batch_size,
        "steps_per_epoch": steps_total,
        "epochs_logged": rows[-1]["epoch"] + 1,
        "last_step_logged": rows[-1]["step"],
        "queue_dataset_ratio": round(moco_k / (steps_total * batch_size), 4),
        "queue_first_full_step": fill_step,
        "step_time_median_s": round(t_med, 4),
        "clips_per_sec": round(clips_per_step / t_med, 1),
        "host_wait_data_avg_s": round(steady[-1]["data_avg"], 4),
        "loss_first_decile": round(quarter_mean(rows, "loss", 0.0, 0.1), 4),
        "loss_last_decile": round(quarter_mean(rows, "loss", 0.9, 1.0), 4),
        "acc1_last_decile": round(quarter_mean(rows, "acc1", 0.9, 1.0), 4),
        "acc5_last_decile": round(quarter_mean(rows, "acc5", 0.9, 1.0), 4),
        "loss_around_queue_fill": (
            round(sum(r["loss"] for r in near_fill) / len(near_fill), 4)
            if near_fill else None),
        "notes": list(notes),
    }
    return report


def to_markdown(r):
    lines = [
        f"# DRIVE_{r['name']} — scale pretrain drive",
        "",
        f"Source log: `{r['log']}` (summary: "
        "coclr_tpu_torch.tools.summarize_scale_drive)",
        "",
        "| metric | value |",
        "|---|---|",
        f"| dataset (train videos) | {r['dataset_videos']:,} |",
        f"| steps/epoch @ batch {r['batch_size']} | {r['steps_per_epoch']:,} |",
        f"| moco-k | {r['moco_k']:,} |",
        f"| queue/dataset ratio | {r['queue_dataset_ratio']} |",
        f"| queue first full at step | {r['queue_first_full_step']} |",
        f"| median step time (steady) | {r['step_time_median_s']} s |",
        f"| clips/s | {r['clips_per_sec']} |",
        f"| host wait (Data avg) | {r['host_wait_data_avg_s']} s |",
        f"| loss first->last decile | {r['loss_first_decile']} -> "
        f"{r['loss_last_decile']} |",
        f"| loss around queue fill | {r['loss_around_queue_fill']} |",
        f"| acc@1 / acc@5 last decile | {r['acc1_last_decile']} / "
        f"{r['acc5_last_decile']} |",
        "",
    ]
    for n in r["notes"]:
        lines.append(f"- {n}")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", required=True)
    ap.add_argument("--name", default="k400_scale")
    ap.add_argument("--batch_size", type=int, required=True)
    ap.add_argument("--moco_k", type=int, required=True)
    ap.add_argument("--clips_per_sample", type=int, default=2)
    ap.add_argument("--warmup_skip", type=int, default=10)
    ap.add_argument("--note", action="append", default=[])
    ap.add_argument("--out_root", default="",
                    help="output directory (default: that of --log)")
    args = ap.parse_args(argv)
    out_root = args.out_root or os.path.dirname(os.path.abspath(args.log))

    r = summarize(args.log, args.name, args.batch_size, args.moco_k,
                  args.clips_per_sample, args.warmup_skip, args.note)
    jpath = os.path.join(out_root, f"DRIVE_{args.name}.json")
    mpath = os.path.join(out_root, f"DRIVE_{args.name}.md")
    with open(jpath, "w") as f:
        json.dump(r, f, indent=1)
    with open(mpath, "w") as f:
        f.write(to_markdown(r))
    print(json.dumps(r))
    print(f"wrote {jpath} + .md", file=sys.stderr)


if __name__ == "__main__":
    main()
