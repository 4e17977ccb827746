"""Rebuild a port drive's report (<out_prefix>.json and a markdown summary
<out_prefix>.md) from the drive workdir's saved phase logs, the
counterpart of tools/summarize_coclr_drive.py:

    python -m coclr_tpu_torch.tools.summarize_coclr_drive --workdir /tmp/cyc

The logs are the source of truth, and for each retrieval the feature cache
it wrote (<workdir>/feat_<tag>), whose health (evalsuite/feature_health.py)
goes into the report and a table of the markdown; a retrieval over
non-finite features is marked, since its R@k means nothing. Both files go
beside the drive's report, under --workdir unless --out_prefix is absolute.
"""

import argparse
import json
import os
import re

from coclr_tpu_torch.tools.drive_coclr_cycle import (SELF_RE, feature_marks,
                                                     parse_epochs,
                                                     parse_retrieval,
                                                     report_path)

# cycle 1 keeps its historical tags; later cycles are cycle<N>_* (the drive
# script's --cycles flag); scan a generous range so deep drives summarize
MAX_CYCLES = 9
CYCLE_SUFFIXES = ["coclr"] + [f"cycle{n}" for n in range(2, MAX_CYCLES + 1)]
TRAIN_PHASES = (["nce_rgb", "nce_flow",
                 "coclr_flowmining", "coclr_rgbmining"]
                + [f"cycle{n}_{d}" for n in range(2, MAX_CYCLES + 1)
                   for d in ("flowmining", "rgbmining")])
RETR_PHASES = (["retrieval_rgb_init", "retrieval_flow_init"]
               + [f"retrieval_{m}_{suf}" for suf in CYCLE_SUFFIXES
                  for m in ("rgb", "flow")])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/coclr_cycle")
    ap.add_argument("--chance", default=0.25, type=float)
    ap.add_argument("--out_prefix", default="DRIVE_coclr_cycle",
                    help="basename of the <prefix>.json/.md report under "
                         "--workdir (absolute: that path)")
    args = ap.parse_args(argv)
    logs = os.path.join(args.workdir, "drivelogs")

    report = {"phases": {}, "chance_R@1": args.chance}
    prior = report_path(args.workdir, args.out_prefix)
    if os.path.exists(prior):
        with open(prior) as f:
            old = json.load(f)
        report["config"] = old.get("config")
        report["total_wall_min"] = old.get("total_wall_min")
        for tag, ph in old.get("phases", {}).items():
            for k in ("wall_min", "wall_s", "resumed"):
                if k in ph:
                    report["phases"].setdefault(tag, {})[k] = ph[k]

    for tag in TRAIN_PHASES:
        path = os.path.join(logs, f"{tag}.log")
        if not os.path.exists(path):
            continue
        text = open(path).read()
        ph = report["phases"].setdefault(tag, {})
        ph["epochs"] = parse_epochs(text)
        selfacc = {int(e): float(v) for e, v in SELF_RE.findall(text)}
        if selfacc:
            ph["self_acc1_final"] = selfacc[max(selfacc)]
    for tag in RETR_PHASES:
        path = os.path.join(logs, f"{tag}.log")
        if not os.path.exists(path):
            continue
        ph = report["phases"].setdefault(tag, {})
        ph.update(parse_retrieval(open(path).read()))
        ph.update(feature_marks(os.path.join(args.workdir, "feat_" + tag)))

    # optional downstream-eval extension: linear probes on the cycle
    # checkpoints (eval/main_classifier.py --train_what last), their N-crop
    # TTA tests, the two-stream fusion, and the feature-space probe
    for mod in ("rgb", "flow"):
        # 'probe_' = frozen linear probe (--train_what last, rounds 2-4);
        # 'finetune_' = the reference's headline recipe (--train_what ft,
        # round 5) — a drive runs one or the other (downstream_train_what)
        for kind in ("probe", "finetune"):
            tag = f"{kind}_{mod}_coclr"
            probe = os.path.join(logs, f"{tag}.log")
            if os.path.exists(probe):
                vals = re.findall(
                    r"val epoch (\d+): loss [\d.]+ top1 ([\d.]+)",
                    open(probe).read())
                if vals:
                    report["phases"][tag] = {
                        "best_val_top1": max(float(v) for _, v in vals),
                        "epochs_run": int(vals[-1][0]) + 1}
            tencrop = os.path.join(logs, f"{tag}_tencrop.log")
            if os.path.exists(tencrop):
                # the ten-crop pass prints Mean lines at the center / five /
                # ten checkpoints, in that order (ncrop.run_ncrop_test)
                means = re.findall(r"Mean: Acc@1: ([\d.]+) Acc@5: ([\d.]+)",
                                   open(tencrop).read())
                if means:
                    ph = report["phases"].setdefault(tag, {})
                    ph.update({"tencrop_top1": float(means[-1][0]),
                               "tencrop_top5": float(means[-1][1])})
                    if len(means) == 3:
                        ph["tta_center_top1"] = float(means[0][0])
                        ph["tta_five_top1"] = float(means[1][0])
                        ph["tta_ten_top1"] = float(means[2][0])
    merge = os.path.join(logs, "merge_2stream.log")
    if os.path.exists(merge):
        m = re.search(r"merged accuracy: ([\d.]+) \+ ([\d.]+) => ([\d.]+)",
                      open(merge).read())
        if m:
            report["phases"]["merge_2stream"] = {
                "top1_rgb": float(m.group(1)), "top1_flow": float(m.group(2)),
                "top1_fused": float(m.group(3))}
    featp = os.path.join(logs, "feature_probe_rgb.log")
    if os.path.exists(featp):
        accs = re.findall(r"Final best acc: ([\d.]+)", open(featp).read())
        if accs:
            report["phases"]["feature_probe_rgb"] = {
                "best_acc": max(float(a) for a in accs)}

    with open(prior, "w") as f:
        json.dump(report, f, indent=1)

    cfg = report.get("config") or {}
    shape = (f"at moco-k {cfg['moco_k']}, seq {cfg['seq_len']}, "
             f"{cfg['img_dim']}x{cfg['img_dim']}"
             if cfg.get("moco_k") else "at moco-k 2048, seq 32, 128x128")
    n_q = (cfg["n_classes"] * cfg["test_groups"] * cfg["n_clips"]
           if cfg.get("test_groups") else None)
    seed_note = (f", seed {cfg['seed']}" if cfg.get("seed") is not None
                 else "")
    card = cfg.get("card") or "card not recorded"
    lines = [f"# CoCLR cycle drive — {card}, learnable synthetic UCF", ""]
    lines += [f"Scripted reference recipe (README.md:28-56 of the reference) "
              f"{shape}{seed_note}: two InfoNCE inits -> "
              "CycleN-FlowMining -> CycleN-RGBMining (--reverse) -> NN "
              "retrieval per cycle. Produced by "
              "coclr_tpu_torch.tools.drive_coclr_cycle; raw logs in the "
              "drive workdir.", ""]
    for tag in TRAIN_PHASES:
        ph = report["phases"].get(tag, {})
        eps = ph.get("epochs") or []
        if not eps:
            if ph.get("resumed"):
                # wall-clock-bounded drives: a cut init is accepted from its
                # epoch-boundary checkpoint; a later relaunch may have
                # truncated the captured stdout, so the per-step curve lives
                # in the phase's exp-dir tfevents instead of this log
                lines.append(
                    f"- **{tag}**: resumed from an epoch-boundary "
                    "checkpoint (accept_partial_nce); progress log "
                    "truncated by the relaunch — per-step scalars in the "
                    "phase's tensorboard events")
            continue
        first, last = eps[0], eps[-1]
        wall = ph.get("wall_min")
        resumed = ph.get("resumed") or wall == 0.0  # 0.0 = legacy sentinel
        lines.append(
            f"- **{tag}**: loss {first['loss']:.3f} (ep{first['epoch']}) -> "
            f"{last['loss']:.3f} (ep{last['epoch']}), acc@1 "
            f"{first['acc1']:.3f} -> {last['acc1']:.3f}"
            + (f", Self-acc@1 {ph['self_acc1_final']:.3f} (final ep)"
               if "self_acc1_final" in ph else "")
            + (", resumed from an earlier launch" if resumed
               else f", {wall} min" if wall is not None else ""))
    lines.append("")
    stat = ""
    if n_q:
        sigma = (args.chance * (1 - args.chance) / n_q) ** 0.5
        stat = (f" — {n_q} held-out query videos; binomial sigma at chance "
                f"= {sigma:.3f}")
    lines.append(f"NN retrieval on the held-out groups (chance R@1 = "
                 f"{args.chance}{stat}):")
    lines.append("")
    lines.append("| model | R@1 | R@5 |")
    lines.append("|---|---|---|")
    for tag in RETR_PHASES:
        ph = report["phases"].get(tag, {})
        if "R@1" in ph:
            lines.append(f"| {tag.replace('retrieval_', '')} | "
                         f"{ph['R@1']:.3f} | {ph.get('R@5', float('nan')):.3f} |"
                         + (" non-finite features: R@k means nothing |"
                            if ph.get("nonfinite_features") else ""))
    healths = [(tag, report["phases"][tag]["features"]) for tag in RETR_PHASES
               if "features" in report["phases"].get(tag, {})]
    if healths:
        lines += ["", "Feature health of each retrieval's cached features "
                  "(evalsuite/feature_health.py: std per dimension after "
                  "centering, effective rank, the largest share of queries "
                  "with one top-1 train video):", "",
                  "| model | non-finite | std min | std median | "
                  "effective rank | hub share |", "|---|---|---|---|---|---|"]
        for tag, h in healths:
            nums = ([f"{h[k]:.4g}" for k in ("std_min", "std_median",
                                               "effective_rank", "hub_share")]
                    if h["finite"] else ["-"] * 4)
            lines.append(f"| {tag.replace('retrieval_', '')} | "
                         f"{h['nonfinite']} | " + " | ".join(nums) + " |")
    for mod in ("rgb", "flow"):
        for kind, desc in (("probe", "linear probe (`--train_what last`, "
                                     "frozen backbone)"),
                           ("finetune", "finetune (`--train_what ft`, "
                                        "backbone at lr/10 — the "
                                        "reference's headline recipe, "
                                        "README.md:92-103)")):
            pr = report["phases"].get(f"{kind}_{mod}_coclr")
            if not pr or "tencrop_top1" not in pr:
                continue
            tta = (f"center {pr['tta_center_top1']:.3f} / five "
                   f"{pr['tta_five_top1']:.3f} / ten "
                   f"{pr['tta_ten_top1']:.3f}"
                   if "tta_ten_top1" in pr else
                   f"top-1 {pr['tencrop_top1']:.3f}")
            lines += [
                "",
                f"Downstream eval on the CoCLR-{mod.upper()} checkpoint: "
                f"{desc}, {pr.get('epochs_run', '?')} epochs, "
                f"best val top-1 **{pr.get('best_val_top1', float('nan')):.3f}**"
                f" (chance {args.chance}), then N-crop TTA on the held-out "
                f"groups (`--test ... --ten_crop`) top-1: {tta} "
                f"(top-5 {pr['tencrop_top5']:.3f} at ten).",
            ]
    mg = report["phases"].get("merge_2stream")
    if mg:
        # keep the commentary conditional on the parsed numbers — this file
        # regenerates for any drive, not just the one it was written for
        if mg["top1_fused"] > max(mg["top1_rgb"], mg["top1_flow"]) + 1e-9:
            note = "the fusion beats both streams"
        elif min(mg["top1_rgb"], mg["top1_flow"]) <= args.chance + 0.05:
            note = ("the fusion follows the stronger stream when the other "
                    "is near chance")
        else:
            note = "the fusion tracks the stronger stream"
        lines += [
            "",
            f"Two-stream fusion (`merge_2stream_prob.py --mode c`) of the "
            f"ten-crop probs: rgb {mg['top1_rgb']:.3f} + flow "
            f"{mg['top1_flow']:.3f} → fused {mg['top1_fused']:.3f} — "
            f"{note}.",
        ]
    fp = report["phases"].get("feature_probe_rgb")
    if fp:
        lines += [
            "",
            f"Feature-space linear probe (`feature_linear_probe.py` on the "
            f"cached retrieval features): best acc {fp['best_acc']:.3f} "
            f"(chance {args.chance}; lr sweep in "
            f"drivelogs/feature_probe_rgb.log).",
        ]
    lines += [
        "",
        "Reading the numbers (MoCo/CoCLR dynamics, not anomalies):",
        "",
        "- InfoNCE loss *rises* over training while instance acc@1 runs far",
        "  above the 1/(K+1) chance level: the queue's negatives harden as",
        "  the key encoder improves (standard MoCo behavior; the signal of",
        "  record is retrieval).",
    ]
    # the mining-improvement claim is computed, not asserted: state it only
    # for the modalities whose post-mining R@1 actually beats the init
    improved = []
    for mod in ("rgb", "flow"):
        a = report["phases"].get(f"retrieval_{mod}_init", {}).get("R@1")
        b = report["phases"].get(f"retrieval_{mod}_coclr", {}).get("R@1")
        if a is not None and b is not None and b > a:
            improved.append(f"{mod} {a:.3f}->{b:.3f}")
    if len(improved) == 2:
        lines += [
            f"- Both modalities improve after their mining phase "
            f"({', '.join(improved)}) — the reference's central claim "
            f"(README.md:148-156: CoCLR-RGB 51.8 vs InfoNCE-RGB 33.1 NN@1) "
            f"reproduced in shape.",
        ]
    elif improved:
        lines += [
            f"- Mining improved retrieval for {improved[0]}; the other "
            f"modality did not improve in this drive (see table).",
        ]
    # the headline claim, σ-quantified: post-mining R@1 vs its InfoNCE
    # init (two-proportion SE at the observed rates) per modality
    if n_q:
        init_parts = []
        for mod in ("rgb", "flow"):
            a = report["phases"].get(f"retrieval_{mod}_init", {}).get("R@1")
            b = report["phases"].get(f"retrieval_{mod}_coclr", {}).get("R@1")
            if a is None or b is None:
                continue
            se = (a * (1 - a) / n_q + b * (1 - b) / n_q) ** 0.5
            z = (b - a) / se if se else 0.0
            init_parts.append(f"{mod} {a:.4f}->{b:.4f} ({z:+.1f} sigma)")
        if init_parts:
            lines += [
                f"- Post-mining vs InfoNCE-init R@1 "
                f"({n_q}-query two-proportion z): "
                f"{', '.join(init_parts)}.",
            ]
    for prev_suf, suf in zip(CYCLE_SUFFIXES, CYCLE_SUFFIXES[1:]):
        c2_parts = []
        cyc_n = int(suf.replace("cycle", ""))
        for mod in ("rgb", "flow"):
            v = report["phases"].get(f"retrieval_{mod}_{suf}", {}).get("R@1")
            if v is None:
                continue
            c1 = report["phases"].get(
                f"retrieval_{mod}_{prev_suf}", {}).get("R@1")
            if c1 is None:
                c2_parts.append(f"{mod} {v:.3f}")
                continue
            # per-measurement binomial sigma at the observed rate, for
            # honest "moved vs noise" framing of the cycle deltas
            note = ""
            if n_q:
                sig = max(p * (1 - p) / n_q for p in (c1, v)) ** 0.5
                z = (v - c1) / (sig * 2 ** 0.5) if sig else 0.0
                note = f" ({z:+.1f} sigma)"
            c2_parts.append(f"{mod} {c1:.3f}->{v:.3f}{note}")
        if c2_parts:
            lines += [
                f"- Mining cycle {cyc_n} (the reference's published "
                f"checkpoints continue cycling) moves held-out R@1: "
                f"{', '.join(c2_parts)}.",
            ]
    # best post-mining checkpoint per modality, stated against chance
    best_parts = []
    for mod in ("rgb", "flow"):
        cands = [report["phases"].get(f"retrieval_{mod}_{suf}", {}).get("R@1")
                 for suf in CYCLE_SUFFIXES]
        cands = [c for c in cands if c is not None]
        if not cands or not n_q:
            continue
        best = max(cands)
        z = (best - args.chance) / (args.chance * (1 - args.chance) / n_q) ** 0.5
        best_parts.append(f"{mod} {best:.3f} ({z:+.1f} sigma)")
    if best_parts:
        lines += [
            f"- Best post-mining retrieval vs chance {args.chance}: "
            f"{', '.join(best_parts)}.",
        ]
    gap = [mod for mod in ("rgb", "flow")
           if (report["phases"].get(f"probe_{mod}_coclr") or {})
           .get("best_val_top1", 0) >= args.chance + 0.10
           and (report["phases"].get(f"probe_{mod}_coclr") or {})
           .get("tencrop_top1", 1.0) <= args.chance + 0.02]
    if gap:
        lines += [
            f"- Probe val accuracy clears chance ({', '.join(gap)}) while "
            f"held-out-group TTA sits at it: the linear head overfits "
            f"group-specific appearance at synthetic scale (val shares "
            f"groups with train; the TTA test groups are disjoint). The "
            f"retrieval table above is the held-out signal of record.",
        ]
    lines += [
        "- Self-acc (top-1 == the sibling clip, main_coclr.py:348-359) is",
        "  structurally tiny on few-class synthetic data: features cluster",
        "  by class so the top-1 key is a near-tie among the many same-class",
        "  queue entries; it turning nonzero late in each CoCLR phase still",
        "  shows the mined-positive objective sharpening instance identity.",
    ]
    out_md = report_path(args.workdir, args.out_prefix, ".md")
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(json.dumps(report["phases"], indent=1)[:2000])
    print(f"-> {prior}\n-> {out_md}")


if __name__ == "__main__":
    main()
