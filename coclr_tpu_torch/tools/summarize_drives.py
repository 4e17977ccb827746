"""Cross-seed summary of the port's CoCLR cycle-drive reports, the
counterpart of tools/summarize_drives.py:

    python -m coclr_tpu_torch.tools.summarize_drives --root /tmp [--markdown]

Aggregates every DRIVE_coclr_cycle*.json under --root, at any depth (the
port drive writes `<workdir>/<out_prefix>.json`; each report an independent
replication of the reference recipe, README.md:28-56 of the reference, at
synthetic scale: `coclr_tpu_torch.tools.drive_coclr_cycle --seed N`) into
one held-out NN-retrieval table: R@1 per modality at init, after the
cycle-1 mining pass, and after cycle 2, with binomial sigma vs chance.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os

STAGES = ("init", "coclr", "cycle2")


PATTERN = "DRIVE_coclr_cycle*.json"


def load_drives(root: str):
    out = []
    for path in sorted(glob.glob(os.path.join(root, "**", PATTERN),
                                 recursive=True)):
        with open(path) as f:
            d = json.load(f)
        cfg = d.get("config", {})
        seed = cfg.get("seed", 0)
        # held-out query count from THIS drive's config (protocols differ)
        queries = (cfg.get("n_classes", 4) * cfg.get("test_groups", 3)
                   * cfg.get("n_clips", 6))
        protocol = "nce{}x coclr{}".format(cfg.get("epochs_nce", "?"),
                                           cfg.get("epochs_coclr", "?"))
        row = {"file": os.path.basename(path), "seed": seed,
               "chance": d.get("chance_R@1"),
               "queries": queries, "protocol": protocol, "r1": {}}
        for mod in ("rgb", "flow"):
            for stage in STAGES:
                ph = d["phases"].get(f"retrieval_{mod}_{stage}")
                if ph is not None:
                    row["r1"][(mod, stage)] = ph["R@1"]
        out.append(row)
    return out


def sigma_at_chance(chance: float, n: int) -> float:
    return math.sqrt(chance * (1.0 - chance) / n)


def summarize(drives, n_queries: int = 0):
    """Per-seed best-post-mining R@1 and the cross-seed improvement count.
    n_queries overrides the per-drive config-derived held-out query count
    (n_classes*test_groups*n_clips) when nonzero."""
    lines = []
    improved = {"rgb": 0, "flow": 0}
    total = {"rgb": 0, "flow": 0}
    for d in drives:
        chance = d["chance"]
        sig = sigma_at_chance(chance, n_queries or d["queries"])
        for mod in ("rgb", "flow"):
            init = d["r1"].get((mod, "init"))
            post = [d["r1"][k] for k in ((mod, "coclr"), (mod, "cycle2"))
                    if k in d["r1"]]
            if init is None or not post:
                continue
            best = max(post)
            total[mod] += 1
            improved[mod] += best > init
            lines.append({
                "seed": d["seed"], "protocol": d["protocol"],
                "queries": n_queries or d["queries"],
                "modality": mod, "init": init,
                "best_post_mining": best,
                "delta_sigma": (best - init) / sig,
                "vs_chance_sigma": (best - chance) / sig,
            })
    return lines, improved, total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".",
                    help="directory searched, at any depth, for " + PATTERN)
    ap.add_argument("--queries", type=int, default=0,
                    help="override the per-drive config-derived query count")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    drives = load_drives(args.root)
    lines, improved, total = summarize(drives, args.queries)
    if args.markdown:
        print("| seed | protocol | queries | modality | init R@1 | "
              "best post-mining | delta (sigma) | vs chance (sigma) |")
        print("|---|---|---|---|---|---|---|---|")
        for r in lines:
            print("| {seed} | {protocol} | {queries} | {modality} | "
                  "{init:.3f} | {best_post_mining:.3f} "
                  "| {delta_sigma:+.1f} | {vs_chance_sigma:+.1f} |".format(**r))
        for mod in ("rgb", "flow"):
            print(f"\n{mod}: best post-mining beats init in "
                  f"{improved[mod]}/{total[mod]} seeds")
    else:
        print(json.dumps({"rows": lines, "improved": improved,
                          "total": total}, indent=1))


if __name__ == "__main__":
    main()
