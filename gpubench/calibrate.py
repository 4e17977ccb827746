"""Readings from which a cell's limits are set (the check of `correct`):

    python3 -m gpubench.calibrate --workload <cell> --seeds <n> ... \
        --control 3 --faults half_batch altered --out <file.json>

For every seed, the program's first steps as a run drives them (the cell's
traffic, set-up cut to the checked steps, no window) against the plain
reference: the lower readings. For the first `--control` seeds, also the
control (the reference itself in fp8) and each planted fault against the
same reference: the upper readings. All in one process, on the card. Writes
every number of every run to `--out` and prints a summary: the largest
program reading and the smallest control and fault readings of each
number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="seeds (the first ones) that also read the control")
    ap.add_argument("--fault-seeds", type=int, default=None,
                    help="seeds (the first ones) that also read the faults; "
                    "--control's by default")
    ap.add_argument("--faults", nargs="*", default=["half_batch", "altered"],
                    help="faults of tap.py, one run each; '+' joins several "
                    "into one run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    ap.add_argument("--shrink", action="store_true",
                    help="the CPU rehearsal's size (run.shrink)")
    args = ap.parse_args(argv)

    from gpubench import run

    run.cache_env()
    import torch

    from gpubench import check

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 3
    cell = run.resolve(args.workload)
    if args.shrink:
        cell = run.shrink(cell)
    cell["traffic"] = dict(cell["traffic"],
                           warm_steps=cell["traffic"]["checked_steps"])
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        out = run.run_cell(cell, seed, 0.0, False, device=args.device)
        rows.append({"seed": seed, "side": "program", **out["values"],
                     "reference_s": out["reference_s"],
                     "leaves": out["worst_leaves"]})
        fault_seeds = args.control if args.fault_seeds is None \
            else args.fault_seeds
        if i < args.control:
            ref = out["reference"]
            ctl = check.run_reference(out["recorded"], out["feed"].recorded,
                                      args.device, prec=check.FP8,
                                      start=out["start"])
            rows.append({"seed": seed, "side": "control",
                         **check.numbers(ctl, ref, args.device),
                         "leaves": check.worst_leaves(ctl, ref)})
            del ctl, ref
        if i < fault_seeds:
            for fault in args.faults:
                del out
                gc.collect()
                out = run.run_cell(cell, seed, 0.0, False, device=args.device,
                                   fault=fault)
                rows.append({"seed": seed, "side": fault, **out["values"],
                             "leaves": out["worst_leaves"]})
        del out
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        print(f"calibrate: seed {seed} in {time.perf_counter() - t0:.1f} s: "
              + json.dumps([r for r in rows if r["seed"] == seed]),
              file=sys.stderr, flush=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    names = [k for k in rows[0] if k not in ("seed", "side", "leaves")]
    for name in names:
        low = max(r[name] for r in rows if r["side"] == "program")
        upper = {side: min(r[name] for r in rows if r["side"] == side)
                 for side in ["control"] + list(args.faults)
                 if any(r["side"] == side and name in r for r in rows)}
        print(f"{name}: program max {low:.6g}; "
              + ", ".join(f"{s} min {v:.6g}" for s, v in upper.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
