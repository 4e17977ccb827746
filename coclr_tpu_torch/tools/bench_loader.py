"""Host data-plane throughput of the port's loader: clips/s out of
coclr_tpu_torch.data.loader.Loader (LMDB read -> msgpack -> JPEG decode ->
crop/resize -> batch assembly), native C++ plane against the pure-Python
one, thread and process workers. The counterpart of tools/bench_loader.py:

    python -m coclr_tpu_torch.tools.bench_loader [--data_root <root>] \\
        [--seq_len 32] [--img_dim 128] [--batch_size 32] [--workers 16]

With no --data_root it builds a synthetic UCF dataset in a temporary
directory (removed at the end). Prints one JSON line; a plane that is not
available (the native library did not build) is null.
"""

import argparse
import json
import os
import shutil
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", default="")
    ap.add_argument("--db", default="")
    ap.add_argument("--seq_len", default=32, type=int)
    ap.add_argument("--img_dim", default=128, type=int)
    ap.add_argument("--batch_size", default=32, type=int)
    ap.add_argument("--workers", default=16, type=int)
    ap.add_argument("--steps", default=20, type=int)
    ap.add_argument("--frame_size", default="136,180",
                    help="synthetic decode size HxW")
    args = ap.parse_args(argv)

    from coclr_tpu_torch.data import native
    from coclr_tpu_torch.data.datasets import UCF101LMDB_2CLIP
    from coclr_tpu_torch.data.loader import Loader

    tmp = None
    if args.data_root:
        kw = dict(data_root=args.data_root, db_path=args.db or None)
    else:
        from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

        h, w = (int(v) for v in args.frame_size.split(","))
        tmp = tempfile.mkdtemp(prefix="benchloader_")
        out = make_synthetic_ucf(tmp, n_classes=4, n_groups=8, n_clips=2,
                                 n_frames=args.seq_len + 8, size=(h, w))
        kw = dict(root=out["root"], db_path=out["db_path"])

    results = {}
    try:
        for mode in ("native", "python"):
            # the native lib handle is cached; reset it around the env toggle
            native._LIB, native._TRIED = None, False
            if mode == "python":
                os.environ["COCLR_NO_NATIVE"] = "1"
            else:
                os.environ.pop("COCLR_NO_NATIVE", None)
                if not native.available():
                    results[mode] = None
                    results[f"{mode}-process"] = None
                    continue
            ds = UCF101LMDB_2CLIP(mode="train", num_frames=args.seq_len, ds=1,
                                  return_label=True, img_dim=args.img_dim,
                                  **kw)
            for worker_mode in ("thread", "process"):
                loader = Loader(ds, batch_size=args.batch_size,
                                num_workers=args.workers, seed=0,
                                worker_mode=worker_mode)
                loader.set_epoch(0)
                next(iter(loader))  # warm the worker pool
                t0 = time.perf_counter()
                n, done, epoch = 0, 0, 0
                while done < args.steps:
                    epoch += 1
                    loader.set_epoch(epoch)
                    for batch in loader:
                        n += batch["seq"].shape[0] * 2  # 2 clips per sample
                        done += 1
                        if done >= args.steps:
                            break
                dt = time.perf_counter() - t0
                key = mode if worker_mode == "thread" else f"{mode}-process"
                results[key] = round(n / dt, 1)
                loader.close()
    finally:
        os.environ.pop("COCLR_NO_NATIVE", None)
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)

    report = {
        "metric": f"host loader clips/sec (seq {args.seq_len}, "
                  f"crop {args.img_dim}, {args.workers} workers)",
        "native": results.get("native"),
        "python": results.get("python"),
        "native_process": results.get("native-process"),
        "python_process": results.get("python-process"),
        "cpus": os.cpu_count(),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
