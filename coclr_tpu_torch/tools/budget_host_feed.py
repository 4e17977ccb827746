"""Host-feed budget of the port's data plane: per-clip CPU cost, per decode
plane, the counterpart of tools/budget_host_feed.py:

    python -m coclr_tpu_torch.tools.budget_host_feed [--seq_len 32] \\
        [--img_dim 128] [--device_rate 362.8]

How many host cores does one card need so the loader keeps up with the
device step? One process, one thread, times:
  - sample: the full Dataset __getitem__ (LMDB fetch -> [msgpack] ->
    32x JPEG decode -> crop+resize -> stack), the unit the loader
    parallelizes; reported per CLIP (a pretrain sample = 2 clips);
  - fetch:  LMDB read + frame-list parse only;
  - decode: JPEG decode + crop of one frame through the plane's path;
  - crop:   crop+resize of a decoded frame.
Planes: hybrid (native mmap walker + cv2 decode, the default), cpp
(all-C++ libjpeg pool, COCLR_CPP_DECODE=1), python (pure-Python LMDB
reader + cv2 decode, COCLR_NO_NATIVE=1); a plane whose native library did
not build is null. The default --device_rate is the port's device-resident
S3D InfoNCE step on an H100 (362.8 clips/s, PERF.md section 5).

Prints one JSON line. The synthetic dataset lives in a temporary
directory, removed at the end.
"""

import argparse
import json
import os
import shutil
import tempfile
import time


def _time_per(fn, n, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def measure_plane(plane: str, out, seq_len: int, img_dim: int):
    """Per-clip ms for one decode plane; fresh dataset per plane so the
    native handle cache matches the env toggles."""
    from coclr_tpu_torch.data import native
    native._LIB, native._TRIED = None, False
    os.environ.pop("COCLR_NO_NATIVE", None)
    os.environ.pop("COCLR_CPP_DECODE", None)
    if plane == "python":
        os.environ["COCLR_NO_NATIVE"] = "1"
    elif plane == "cpp":
        os.environ["COCLR_CPP_DECODE"] = "1"
        if not native.available():
            return None
    elif not native.available():
        return None

    from coclr_tpu_torch.data import hostaug
    from coclr_tpu_torch.data.datasets import UCF101LMDB_2CLIP, _decode_crop

    ds = UCF101LMDB_2CLIP(mode="train", num_frames=seq_len, ds=1,
                          return_label=True, img_dim=img_dim,
                          root=out["root"], db_path=out["db_path"])
    n = len(ds)
    ds.set_epoch(0)

    # full sample = 2 clips (the loader's unit of work)
    s_ms = _time_per(lambda i: ds[i % n], min(n, 24)) * 1e3

    # stage: LMDB fetch + frame-list parse
    names = list(ds.env.get_video_id)[: min(n, 64)]
    f_ms = _time_per(lambda i: ds.env.frames(names[i % len(names)]),
                     len(names), reps=5) * 1e3

    # stage: decode + crop of one frame through this plane's actual path
    frames = ds.env.frames(names[0])
    rect = (0, 0, img_dim, img_dim)
    d_ms = _time_per(
        lambda i: _decode_crop(frames, [i % seq_len], rect, img_dim),
        seq_len, reps=5) * 1e3

    # crop/resize alone (shared cv2 path), for the decode/crop split
    if hasattr(frames, "raw"):
        f0 = hostaug.decode_jpeg(frames.raw(0))
    else:
        f0 = hostaug.decode_jpeg(frames[0])
    c_ms = _time_per(lambda i: hostaug.crop_resize(f0, rect, img_dim),
                     seq_len, reps=5) * 1e3

    per_clip_ms = s_ms / 2.0
    return {
        "sample_ms": round(s_ms, 2),
        "per_clip_ms": round(per_clip_ms, 2),
        "clips_per_sec_core": round(1e3 / per_clip_ms, 1),
        "fetch_ms_per_video": round(f_ms, 3),
        "decode_crop_ms_per_frame": round(d_ms, 3),
        "crop_ms_per_frame": round(c_ms, 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq_len", default=32, type=int)
    ap.add_argument("--img_dim", default=128, type=int)
    ap.add_argument("--device_rate", default=362.8, type=float,
                    help="device step clips/s per card")
    ap.add_argument("--frame_size", default="136,180")
    args = ap.parse_args(argv)

    from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

    h, w = (int(v) for v in args.frame_size.split(","))
    tmp = tempfile.mkdtemp(prefix="budget_feed_")
    report = {"metric": "host-feed budget (1 core, per decode plane)",
              "seq_len": args.seq_len, "crop": args.img_dim,
              "device_clips_per_sec": args.device_rate, "planes": {}}
    try:
        out = make_synthetic_ucf(tmp, n_classes=4, n_groups=8, n_clips=2,
                                 n_frames=args.seq_len + 8, size=(h, w))
        for plane in ("hybrid", "cpp", "python"):
            r = measure_plane(plane, out, args.seq_len, args.img_dim)
            if r is not None:
                r["cores_per_card"] = round(
                    args.device_rate / r["clips_per_sec_core"], 1)
            report["planes"][plane] = r
    finally:
        os.environ.pop("COCLR_NO_NATIVE", None)
        os.environ.pop("COCLR_CPP_DECODE", None)
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
