"""Tracing and profiling of the port, the counterpart of
coclr_tpu/utils/profiling.py: device traces through torch.profiler (gzipped
Chrome traces, viewable in Perfetto or chrome://tracing), per-step
annotations, a host-side StepTimer that reports data-wait vs step time and
clips/sec, and a reader that turns a trace into device time per step.

What the reader counts, and why:
- Device time is the sum over the device's own events: kernels, memcpy and
  memset (`DEVICE_CATS`). torch projects each `record_function` range onto
  the device timeline as a `gpu_user_annotation` event spanning the kernels
  inside it, and the host lane carries a `cuda_runtime` event for every
  launch; summing those as well would count the same device time twice.
- The busy share is the union of the device intervals over the window's
  wall time: kernels on several streams overlap, so their sum may exceed it.
- The port's kernels are launched through ctypes (kernels/build.py), so no
  aten op stands above them on the host lane; the device records them
  under their own names (`PORT_KERNELS`).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host-side launch calls of the runtime and the driver API
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# the device names of the port's two CUDA kernels (csrc/jitter.cu,
# csrc/pool1d_bwd.cu)
PORT_KERNELS = ("jitter_kernel", "pool1d_bwd_kernel")
TRACE_SUFFIX = ".pt.trace.json.gz"


class device_trace:
    """Capture a device trace of the enclosed steps into `logdir`: a
    torch.profiler window with CPU activity, plus CUDA activity when
    `device` is a card. The card is synchronized when the window opens (so
    that it holds only the enclosed work) and before it closes; on exit a
    gzipped Chrome trace `rank<r>.<ns>.pt.trace.json.gz` is written, one
    file per rank (the process group's rank, else the launcher's RANK),
    and `path` names it. `prof` is the profiler, which `read_trace` also
    reads directly. (Lower-case, as torch.profiler.profile.)"""

    def __init__(self, logdir: str, device):
        import torch

        self.logdir = logdir
        self.on_card = torch.device(device).type == "cuda"
        self.prof = None
        self.path = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.logdir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.on_card:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        import torch.distributed as tdist

        try:
            if self.on_card:
                torch.cuda.synchronize()
        finally:
            self.prof.__exit__(None, None, None)
        rank = (tdist.get_rank() if tdist.is_available() and tdist.is_initialized()
                else int(os.environ.get("RANK", "0")))
        self.path = os.path.join(self.logdir, "rank%d.%d%s" % (
            rank, time.time_ns(), TRACE_SUFFIX))
        self.prof.export_chrome_trace(self.path)
        return False


def step_annotation(name: str, step: int):
    """Annotate one train step in the trace (`<name>#<step>`)."""
    import torch

    return torch.profiler.record_function(f"{name}#{step}")


class StepTimer:
    """Host-side step accounting: data-wait, step-dispatch, clips/sec.

    Usage:
        timer = StepTimer(clips_per_step=64)
        for batch in loader:
            timer.data_ready()
            ... dispatch step ...
            timer.step_done()
    """

    def __init__(self, clips_per_step: int = 0, window: int = 50):
        self.clips_per_step = clips_per_step
        self.window = window
        self.reset()

    def reset(self):
        self._last = time.perf_counter()
        self.data_times: List[float] = []
        self.step_times: List[float] = []

    def data_ready(self):
        now = time.perf_counter()
        self.data_times.append(now - self._last)
        self._last = now

    def step_done(self):
        now = time.perf_counter()
        self.step_times.append(now - self._last)
        self._last = now

    def summary(self) -> Dict[str, float]:
        import numpy as np

        d = np.asarray(self.data_times[-self.window:] or [0.0])
        s = np.asarray(self.step_times[-self.window:] or [0.0])
        total = d.mean() + s.mean()
        out = {
            "data_time_mean": float(d.mean()),
            "step_time_mean": float(s.mean()),
            "data_fraction": float(d.mean() / total) if total else 0.0,
        }
        if self.clips_per_step and total:
            out["clips_per_sec"] = self.clips_per_step / total
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump({"data_times": self.data_times,
                       "step_times": self.step_times,
                       "summary": self.summary()}, f)


def category(name: str) -> str:
    """CUDA kernel (or memcpy / memset) name -> coarse category; the port's
    two kernels each keep a category of their own."""
    for kernel in PORT_KERNELS:
        if kernel in name:
            return kernel
    low = name.lower()
    if "nccl" in low:
        return "collective"
    if (low.startswith(("memcpy", "memset")) or "direct_copy" in low
            or "nchwtonhwc" in low or "nhwctonchw" in low or "copy" in low
            or "transpose" in low):
        return "copy/transpose"
    if "batch_norm" in low or "batchnorm" in low or re.search(r"bn_[fb]w", low):
        return "batchnorm"
    if ("cudnn" in low or "conv" in low or "implicit_gemm" in low
            or re.search(r"[fdw]grad|fprop", low)):
        return "convolution"
    if ("gemm" in low or "gemv" in low or "cublas" in low or "cutlass" in low
            or "nvjet" in low):
        return "gemm"
    if "xmma" in low:
        return "convolution"
    if "pool" in low:
        return "pool"
    if "reduce" in low or "softmax" in low or "norm_kernel" in low:
        return "reduce"
    if "elementwise" in low or "multi_tensor_apply" in low or "foreach" in low:
        return "elementwise"
    return "other"


def newest_trace(source: str) -> str:
    """source itself if it is a file, else the newest *.pt.trace.json[.gz]
    below the directory."""
    if os.path.isfile(source):
        return source
    paths = [p for pattern in ("*.pt.trace.json.gz", "*.pt.trace.json")
             for p in glob.glob(os.path.join(source, "**", pattern),
                                recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {source}")
    return max(paths, key=os.path.getmtime)


def live_category(event) -> str:
    """A live profiler event's Chrome-trace category: its kineto activity
    type where torch reports it (`activity_type()`, torch 2.13), else
    derived from its device, its annotation flag and its name (torch 2.11
    has no `activity_type`)."""
    from torch.autograd import DeviceType

    if hasattr(event, "activity_type"):
        return event.activity_type()
    on_device = event.device_type() == DeviceType.CUDA
    if event.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    name = event.name()
    return ("gpu_memcpy" if name.startswith("Memcpy")
            else "gpu_memset" if name.startswith("Memset") else "kernel")


def trace_events(source):
    """The complete events of a trace as (category, name, start_us,
    duration_us) tuples, and the trace's path (None for a live profiler).
    `source`: a *.pt.trace.json[.gz] file, a directory (its newest trace),
    a finished torch.profiler.profile or a device_trace. A live event's
    category (live_category) is the one a Chrome trace writes as `cat`; the
    file adds one span of the whole window (category `Trace`)."""
    if isinstance(source, device_trace):
        source = source.prof
    if isinstance(source, (str, os.PathLike)):
        path = newest_trace(os.fspath(source))
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            raw = json.load(f).get("traceEvents", [])
        return [(ev.get("cat", ""), ev.get("name", ""), float(ev.get("ts", 0.0)),
                 float(ev.get("dur", 0.0))) for ev in raw
                if ev.get("ph") == "X"], path
    events = source.profiler.kineto_results.events()
    return [(live_category(e), e.name(), e.start_ns() / 1e3,
             e.duration_ns() / 1e3) for e in events], None


def read_trace(source, steps: int, topk: int = 25,
               wall_us: Optional[float] = None) -> dict:
    """Per-step device profile of a trace covering `steps` steps (source as
    in trace_events): device time by category and by op, the busy share
    (union of device intervals over `wall_us`, by default the span of all
    events), device ops and host launch calls per step, the time and
    launches of each of the port's kernels, and the trace's path."""
    events, path = trace_events(source)
    per_op, per_cat, launches_op = defaultdict(float), defaultdict(float), \
        defaultdict(int)
    spans = []
    host_launches = 0
    first, last = float("inf"), float("-inf")
    for cat, name, start, dur in events:
        first, last = min(first, start), max(last, start + dur)
        if name in LAUNCH_NAMES:
            host_launches += 1
        if cat not in DEVICE_CATS:
            continue
        per_op[name] += dur
        launches_op[name] += 1
        per_cat[category(name)] += dur
        spans.append((start, start + dur))
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    if wall_us is None:
        wall_us = last - first if events else 0.0
    kernels = {}
    for kernel in PORT_KERNELS:
        names = [n for n in per_op if kernel in n]
        kernels[kernel] = {
            "us_per_step": sum(per_op[n] for n in names) / steps,
            "launches_per_step": sum(launches_op[n] for n in names) / steps}
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:topk]
    return {
        "device_us_per_step": sum(per_op.values()) / steps,
        "categories_us_per_step": {
            k: v / steps for k, v in sorted(per_cat.items(),
                                            key=lambda kv: -kv[1])},
        "top_ops_us_per_step": [[n, v / steps, launches_op[n] / steps]
                                for n, v in top],
        "busy": busy / wall_us if wall_us > 0 else 0.0,
        "busy_us_per_step": busy / steps,
        "window_us_per_step": wall_us / steps,
        "device_ops_per_step": len(spans) / steps,
        "host_launches_per_step": host_launches / steps,
        "kernels": kernels,
        "trace_path": path,
    }
