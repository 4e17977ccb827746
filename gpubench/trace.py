"""Reading a live torch.profiler window: device events, the busy share,
device ops per step, each of the port's kernels' time, and the breakdown of
device time and of idle gaps.

Frozen copy, commit aac8d1afaaa1f842512867f379867b56b8e4edf4, of the reader
of coclr_tpu_torch/utils/profiling.py (trace_events on a live profiler,
live_category, DEVICE_CATS, the interval merge of read_trace, and
`category`); the breakdown of idle gaps by host activity is new here.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def live_category(event) -> str:
    """A live event's Chrome-trace category: its kineto activity type where
    torch reports it, else derived from its device, annotation flag, name."""
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


def events_of(prof):
    """(category, name, start_us, duration_us) of a finished profiler."""
    return [(live_category(e), e.name(), e.start_ns() / 1e3,
             e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()]


def category(name: str) -> str:
    """Device op name -> coarse category (profiling.category)."""
    low = name.lower()
    for kernel in ("jitter_kernel", "pool1d_bwd_kernel"):
        if kernel in low:
            return kernel
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


class Window:
    """One traced window of `steps` loop steps. All times in seconds; the
    window is the span of all its events, host and device."""

    def __init__(self, events, steps: int):
        self.steps = steps
        self.device = [(s, d, n) for c, n, s, d in events if c in DEVICE_CATS]
        # the loop's train#<i> annotation spans a whole step: too coarse to
        # name a gap
        self.host = [(s, d, n) for c, n, s, d in events
                     if c in HOST_CATS and not n.startswith("train#")]
        spans = sorted((s, s + d) for s, d, _ in self.device)
        busy, reach, merged = 0.0, float("-inf"), []
        for start, end in spans:
            busy += max(0.0, end - max(start, reach))
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
            reach = max(reach, end)
        self.merged = merged
        self.busy_s = busy / 1e6
        ends = [s + d for _, _, s, d in events]
        self.window_s = ((max(ends) - min(s for _, _, s, _ in events)) / 1e6
                         if events else 0.0)
        self.per_op = defaultdict(float)
        self.count_op = defaultdict(int)
        for _, d, n in self.device:
            self.per_op[n] += d / 1e6
            self.count_op[n] += 1

    @property
    def ops_per_step(self) -> float:
        return len(self.device) / self.steps

    def kernel(self, name: str):
        """(seconds, launches) of the device ops whose name holds `name`."""
        hits = [n for n in self.per_op if name in n]
        return (sum(self.per_op[n] for n in hits),
                sum(self.count_op[n] for n in hits))

    def categories(self):
        out = defaultdict(float)
        for n, s in self.per_op.items():
            out[category(n)] += s
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def top_ops(self, k: int = 10):
        return [[n, s] for n, s in sorted(self.per_op.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """The k longest gaps between merged device intervals, each named by
        the host event that overlaps it most (the innermost on a tie), or
        '(no host op)'."""
        gaps = [(b[0] - a[1], a[1], b[0])
                for a, b in zip(self.merged, self.merged[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        host = sorted(self.host)
        starts = [h[0] for h in host]
        longest = max((d for _, d, _ in host), default=0.0)
        out = []
        for length, lo, hi in gaps[:k]:
            best, best_key = "(no host op)", (0.0, 0.0)
            i = bisect.bisect_left(starts, lo - longest)
            for s, d, n in host[i:bisect.bisect_right(starts, hi)]:
                ov = min(s + d, hi) - max(s, lo)
                if ov > 0 and (ov, -d) > best_key:
                    best, best_key = n, (ov, -d)
            out.append([best, length / 1e6])
        return out
