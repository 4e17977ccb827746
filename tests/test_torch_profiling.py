"""The port's profiling (coclr_tpu_torch/utils/profiling.py, --profile_steps in
run_pretrain, coclr_tpu_torch/tools/profile_step.py) on the CPU: the
StepTimer against the JAX package's, the trace reader on a synthetic
torch-shaped Chrome trace (overlapping streams, a gpu_user_annotation span,
runtime launches, the port's two kernels), the --profile_steps window of
run_pretrain against the JAX formula with the run left bit-identical, and
the tool's JSON line against the JAX tool's keys."""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

from coclr_tpu.utils import profiling as jax_profiling
from coclr_tpu_torch.config import PretrainConfig
from coclr_tpu_torch.utils import profiling

# the keys of the JSON line tools/profile_step.py prints
JAX_TOOL_KEYS = {"device_us_per_step", "categories_us_per_step",
                 "top_ops_us_per_step", "trace_path", "workload", "steps",
                 "clips_per_step", "wall_us_per_step", "clips_per_sec_device"}


def test_step_timer_matches_jax(monkeypatch):
    """The same scripted perf_counter readings give the same summary."""
    ticks = [0.0, 0.5, 1.75, 2.0, 3.5, 3.625, 5.0, 5.25, 7.0]
    summaries = []
    for module in (jax_profiling, profiling):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = module.StepTimer(clips_per_step=64, window=3)
        for _ in range(4):
            timer.data_ready()
            timer.step_done()
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[1]["clips_per_sec"] > 0


def _x(cat, name, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": {}}


JITTER = "void jitter_kernel<true>(JitterArgs)"
POOL = ("void pool1d_bwd_kernel<__nv_bfloat16, 3, 2, 1, 8>"
        "(PoolArgs<__nv_bfloat16>)")
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >"
       "(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)")


def _synthetic_trace(tmp_path):
    """Two steps as torch writes them: a host lane (cpu ops, the step's
    user annotation, one cudaLaunchKernel per kernel, a memcpy call) and a
    device with streams 7 and 13, whose kernels overlap, under a
    gpu_user_annotation span that covers them."""
    host = dict(pid=100, tid=100)
    events = [
        {"ph": "M", "name": "process_name", "pid": 100, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        _x("user_annotation", "train#1", 0, 400, **host),
        _x("cpu_op", "aten::convolution", 1, 60, **host),
        *[_x("cuda_runtime", "cudaLaunchKernel", 2 + i, 1, **host)
          for i in range(5)],
        _x("cuda_runtime", "cudaMemcpyAsync", 8, 1, **host),
        _x("gpu_user_annotation", "train#1", 10, 315),
        _x("kernel", JITTER, 10, 40),                  # [10, 50]
        _x("kernel", POOL, 60, 30),                    # [60, 90]
        _x("kernel", POOL, 70, 30, tid=13),            # [70, 100]
        _x("kernel", CONV, 100, 100),                  # [100, 200]
        _x("kernel", ADD, 150, 100, tid=13),           # [150, 250]
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 300, 10),
        _x("gpu_memset", "Memset (Device)", 320, 5),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 100, "tid": 100,
         "ts": 2, "id": 1},
    ]
    d = tmp_path / "trace"
    d.mkdir()
    path = d / ("rank0.1" + profiling.TRACE_SUFFIX)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(d), str(path)


def test_reader_counts_each_kernel_once_and_busy_is_the_union(tmp_path):
    """The torch analogue of tests/test_profile_tool.py::
    test_parse_trace_uses_only_xla_ops_lane: the gpu_user_annotation span
    and the host's runtime calls add no device time, overlapping streams
    are summed per op but count once in the busy share."""
    logdir, path = _synthetic_trace(tmp_path)
    out = profiling.read_trace(logdir, steps=2)
    assert out["trace_path"] == path
    # (40 + 30 + 30 + 100 + 100 + 10 + 5) / 2: not + 315 of annotation
    assert out["device_us_per_step"] == 157.5
    # union [10,50] + [60,100] + [100,250] + [300,310] + [320,325] = 245 us
    # over the window's 400 us (the host annotation spans it)
    assert out["busy"] == pytest.approx(245 / 400)
    assert out["busy_us_per_step"] == 122.5
    assert out["window_us_per_step"] == 200.0
    assert out["device_ops_per_step"] == 3.5
    assert out["host_launches_per_step"] == 2.5
    assert out["categories_us_per_step"] == {
        "convolution": 50.0, "elementwise": 50.0, "pool1d_bwd_kernel": 30.0,
        "jitter_kernel": 20.0, "copy/transpose": 7.5}
    assert out["kernels"] == {
        "jitter_kernel": {"us_per_step": 20.0, "launches_per_step": 0.5},
        "pool1d_bwd_kernel": {"us_per_step": 30.0, "launches_per_step": 1.0}}
    names = [n for n, _, _ in out["top_ops_us_per_step"]]
    assert "train#1" not in names and "cudaLaunchKernel" not in names
    assert out["top_ops_us_per_step"][2] == [POOL, 30.0, 1.0]
    # a wall time measured outside the trace replaces the trace's span
    assert profiling.read_trace(path, 2, wall_us=490.0)["busy"] == 0.5


@pytest.mark.parametrize("name,expected", [
    ("nchwToNhwcKernel", "copy/transpose"),
    ("void at::native::elementwise_kernel<128, 4, at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)>", "copy/transpose"),
    ("cudnn::bn_fw_tr_1C11_kernel_NCHW<float>", "batchnorm"),
    ("cudnn::engines_precompiled::nchwToNhwcKernel", "copy/transpose"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<float>", "convolution"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16", "convolution"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "gemm"),
    ("ncclDevKernel_AllGather_RING_LL", "collective"),
    ("void at::native::reduce_kernel<512, 1>", "reduce"),
    ("void at::native::multi_tensor_apply_kernel<...>", "elementwise"),
    (JITTER, "jitter_kernel"), (POOL, "pool1d_bwd_kernel"),
])
def test_category_mapping(name, expected):
    assert profiling.category(name) == expected


def test_live_profiler_reads_as_its_file(tmp_path):
    """The reader's two sources agree: a finished profiler and the trace
    file it wrote give the same events (categories and names), apart from
    the span of the whole window that the file adds (category 'Trace')."""
    with profiling.device_trace(str(tmp_path), "cpu") as window:
        with profiling.step_annotation("train", 7):
            torch.randn(64, 64) @ torch.randn(64, 64)
    live, _ = profiling.trace_events(window)
    written, path = profiling.trace_events(str(tmp_path))
    assert path == window.path and path.endswith(profiling.TRACE_SUFFIX)
    assert os.path.basename(path).startswith("rank0.")
    assert sorted((c, n) for c, n, _, _ in live) == \
        sorted((c, n) for c, n, _, _ in written if c != "Trace")
    assert ("user_annotation", "train#7") in [(c, n) for c, n, _, _ in live]


class _Event:
    """A live profiler event of a torch without `activity_type()`."""

    def __init__(self, name, on_device, annotation=False):
        from torch.autograd import DeviceType

        self._name, self._annotation = name, annotation
        self._device = DeviceType.CUDA if on_device else DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation


@pytest.mark.parametrize("event,expected", [
    (_Event(JITTER, True), "kernel"),
    (_Event("Memcpy HtoD (Pinned -> Device)", True), "gpu_memcpy"),
    (_Event("Memset (Device)", True), "gpu_memset"),
    (_Event("train#3", True, annotation=True), "gpu_user_annotation"),
    (_Event("train#3", False, annotation=True), "user_annotation"),
    (_Event("cudaLaunchKernel", False), "cpu_op"),
    (_Event("aten::mm", False), "cpu_op"),
])
def test_live_category_without_activity_type(event, expected):
    """Where torch gives no activity type, the category comes from the
    event's device, annotation flag and name; only device categories
    count as device time, so the launch call's 'cpu_op' is harmless."""
    assert profiling.live_category(event) == expected


class _Batches:
    """A loader of fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("n_batches,profile_steps", [(5, 2), (2, 3), (12, 2)])
def test_run_pretrain_profile_window(tmp_path, monkeypatch, n_batches,
                                     profile_steps):
    """--profile_steps N traces N steps from max(0, min(10, len - N)) (the
    JAX loop's window; cut at the epoch's end) into <exp>/trace, and leaves
    the loss and every tensor of the model bit-identical."""
    from coclr_tpu_torch.train.pretrain import run_pretrain

    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    batches = [{"seq": rng.randint(0, 256, (2, 2, 4, 32, 32, 3), np.uint8),
                "aug_base": rng.randint(0, 2, (2, 2)).astype(np.uint8)}
               for _ in range(n_batches)]
    runs = []
    for steps in (0, profile_steps):
        cfg = PretrainConfig(net="tiny", seq_len=4, img_dim=32, batch_size=2,
                             moco_k=8, moco_dim=8, epochs=1, print_freq=100,
                             compute_dtype="float32", profile_steps=steps)
        model, _, info = run_pretrain(cfg, loader=_Batches(batches),
                                      device="cpu")
        runs.append((model.state_dict(), info))
    (plain, plain_info), (traced, info) = runs
    assert plain_info["trace"] is None
    assert info["loss"] == plain_info["loss"]
    assert plain.keys() == traced.keys()
    for key in plain:
        assert torch.equal(plain[key], traced[key]), key

    trace_dir = os.path.join(info["exp_path"], "trace")
    assert os.path.dirname(info["trace"]) == trace_dir
    assert info["trace"].endswith(profiling.TRACE_SUFFIX)
    events, _ = profiling.trace_events(trace_dir)
    steps = sorted(int(n.split("#")[1]) for c, n, _, _ in events
                   if c == "user_annotation" and n.startswith("train#"))
    start = max(0, min(10, n_batches - profile_steps))
    # iterations count from 1
    assert steps == list(range(start + 1,
                               min(start + profile_steps, n_batches) + 1))


@pytest.mark.parametrize("workload", ["finetune", "infonce", "coclr", "k400"])
def test_profile_tool_on_cpu_prints_the_jax_keys(tmp_path, capsys, workload):
    from coclr_tpu_torch.tools import profile_step

    out = profile_step.main([
        "--workload", workload, "--device", "cpu", "--net", "tiny",
        "--batch_size", "2", "--seq_len", "4", "--img_dim", "32", "--steps",
        "2", "--logdir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert line == json.loads(json.dumps(out))
    assert JAX_TOOL_KEYS | {"busy", "launches_per_step"} <= set(line)
    assert line["device"] == "cpu" and line["workload"] == workload
    assert line["steps"] == 2
    assert line["clips_per_step"] == (2 if workload == "finetune" else 4)
    assert os.path.isfile(line["trace_path"])
    assert line["wall_us_per_step"] > 0
    assert set(line["launches_per_step"]) == {
        "host_launch_calls", "device_ops", "jitter_kernel",
        "pool1d_bwd_kernel"}
