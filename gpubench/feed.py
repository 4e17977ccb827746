"""The one traffic generator: a traffic file's parameters -> the dataset
that the port's own Loader reads, and `Feed`, the wrapper around that
Loader which the benchmark hands to run_pretrain and which times the
window.

Feeds (`feed` in the traffic file):
- `resident`: `samples` samples of decoded uint8 clips [2, T, S, S, 3] (RGB,
  and for CoCLR flow beside it), made on the device from the seed in one
  call and held in host memory; an epoch reads `epoch_samples` of them in
  turn (UCF101 split 1 has 9,537 training videos), so the window never
  meets the end of an epoch. Each sample's augmentation flags follow the
  reference's TwoClip / OneClip policy, drawn from the seed.

The Feed yields `warm_steps` batches (set-up: the first `checked_steps`
of them are recorded for the check of `correct`, or only their `keep`
keys, and the rest let the loader's prefetch queue drain), then
synchronises the card, resets its peak memory and opens the window; it stops yielding at the first batch
asked for after `seconds`, when it synchronises again and closes the
window. With `trace_steps`, it then yields that many more batches inside a
torch.profiler window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import trace


def aug_flags(rng: np.random.RandomState, n: int) -> np.ndarray:
    """[n, 2] uint8 base-augmentation flags of the reference's policy: half
    the samples TwoClip (each clip base with p = 0.3), half OneClip (one
    clip base, the other null)."""
    two = rng.rand(n) < 0.5
    pair = rng.rand(n, 2) < 0.3
    first = rng.rand(n) < 0.5
    one = np.stack([first, ~first], 1)
    return np.where(two[:, None], pair, one).astype(np.uint8)


class ResidentClips:
    """The dataset of a resident feed; index i reads sample i % samples."""

    def __init__(self, streams: dict, aug_base, epoch_samples: int):
        self.streams = streams
        self.aug_base = aug_base
        self.samples = len(aug_base)
        self.epoch_samples = epoch_samples

    def __len__(self):
        return self.epoch_samples

    def __getitem__(self, index: int):
        j = index % self.samples
        out = {k: v[j] for k, v in self.streams.items()}
        out["aug_base"] = self.aug_base[j]
        out["index"] = np.int32(index)
        if "seq_flow" in out:
            out["vname"] = np.int32(j)
        return out


def make_resident(traffic: dict, config: dict, seed: int, device):
    """Clips made on `device` from the seed with one generator call a
    stream, then held on the host."""
    gen = torch.Generator(device).manual_seed(seed)
    n, t, s = traffic["samples"], config["seq_len"], config["img_dim"]
    names = ["seq"] if traffic["variant"] == "infonce" else ["seq_rgb",
                                                              "seq_flow"]
    streams = {k: torch.randint(0, 256, (n, 2, t, s, s, 3), dtype=torch.uint8,
                                generator=gen, device=device).cpu().numpy()
               for k in names}
    flags = aug_flags(np.random.RandomState(seed % (1 << 32)), n)
    return ResidentClips(streams, flags, traffic["epoch_samples"])


class Feed:
    """Wraps the port's Loader for run_pretrain: one endless epoch to the
    loop (the Loader's own epochs run on underneath), and the window's
    clock."""

    def __init__(self, loader, warm_steps: int, checked_steps: int,
                 seconds: float, trace_steps: int, on_card: bool,
                 first_epoch: int = 0, keep=None):
        if warm_steps < checked_steps:
            raise ValueError("warm_steps must cover the checked steps")
        self.loader = loader
        self.first_epoch = first_epoch
        self.keep = keep
        self.warm_steps = warm_steps
        self.checked_steps = checked_steps
        self.seconds = seconds
        self.trace_steps = trace_steps
        self.on_card = on_card
        self.recorded = []
        self.epochs = []
        self.waits = []
        self.t_open = self.t_close = None
        self.peak_bytes = None
        self.window = None

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return 1 << 30

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    def _batches(self):
        epoch = self.first_epoch
        while True:
            self.loader.set_epoch(epoch)
            for batch in self.loader:
                yield epoch, batch
            epoch += 1

    def __iter__(self):
        batches = self._batches()
        for i in range(self.warm_steps):
            epoch, batch = next(batches)
            if i < self.checked_steps:
                self.recorded.append(batch if self.keep is None else
                                     {k: batch[k] for k in self.keep})
                self.epochs.append(epoch)
            yield batch
        self._sync()
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()
        self.t_open = time.perf_counter()
        deadline = self.t_open + self.seconds
        while True:
            start = time.perf_counter()
            if start >= deadline:
                break
            _, batch = next(batches)
            self.waits.append(time.perf_counter() - start)
            yield batch
        self._sync()
        self.t_close = time.perf_counter()
        if self.on_card:
            self.peak_bytes = torch.cuda.max_memory_allocated()
        if self.trace_steps:
            yield from self._traced(batches)

    def _traced(self, batches):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        prof = profile(activities=acts)
        prof.__enter__()
        try:
            for _ in range(self.trace_steps):
                with torch.profiler.record_function("gpubench.loader_wait"):
                    _, batch = next(batches)
                yield batch
            self._sync()
        finally:
            prof.__exit__(None, None, None)
        self.window = trace.Window(trace.events_of(prof), self.trace_steps)

    @property
    def steps(self) -> int:
        return len(self.waits)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open
