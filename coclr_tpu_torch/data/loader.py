"""Prefetching batch loaders: threaded and multi-process.

Replaces the reference's FastDataLoader (persistent torch worker processes,
utils/utils.py:233-260) + DistributedSampler (main_nce.py:414-424): one
process feeds all chips. Two worker modes:

- "thread" (default): a thread pool decodes samples; fine whenever the hot
  work releases the GIL (cv2 JPEG decode, the native C++ plane).
- "process": persistent forked worker processes with shared-memory sample
  staging — the reference's process-worker model (utils/utils.py:233-260),
  for many-core hosts where the pure-Python fallback plane (msgpack parse,
  lmdb_format.py reads) would GIL-throttle a thread pool. Workers write
  decoded sample arrays into a SharedMemory slab (no pickling of frame
  data); the parent reassembles batches in deterministic order, so both
  modes yield bitwise-identical batches for the same (seed, epoch).

Shuffle semantics: per-epoch reshuffle with seed=epoch like
DistributedSampler.set_epoch (main_nce.py:255-260); drop_last=True.

With `process_shard` and drop_last=False (a validation split across ranks)
the final, partial global batch is padded to a multiple of the process
count with its last sample, as coclr_tpu/evalsuite/driver.py pads it for
the devices, and every batch carries `valid` (float32, 0 on the padding
rows).
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import queue
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import shared_memory
from typing import Dict, Iterator, List, Optional

import numpy as np


def collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples])
    return out


def _sample_layout(sample: Dict[str, np.ndarray]):
    """(layout, total_bytes): per-key (offset, shape, dtype) in a flat slot."""
    layout = {}
    off = 0
    for key in sorted(sample):
        arr = np.asarray(sample[key])
        nbytes = int(arr.nbytes)
        layout[key] = (off, arr.shape, arr.dtype.str)
        off += -(-nbytes // 64) * 64  # 64B-align each field
    return layout, off


def _pack_sample(sample, layout, buf: memoryview):
    for key, (off, shape, dtype) in layout.items():
        arr = np.asarray(sample[key])  # validate BEFORE ascontiguousarray
        if arr.shape != tuple(shape) or arr.dtype.str != dtype:  # (it promotes 0-d to (1,))
            # variable-shaped dataset (e.g. window-mode eval: per-video
            # [n_windows, ...]) — shared-memory slots are fixed-size
            raise ValueError(
                f"sample field {key!r} has shape {arr.shape}/{arr.dtype} but "
                f"the shared-memory slot layout was sized for {shape}/{dtype};"
                " worker_mode='process' requires fixed-shape samples — use "
                "worker_mode='thread' for variable-shaped datasets")
        arr = np.ascontiguousarray(arr)
        n = arr.nbytes
        buf[off:off + n] = arr.view(np.uint8).reshape(-1).data


def _unpack_sample(layout, buf: memoryview) -> Dict[str, np.ndarray]:
    out = {}
    for key, (off, shape, dtype) in layout.items():
        n = int(np.dtype(dtype).itemsize * np.prod(shape, dtype=np.int64))
        out[key] = (np.frombuffer(buf[off:off + n], dtype=np.dtype(dtype))
                    .reshape(shape))
    return out


def _process_worker(dataset, idx_q, res_q, shm_name, slot_bytes, layout):
    """Worker loop: decode dataset[index] into shared-memory slot `slot`."""
    try:  # inherited native decode pool threads died at fork(); rebuild lazily
        from coclr_tpu_torch.data import native
        lib = native.get_lib()
        if lib is not None:
            lib.cdp_fork_reset()
    except Exception:
        pass
    try:  # per-process parallelism comes from the worker pool itself
        import cv2
        cv2.setNumThreads(0)
    except Exception:
        pass
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        while True:
            task = idx_q.get()
            if task is None:
                return
            gen, pos, index, epoch, slot = task
            try:
                if epoch != getattr(dataset, "epoch", epoch):
                    dataset.set_epoch(epoch)
                sample = dataset[index]
                view = shm.buf[slot * slot_bytes:(slot + 1) * slot_bytes]
                _pack_sample(sample, layout, view)
                del view  # release before any shm.close()
                res_q.put((gen, pos, slot, None))
            except BaseException:
                res_q.put((gen, pos, slot, traceback.format_exc()))
    finally:
        try:
            shm.close()
        except BufferError:
            pass  # a live view would only leak at process exit anyway


class _ProcessPool:
    """Persistent forked workers + one SharedMemory slab of sample slots.

    Kept alive across epochs (the reference's FastDataLoader keeps its
    torch workers alive the same way, utils/utils.py:233-246)."""

    def __init__(self, dataset, num_workers: int, n_slots: int):
        probe = dataset[0]  # also warms metadata before the fork
        self.layout, self.slot_bytes = _sample_layout(probe)
        # guard against variable-shaped datasets (window-mode eval returns
        # [n_windows, ...] per video): slots are fixed-size, so a drifting
        # shape would corrupt or crash opaquely mid-epoch. Probe a couple of
        # other indices up front to fail fast; _pack_sample re-validates
        # every sample in the workers as the complete guard.
        for probe_idx in {len(dataset) // 2, len(dataset) - 1} - {0}:
            other_layout, _ = _sample_layout(dataset[probe_idx])
            if other_layout != self.layout:
                raise ValueError(
                    f"dataset samples are not fixed-shape (index 0 -> "
                    f"{self.layout}, index {probe_idx} -> {other_layout}); "
                    "worker_mode='process' stages samples in fixed-size "
                    "shared-memory slots — use worker_mode='thread' instead")
        self.n_slots = n_slots
        ctx = mp.get_context("fork")  # LMDB mmaps/handles are inherited r/o
        self.shm = shared_memory.SharedMemory(
            create=True, size=max(1, self.slot_bytes * n_slots))
        self.idx_q = ctx.Queue()
        self.res_q = ctx.Queue()
        self.procs = [
            ctx.Process(target=_process_worker,
                        args=(dataset, self.idx_q, self.res_q, self.shm.name,
                              self.slot_bytes, self.layout),
                        daemon=True)
            for _ in range(num_workers)]
        for p in self.procs:
            p.start()
        self.free: List[int] = list(range(n_slots))
        self.ready: Dict[int, int] = {}  # pos -> slot, current generation
        self.gen = 0  # bumped per __iter__; stale results are reclaimed
        self._closed = False
        atexit.register(self.close)

    def slot_view(self, slot: int) -> memoryview:
        return self.shm.buf[slot * self.slot_bytes:(slot + 1) * self.slot_bytes]

    def close(self):
        if self._closed:
            return
        self._closed = True
        for _ in self.procs:
            try:
                self.idx_q.put(None)
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        try:
            self.shm.close()
        except BufferError:
            pass  # consumer still holds a view; OS reclaims at exit
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class Loader:
    """worker_mode: 'thread' (GIL-releasing decode paths) or 'process'
    (forked workers + shared-memory staging)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 3,
                 worker_mode: str = "thread",
                 process_shard: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}")
        self.worker_mode = worker_mode
        # multi-host: (rank, world) — every host draws the SAME per-epoch
        # order (seed+epoch PRNG) and loads only its CONTIGUOUS block of
        # rows from each global batch, matching the contiguous data-axis
        # device block the host's chips own in the (process-major) mesh.
        # The reference shards by DistributedSampler rank-interleaving
        # (main_nce.py:414-424, indices[rank::world]) — a deliberate
        # divergence: block layout is what makes the assembled global
        # jax.Array equal the single-host batch element-for-element.
        if process_shard is not None:
            rank, world = process_shard
            if not (0 <= rank < world):
                raise ValueError(f"process_shard rank {rank} not in [0,{world})")
            if batch_size % world:
                raise ValueError(
                    f"global batch {batch_size} not divisible by "
                    f"process count {world}")
        self.process_shard = process_shard
        self._bs = (batch_size // process_shard[1]
                    if process_shard else batch_size)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._ppool: Optional[_ProcessPool] = None
        if worker_mode == "thread":
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def close(self):
        if self._ppool is not None:
            self._ppool.close()
            self._ppool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self):
        """This host's sample order and the size of each of its batches: the
        full epoch order, or (multi-host) its contiguous block of each
        global batch. Returns (ids, sizes, valid): `valid` is None, or
        (with process_shard and drop_last=False) 1.0 per real row and 0.0
        per padding row of the padded final batch."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        nb = len(self)
        full = n // self.batch_size
        rest = n - full * self.batch_size if nb > full else 0
        if self.process_shard is None:
            sizes = [self._bs] * full + ([rest] if rest else [])
            return idx[:sum(sizes)], sizes, None
        rank, world = self.process_shard
        lo = rank * self._bs
        blocks = [idx[:full * self.batch_size].reshape(
            full, self.batch_size)[:, lo:lo + self._bs].ravel()]
        sizes = [self._bs] * full
        valid = [np.ones(full * self._bs, np.float32)]
        if rest:
            per = -(-rest // world)
            tail = idx[full * self.batch_size:]
            tail = np.concatenate([tail, np.repeat(tail[-1:], per * world - rest)])
            blocks.append(tail[rank * per:(rank + 1) * per])
            sizes.append(per)
            valid.append((rank * per + np.arange(per) < rest)
                         .astype(np.float32))
        return (np.concatenate(blocks), sizes,
                None if self.drop_last else np.concatenate(valid))

    def _batch(self, samples, valid, start: int, size: int):
        batch = collate(samples)
        if valid is not None:
            batch["valid"] = valid[start:start + size]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.worker_mode == "process":
            yield from self._iter_process()
        else:
            yield from self._iter_thread()

    def _iter_thread(self):
        order, sizes, valid = self._order()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                start = 0
                for size in sizes:
                    if stop.is_set():
                        return
                    ids = order[start:start + size]
                    samples = list(self._pool.map(self.dataset.__getitem__, ids))
                    q.put(self._batch(samples, valid, start, size))
                    start += size
                q.put(None)
            except BaseException as e:  # surface worker errors to consumer
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def _iter_process(self):
        if self._ppool is None:
            n_slots = self._bs * (self.prefetch + 1)
            self._ppool = _ProcessPool(self.dataset, self.num_workers, n_slots)
        pool = self._ppool
        pool.gen += 1
        gen = pool.gen
        pool.free.extend(pool.ready.values())  # abandoned iterator's holds
        pool.ready.clear()
        ready = pool.ready
        order, sizes, valid = self._order()
        total = len(order)
        dispatched = 0

        def recv(block: bool):
            """Take one result; reclaim slots of stale-generation results.
            Blocking waits poll with a timeout and check worker liveness, so
            a worker killed without posting (OOM, native crash) raises
            instead of hanging the parent forever."""
            while True:
                try:
                    rgen, rpos, slot, err = pool.res_q.get(
                        block=block, timeout=5.0 if block else None)
                    break
                except queue.Empty:
                    if not block:
                        return False
                    dead = [p.pid for p in pool.procs if not p.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f"loader worker process(es) {dead} died without "
                            "posting a result (OOM kill or a crash in the "
                            "native decode plane)")
            if rgen != gen:  # abandoned earlier iterator's in-flight work
                pool.free.append(slot)
                return True
            if err is not None:
                pool.free.append(slot)
                raise RuntimeError(
                    f"loader worker failed on sample {rpos}:\n{err}")
            ready[rpos] = slot
            return True

        def dispatch_pending():
            # enqueue work for every free slot WITHOUT draining the result
            # queue — callable from the blocking wait loop below, where a
            # reclaimed stale slot must be re-dispatched immediately or a
            # starved first batch deadlocks (an abandoned mid-epoch iterator
            # leaves its tasks in flight; run_pretrain's max_steps break does
            # this every epoch)
            nonlocal dispatched
            while dispatched < total and pool.free:
                slot = pool.free.pop()
                pool.idx_q.put((gen, dispatched, int(order[dispatched]),
                                self.epoch, slot))
                dispatched += 1

        def dispatch():
            while recv(block=False):  # reclaim any stale slots first
                pass
            dispatch_pending()

        dispatch()
        start = 0
        for size in sizes:
            samples = []
            batch_slots: List[int] = []
            for pos in range(start, start + size):
                while pos not in ready:
                    recv(block=True)
                    dispatch_pending()
                slot = ready.pop(pos)
                samples.append(_unpack_sample(pool.layout,
                                              pool.slot_view(slot)))
                batch_slots.append(slot)
            # np.stack copies out of the shm views
            batch = self._batch(samples, valid, start, size)
            start += size
            del samples  # drop memoryview-backed arrays before slot reuse
            pool.free.extend(batch_slots)
            dispatch()
            yield batch
