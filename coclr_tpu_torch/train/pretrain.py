"""Pretraining loop for InfoNCE, UberNCE and CoCLR on one card or as one rank
of several, ported from coclr_tpu/train/pretrain.py: experiment-dir naming,
the init paths (resume, CoCLR's two-checkpoint surgery, weights-only
--pretrain, scratch), meters and logging, the loader, the preprocess ->
step loop, CoCLR's queue-fill gate, checkpoint rotation, the malloc pin and
the preemption guard. The reference's main_nce.py and main_coclr.py loops
are the model.

Under a distributed launcher (parallel/dist.py) each rank takes
`batch_size` clips of a global batch of batch_size x ranks: the loader
gives rank r its block of every global batch, the step averages gradients
and metrics over the ranks and enqueues the global batch, the preprocess
and CoCLR's self-drop draw per rank, and the key shuffle's permutations:
gather's global one drawn alike on every rank, alltoall's local pair per
rank. Only rank 0 reads the init files (the model,
the optimizer state and the loop position are then broadcast from it) and
writes checkpoints and logs; the preemption flag is agreed once per step.

Sequence parallelism (`sp_size`, `sph_size`; ops/seqpar.py,
parallel/dist.py): the ranks form a (data, sp, sph) grid, and the
`sp_size x sph_size` members of a data shard share its clips. The loader
shards by data rank, so the members read the same clips; each member's T
chunk is cut on the host before the upload, so the host-to-device bytes
scale 1 / sp; the augmentation runs on that chunk at full H
(make_pretrain_preprocess's sp_ctx), and each member then keeps its H
rows. The step's draws, the key shuffle's permutations and CoCLR's
self-drop are seeded by the data rank, so the members of a shard draw
alike; the global batch is batch_size x data ranks.

`profile_steps` N > 0 traces N steps of the first epoch with torch.profiler
into <exp>/trace (utils/profiling.py; one gzipped Chrome trace per rank),
from step 10 when the epoch is long enough, else as late as fits, as the
JAX package does; each step sits in a `train#<iteration>` annotation.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from coclr_tpu_torch.config import PretrainConfig
from coclr_tpu_torch.data import datasets as D
from coclr_tpu_torch.data.loader import Loader
from coclr_tpu_torch.models.moco import (MoCo, draw_shuffle,
                                         draw_shuffle_alltoall, shuffle_mode)
from coclr_tpu_torch.ops.augment import make_pretrain_preprocess
from coclr_tpu_torch.parallel import dist
from coclr_tpu_torch.parallel.train_step import (make_optimizer, pretrain_step,
                                                  step_mode)
from coclr_tpu_torch.train import init_surgery
from coclr_tpu_torch.train.lr import get_lr
from coclr_tpu_torch.utils import malloc_trim, prepare_run, profiling
from coclr_tpu_torch.utils.checkpoint import (make_payload, resume_from,
                                              save_checkpoint)
from coclr_tpu_torch.utils.logging import Logger, PlotterThread
from coclr_tpu_torch.utils.meters import AverageMeter, ProgressMeter


def set_path(cfg: PretrainConfig):
    """Experiment-dir naming contract (main_nce.py and main_coclr.py
    set_path)."""
    if cfg.resume:
        exp_path = os.path.dirname(os.path.dirname(cfg.resume))
    elif cfg.test:
        exp_path = os.path.dirname(os.path.dirname(cfg.test))
    elif cfg.model == "coclr":
        exp_path = (
            "log-{p}/{np}{model}-top{topk}{rev}_k{k}_{ds}-{dim}_{net}_"
            "bs{bs}_lr{lr}_seq{nseq}_len{len}_ds{dsr}").format(
                p=cfg.prefix, np=cfg.name_prefix, model=cfg.model,
                topk=cfg.topk, rev="-R" if cfg.reverse else "", k=cfg.moco_k,
                ds=cfg.dataset, dim=cfg.img_dim, net=cfg.net,
                bs=cfg.batch_size, lr=cfg.lr, nseq=cfg.num_seq,
                len=cfg.seq_len, dsr=cfg.ds)
    else:
        pt = ("_pt=%s" % str(cfg.pretrain).replace("/", "-")
              if cfg.pretrain else "")
        exp_path = (
            "log-{p}/{np}{model}_k{k}_{ds}-{dim}_{net}_"
            "bs{bs}_lr{lr}_seq{nseq}_len{len}_ds{dsr}{pt}").format(
                p=cfg.prefix, np=cfg.name_prefix, model=cfg.model,
                k=cfg.moco_k, ds=cfg.dataset, dim=cfg.img_dim, net=cfg.net,
                bs=cfg.batch_size, lr=cfg.lr, nseq=cfg.num_seq,
                len=cfg.seq_len, dsr=cfg.ds, pt=pt)
    img_path = os.path.join(exp_path, "img")
    model_path = os.path.join(exp_path, "model")
    os.makedirs(img_path, exist_ok=True)
    os.makedirs(model_path, exist_ok=True)
    return img_path, model_path, exp_path


def build_dataset(cfg: PretrainConfig):
    """cfg.dataset -> 2-clip dataset: single stream (main_nce.py) or RGB +
    flow with source ids (main_coclr.py)."""
    kw = dict(data_root=cfg.data_root, mode="train", num_frames=cfg.seq_len,
              ds=cfg.ds, return_label=True, img_dim=cfg.img_dim, seed=cfg.seed)
    if cfg.dataset == "ucf101-2clip":
        return D.UCF101LMDB_2CLIP(**kw)
    if cfg.dataset == "ucf101-f-2clip":
        return D.UCF101Flow_LMDB_2CLIP(**kw)
    if cfg.dataset == "k400-2clip":
        return D.K400_LMDB_2CLIP(**kw)
    if cfg.dataset == "k400-f-2clip":
        return D.K400_Flow_LMDB_2CLIP(**kw)
    if cfg.dataset == "ucf101-2stream-2clip":
        return D.UCF101_2STREAM_LMDB_2CLIP(return_source=True, **kw)
    if cfg.dataset == "k400-2stream-2clip":
        return D.K400_2STREAM_LMDB_2CLIP(return_source=True, **kw)
    raise ValueError(f"unknown or not yet ported dataset {cfg.dataset!r}")


_UPLOAD = ("seq", "seq_rgb", "seq_flow", "aug_base", "label", "vname", "valid")


def upload(batch, device):
    """Host numpy batch -> device tensors (pinned, asynchronous on CUDA):
    the clips, the augmentation flags, the labels and source ids that
    UberNCE and CoCLR read, and a validation batch's valid rows."""
    out = {}
    for key in _UPLOAD:
        if key not in batch:
            continue
        t = torch.from_numpy(np.ascontiguousarray(batch[key]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


class _PreemptionGuard:
    """SIGTERM/SIGINT -> finish the in-flight step, checkpoint, exit clean.

    On the first signal a flag is set; the step loop then saves
    `preempt.pth.tar` (epoch wound back one, so --resume re-runs the
    interrupted epoch) and returns. A second signal restores the previous
    handler and raises KeyboardInterrupt. Installed only in the main thread.
    """

    def __init__(self):
        self.flagged = False
        self._prev = {}

    def __enter__(self):
        import signal
        import threading
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def _handle(self, sig, frame):
        import signal
        if self.flagged:
            signal.signal(sig, self._prev.get(sig, signal.SIG_DFL))
            raise KeyboardInterrupt
        self.flagged = True
        print(f"=> caught signal {sig}: will checkpoint and exit after the "
              "in-flight step", flush=True)

    def __exit__(self, *exc):
        import signal
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


class NullSink:
    """The Logger and PlotterThread of a rank other than 0."""

    def log(self, *args):
        pass

    def add_data(self, *args):
        pass

    def close(self):
        pass


# each rank's per-step draws are seeded apart by this stride, rank 0 as one
# process; the shared permutation's seed is offset by SHUFFLE_SEED. Seeds
# live in 32 bits: torch's CPU generator (the host's, and a CPU run's) reads
# only the low 32 bits of a seed, so offsets above them would be dropped
# and every rank would draw alike. Both constants are odd and far apart
# modulo 2^32 (Knuth's multiplicative hash, the fraction of sqrt(2)).
RANK_SEED_STRIDE = 0x9E3779B1
SHUFFLE_SEED = 0x6A09E667


def step_seed(seed: int, iteration: int, rank: int = 0) -> int:
    """The seed of a data rank's draws at `iteration` (rank 0: the
    one-process seed), in 32 bits."""
    return (seed * 1_000_003 + iteration + rank * RANK_SEED_STRIDE) % (1 << 32)


CLIP_DIMS = 3  # clip leaves [B, 2, T, H, W, 3] have at least this many dims


def member_chunk(batch, dim: int, index: int, parts: int):
    """The clip leaves of `batch` (numpy arrays or tensors) cut to chunk
    `index` of `parts` equal chunks along `dim`; other leaves as they are."""
    if parts == 1:
        return batch
    out = dict(batch)
    for key, val in batch.items():
        if val.ndim >= CLIP_DIMS:
            size = val.shape[dim] // parts
            if size * parts != val.shape[dim]:
                raise ValueError(f"{key}: an extent of {val.shape[dim]} on dim "
                                 f"{dim} does not split into {parts} chunks")
            cut = (slice(None),) * dim + (slice(index * size,
                                                (index + 1) * size),)
            out[key] = val[cut]
    return out


def init_model(model, optimizer, cfg, world):
    """--resume, CoCLR's two-checkpoint init, --pretrain or scratch, read by
    rank 0 alone and broadcast to the others with the loop position;
    returns (start epoch, iteration, best_acc)."""
    is_coclr = cfg.model == "coclr"
    start = [cfg.start_epoch, 1, 0.0]
    if world is not None and not world.primary:
        pass  # the seeded scratch init, replaced by rank 0's below
    elif cfg.resume and os.path.isfile(cfg.resume):
        start = list(resume_from(cfg.resume, model, optimizer))
    elif is_coclr and isinstance(cfg.pretrain, (tuple, list)) \
            and list(cfg.pretrain) != ["random", "random"]:
        init_surgery.coclr_surgery(model, tuple(cfg.pretrain))
    elif cfg.pretrain and not is_coclr:
        init_surgery.init_pretrain_weights(model, cfg.pretrain)
    else:
        print("=> train from scratch")
    return tuple(dist.from_primary(model, optimizer, start, world))


class QueueFill:
    """Host mirror of CoCLR's queue-fill gate: the queue rows written so far
    (queue_label != -1) and the ring pointer, read from the device once when
    the loop starts and advanced by each enqueue, so the gate costs no
    device read per step."""

    def __init__(self, model):
        self.filled = (model.queue_label != -1).cpu().numpy()
        self.ptr = int(model.queue_ptr)

    @property
    def full(self) -> bool:
        return bool(self.filled.all())

    def advance(self, rows: int) -> None:
        self.filled[self.ptr:self.ptr + rows] = True
        self.ptr = (self.ptr + rows) % len(self.filled)


def close_trace(window, steps: int) -> str:
    """Close a --profile_steps window (the card is synchronized first, as
    the JAX loop blocks on the step's loss) and return its trace file."""
    window.__exit__(None, None, None)
    print(f"=> device trace ({steps} steps) written to {window.path}",
          flush=True)
    return window.path


def run_pretrain(cfg: PretrainConfig, dataset=None, max_steps: int = 0,
                 loader=None, device="cuda"):
    """Train per cfg on `device` ('cuda' unless the caller asks for 'cpu';
    raises when CUDA is asked for and missing), as one rank of several
    under a distributed launcher. `dataset`, `loader` (this rank's batches)
    and `max_steps` (per epoch) are injectable for tests. Returns
    (model, optimizer, info); info["trace"] is the --profile_steps trace
    file, or None; info["step_graph"] says how each step ran ('eager',
    'capture' or 'replay': parallel/train_step.py step_mode), and on a card
    info["reserved_bytes"] holds the device memory that the caching
    allocator reserves after each step's dispatch, a CUDA graph's private
    pool included (empty off the card)."""
    device = prepare_run(device)
    world = dist.maybe_initialize(device, cfg.dist_backend, cfg.num_devices,
                                  cfg.sp_size, cfg.sph_size)
    ranks = world.size if world else 1
    primary = world is None or world.primary
    # the data shards: every rank of plain data parallelism, or the grid's
    # data axis under sequence parallelism
    rank, n_data = (world.data_rank, world.n_data) if world else (0, 1)
    sp = world.seqpar if world else None
    shuffle = shuffle_mode(cfg.bn_shuffle, cfg.batch_size, n_data)
    is_coclr = cfg.model == "coclr"
    global_batch = cfg.batch_size * n_data
    if cfg.moco_k % global_batch:
        raise ValueError(f"moco_k={cfg.moco_k} must be divisible by the "
                         f"global batch {global_batch}")

    print(f"=> creating {cfg.model} model with '{cfg.net}' backbone on "
          f"{device}" + (f", {ranks} ranks" if world else "")
          + (f" (sequence-parallel x{world.sp})" if sp and world.sp > 1
             else "")
          + (f" (spatial-sequence-parallel x{world.sph})"
             if sp and world.sph > 1 else ""))
    model = MoCo(cfg.net, cfg.moco_dim, cfg.moco_k, cfg.dtype,
                 gen=torch.Generator().manual_seed(cfg.seed),
                 variant=cfg.model, sp=sp).to(device)
    model.train()
    optimizer = make_optimizer(cfg, model.encoder_q.parameters())
    preprocess = make_pretrain_preprocess(cfg)

    img_path, model_path, exp_path = set_path(cfg)
    start_epoch, iteration, best_acc = init_model(model, optimizer, cfg, world)
    fill = QueueFill(model) if is_coclr else None
    ddp = dist.wrap(model.encoder_q, world) if world else None

    if loader is None:
        if dataset is None:
            dataset = build_dataset(cfg)
        loader = Loader(dataset, batch_size=global_batch,
                        num_workers=cfg.workers, seed=cfg.seed,
                        worker_mode=cfg.worker_mode,
                        process_shard=(rank, n_data) if world else None)

    if primary:
        plotter = PlotterThread(os.path.join(img_path, "train"))
        logger = Logger(img_path)
    else:  # the reference logs on rank 0 only
        plotter = logger = NullSink()
    gen = torch.Generator(device)
    self_gen = torch.Generator()  # CoCLR's self-drop draw, on the host
    perm_gen = torch.Generator()  # the key shuffle's permutations, on the host

    train_acc, train_loss = 0.0, float("nan")
    step_s = []
    step_graph = []
    reserved_bytes = []
    trace = None
    preempted = False
    epoch = start_epoch
    with _PreemptionGuard() as guard:
        for epoch in range(start_epoch, cfg.epochs):
            loader.set_epoch(epoch)
            lr = get_lr(cfg, epoch)
            names = ["Time", "Data", "Loss", "acc@1", "acc@5"]
            if cfg.model != "infonce":
                names += ["Self-acc@1", "Self-acc@5"]
            meters = {name: AverageMeter(name) for name in names}
            progress = ProgressMeter(len(loader), list(meters.values()),
                                     prefix=f"Epoch:[{epoch}]")
            tic = end = time.time()
            pending = None  # the previous step's metrics, read one step late

            def drain(pending):
                if pending is not None:
                    meters["Loss"].update(float(pending["loss"]), global_batch)
                    meters["acc@1"].update(float(pending["top1"]), global_batch)
                    meters["acc@5"].update(float(pending["top5"]), global_batch)
                    if "top1_self" in pending:
                        meters["Self-acc@1"].update(float(pending["top1_self"]),
                                                    global_batch)
                        meters["Self-acc@5"].update(float(pending["top5_self"]),
                                                    global_batch)

            # --profile_steps N: the window of the JAX package's loop
            prof_at = -1
            if cfg.profile_steps and epoch == start_epoch:
                prof_at = max(0, min(10, len(loader) - cfg.profile_steps))
            window = None

            steps_this_epoch = 0
            for idx, batch in enumerate(loader):
                meters["Data"].update(time.time() - end)
                if idx == prof_at:
                    window = profiling.device_trace(
                        os.path.join(exp_path, "trace"), device)
                    window.__enter__()
                sp_ctx = None
                if sp is not None and world.sp > 1:  # this member's T chunk
                    t_glob = next(v.shape[2] for v in batch.values()
                                  if v.ndim >= CLIP_DIMS)
                    sp_ctx = (t_glob, world.sp_rank * (t_glob // world.sp))
                    batch = member_chunk(batch, 2, world.sp_rank, world.sp)
                batch = upload(batch, device)
                seed = step_seed(cfg.seed, iteration, rank)
                gen.manual_seed(seed)
                self_gen.manual_seed(seed ^ 0x5EED)
                drop_self = bool(torch.rand((), generator=self_gen) < 0.9)
                perm = None
                if shuffle == "gather":
                    perm_gen.manual_seed((step_seed(cfg.seed, iteration)
                                          + SHUFFLE_SEED) % (1 << 32))
                    perm = draw_shuffle(perm_gen, global_batch)
                elif shuffle == "alltoall":
                    perm_gen.manual_seed((step_seed(cfg.seed, iteration, rank)
                                          + SHUFFLE_SEED) % (1 << 32))
                    perm = draw_shuffle_alltoall(perm_gen, cfg.batch_size)
                with profiling.step_annotation("train", iteration):
                    batch = preprocess(batch, gen, sp_ctx)
                    if sp is not None:  # this member's H rows
                        batch = member_chunk(batch, 3, world.sph_rank,
                                             world.sph)
                    metrics = pretrain_step(
                        model, optimizer, batch, lr, cfg,
                        drop_self=drop_self, update=fill is None or fill.full,
                        ddp=ddp, perm=perm,
                        data_group=world.data_group if world else None)
                step_graph.append(step_mode(model))
                if device.type == "cuda":
                    reserved_bytes.append(torch.cuda.memory_reserved(device))
                if window is not None \
                        and idx == prof_at + cfg.profile_steps - 1:
                    trace = close_trace(window, cfg.profile_steps)
                    window = None
                if fill is not None:
                    fill.advance(global_batch)
                drain(pending)  # waits for step i-1 while step i runs
                pending = metrics
                dt = time.time() - end
                meters["Time"].update(dt)
                step_s.append(dt)
                end = time.time()
                if idx % cfg.print_freq == 0:
                    drain(pending)
                    pending = None
                    progress.display(idx)
                    plotter.add_data("local/loss", meters["Loss"].local_avg,
                                     iteration)
                    plotter.add_data("local/top1", meters["acc@1"].local_avg,
                                     iteration)
                iteration += 1
                steps_this_epoch += 1
                # agreed by every rank, so that none leaves the loop while
                # another waits in the next step's collectives
                if dist.agree_flag(guard.flagged, world):
                    guard.flagged = True
                    drain(pending)
                    pending = None
                    ck = os.path.join(model_path, "preempt.pth.tar")
                    if primary:
                        save_checkpoint(make_payload(model, optimizer,
                                                     epoch - 1, best_acc,
                                                     iteration),
                                        filename=ck, keep_all=True)
                    print(f"=> preemption checkpoint written: {ck} "
                          f"(resume with --resume {ck})", flush=True)
                    preempted = True
                    break
                if max_steps and steps_this_epoch >= max_steps:
                    break
            if window is not None:  # the epoch ended inside the window
                trace = close_trace(window, steps_this_epoch - prof_at)
            drain(pending)
            if preempted:
                break

            malloc_trim()
            modes = step_graph[-steps_this_epoch:] if steps_this_epoch else []
            print(f"Epoch: [{epoch}][{steps_this_epoch}] T-epoch:"
                  f"{time.time() - tic:.2f} captures:{modes.count('capture')} "
                  f"replays:{modes.count('replay')}")
            logger.log(f"epoch {epoch} loss {meters['Loss'].avg:.4f} "
                       f"top1 {meters['acc@1'].avg:.4f}")
            plotter.add_data("global/loss", meters["Loss"].avg, epoch)
            plotter.add_data("global/top1", meters["acc@1"].avg, epoch)
            train_acc = meters["acc@1"].avg
            train_loss = meters["Loss"].avg

            if (epoch % cfg.save_freq == 0) or (epoch == cfg.epochs - 1):
                is_best = train_acc > best_acc
                best_acc = max(train_acc, best_acc)
                if primary:
                    save_checkpoint(
                        make_payload(model, optimizer, epoch, best_acc,
                                     iteration),
                        is_best=is_best, gap=cfg.save_freq,
                        filename=os.path.join(model_path,
                                              f"epoch{epoch}.pth.tar"),
                        keep_all="k400" in cfg.dataset)

    if preempted:
        print(f"Training preempted at ep {epoch}; resume from "
              f"{os.path.join(model_path, 'preempt.pth.tar')}")
    else:
        print(f"Training from ep {start_epoch} to ep {cfg.epochs} finished")
    plotter.close()
    return model, optimizer, {"best_acc": best_acc, "exp_path": exp_path,
                              "train_acc": train_acc, "loss": train_loss,
                              "preempted": preempted, "step_s": step_s,
                              "iteration": iteration, "ranks": ranks,
                              "trace": trace, "step_graph": step_graph,
                              "reserved_bytes": reserved_bytes}
