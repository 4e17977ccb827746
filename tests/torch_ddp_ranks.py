"""Rank processes for the port's data- and sequence-parallel tests
(tests/test_torch_ddp.py, tests/test_torch_seqpar.py, tests/test_torch_cuda.py).

`RankPool(world, tmpdir)` starts `world` processes (forked from a server
that has imported torch) that join one gloo
process group (a file store under `tmpdir`) through
coclr_tpu_torch.parallel.dist and then serve tasks: `pool.run(name,
kwargs)` runs the task `name` on every rank (kwargs the same for all, or
one dict per rank) and returns the results in rank order, raising if any
rank failed. Inputs and results are numpy arrays and Python values. This
module imports torch and coclr_tpu_torch only, never jax.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import signal
import traceback

import numpy as np

TIMEOUT_S = 300
# imported once in the fork server, so that each rank process starts from
# a process that has them (torch and DistributedDataParallel take about
# 3.5 s to import on one core) rather than importing them itself
PRELOAD = ["torch", "torch.distributed.tensor", "torch.nn.parallel",
           "coclr_tpu_torch.parallel.dist", "coclr_tpu_torch.evalsuite.driver",
           "coclr_tpu_torch.models.moco"]


class RankPool:
    def __init__(self, world: int, tmpdir: str):
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(PRELOAD)
        init = "file://" + os.path.join(tmpdir, "ddp_store")
        self.world = world
        self.inq = [ctx.Queue() for _ in range(world)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(target=serve,
                                  args=(r, world, init, self.inq[r], self.outq),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self._collect()  # each rank reports once its group is up

    def _collect(self):
        out = [None] * self.world
        for _ in range(self.world):
            try:
                rank, ok, value = self.outq.get(timeout=TIMEOUT_S)
            except queue.Empty:
                self.close()
                raise TimeoutError("a rank did not answer within "
                                   f"{TIMEOUT_S} s")
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        return out

    def run(self, task: str, kwargs):
        per_rank = kwargs if isinstance(kwargs, list) else [kwargs] * self.world
        for q, kw in zip(self.inq, per_rank):
            q.put((task, kw))
        return self._collect()

    def close(self):
        for q in self.inq:
            q.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()


def serve(rank, world, init_method, inq, outq):
    import torch

    from coclr_tpu_torch.parallel import dist as pdist

    try:
        torch.set_num_threads(1)
        w = pdist.initialize(torch.device("cpu"), "gloo", rank, world,
                             init_method=init_method)
        solo = torch.distributed.new_group([0], backend="gloo")
        outq.put((rank, True, None))
    except BaseException:
        outq.put((rank, False, traceback.format_exc()))
        return
    while True:
        item = inq.get()
        if item is None:
            # every result is delivered: leave without the interpreter's
            # teardown of torch and the process groups (about a second a
            # process on one core)
            outq.close()
            outq.join_thread()
            os._exit(0)
        name, kwargs = item
        try:
            outq.put((rank, True, TASKS[name](w, solo, **kwargs)))
        except BaseException:
            outq.put((rank, False, traceback.format_exc()))


def _np_state(module):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def _tensors(batch, dev):
    import torch

    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in batch.items()}


def _on(world, dev):
    """The World with its tensors on `dev` (the group stays gloo)."""
    import torch

    return dataclasses.replace(world, device=torch.device(dev))


def task_pretrain(world, solo, *, variant, sd, cfg, batches, perms, drops,
                  lr, device="cpu"):
    """Steps of `variant` from state dict `sd`, each rank on its block of
    every global batch, with the key shuffle's permutations `perms[i]`
    (gather: the shared one; alltoall: one pair per rank) and this rank's
    self-drop `drops[i][rank]`. Returns the metrics and the state
    after each step."""
    import torch

    from coclr_tpu_torch.config import PretrainConfig
    from coclr_tpu_torch.kernels import pool
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.parallel import dist as pdist
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step
    from coclr_tpu_torch.utils import prepare_run

    prepare_run(device)  # float32 convolutions and matmuls without TF32
    launches = pool.KERNEL.launches
    cfg = PretrainConfig(**cfg)
    model = MoCo(cfg.net, cfg.moco_dim, cfg.moco_k, cfg.dtype, variant=variant)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    model.to(device).train()
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    ddp = pdist.wrap(model.encoder_q, _on(world, device))
    metrics, states, moments = [], [], []
    for batch, perm, drop in zip(batches, perms, drops):
        b = len(next(iter(batch.values()))) // world.size
        mine = _tensors({k: v[world.rank * b:(world.rank + 1) * b]
                         for k, v in batch.items()}, device)
        if cfg.bn_shuffle == "alltoall":  # this rank's pair
            perm = tuple(torch.from_numpy(p) for p in perm[world.rank])
        else:
            perm = torch.from_numpy(perm)
        m = pretrain_step(model, opt, mine, lr, cfg, drop_self=drop[world.rank],
                          update=True, ddp=ddp, perm=perm)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_np_state(model))
        moments.append({"encoder_q." + n: opt.state[p]["exp_avg"].cpu().numpy()
                        .copy() for n, p in model.encoder_q.named_parameters()})
    return {"metrics": metrics, "states": states, "moments": moments,
            "launches": pool.KERNEL.launches - launches}


def task_world_one(world, solo, *, variant, sd, cfg, batches, lr):
    """On rank 0: the same steps as one rank of a one-rank gloo group
    (DistributedDataParallel over it) and as one plain process; returns
    both (metrics, state)."""
    import torch

    from coclr_tpu_torch.config import PretrainConfig
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.parallel.dist import wrap
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step

    if world.rank != 0:
        return None
    cfg = PretrainConfig(**cfg)
    out = {}
    for name in ("group", "none"):
        model = MoCo(cfg.net, cfg.moco_dim, cfg.moco_k, cfg.dtype,
                     variant=variant)
        model.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}, strict=True)
        model.train()
        opt = make_optimizer(cfg, model.encoder_q.parameters())
        ddp = None
        if name == "group":
            ddp = wrap(model.encoder_q, dataclasses.replace(world, group=solo))
        metrics = []
        for batch in batches:
            m = pretrain_step(model, opt, _tensors(batch, "cpu"), lr, cfg,
                              drop_self=True, update=True, ddp=ddp,
                              perm=torch.arange(len(batch["seq"])))
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": metrics, "state": _np_state(model)}
    return out


def task_alltoall(world, solo, *, rows, perms, sd, cfg, keys_in, gather_perm):
    """The alltoall shuffle of this rank's block of `rows` under its pair
    perms[rank], and its unshuffle; then the key encode of this rank's
    block of `keys_in` (a batch the ranks do not divide) under
    --bn_shuffle alltoall and under gather, with the gather permutation
    `gather_perm`. Returns the shuffled and restored rows and both keys."""
    import torch

    from coclr_tpu_torch.config import PretrainConfig
    from coclr_tpu_torch.models import moco
    from coclr_tpu_torch.parallel import train_step

    b = len(rows) // world.size
    mine = torch.from_numpy(rows[world.rank * b:(world.rank + 1) * b])
    pair = tuple(torch.from_numpy(p) for p in perms[world.rank])
    shuffled = moco.batch_shuffle_alltoall(mine, pair, world.group)
    restored = moco.batch_unshuffle_alltoall(shuffled, pair, world.group)

    cfg = PretrainConfig(**cfg)
    model = moco.MoCo(cfg.net, cfg.moco_dim, cfg.moco_k, cfg.dtype)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    model.train()
    b = len(keys_in) // world.size
    x2 = torch.from_numpy(keys_in[world.rank * b:(world.rank + 1) * b])
    with torch.no_grad():
        keys = {mode: train_step._encode_keys(
            model, x2, world.group, torch.from_numpy(gather_perm), mode).numpy()
            for mode in ("alltoall", "gather")}
    return {"shuffled": shuffled.numpy(), "restored": restored.numpy(),
            "keys": keys}


class _Samples:
    """An in-memory dataset of samples {'seq': [1, T, S, S, 3], 'label'}."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def task_classifier(world, solo, *, cfg, sd, xs, labels, lr, val_samples):
    """`validate` over this rank's block of every global batch of
    `val_samples` (the loader pads the last), then train steps on this
    rank's preprocessed clips xs[i][rank]. Returns the validation means,
    the train metrics and the state."""
    import torch

    from coclr_tpu_torch.config import EvalConfig
    from coclr_tpu_torch.data.loader import Loader
    from coclr_tpu_torch.evalsuite import driver, steps
    from coclr_tpu_torch.parallel.dist import wrap

    cfg = EvalConfig(**cfg)
    model = driver.build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    loader = Loader(_Samples(val_samples), cfg.batch_size * world.size,
                    shuffle=False, drop_last=False, num_workers=1,
                    process_shard=(world.rank, world.size))
    rows = [list(np.asarray(b["valid"])) for b in loader]
    val = driver.validate(model, loader, cfg, torch.device("cpu"),
                          world=world)
    opt = steps.make_classifier_optimizer(cfg, model)
    ddp = wrap(model, world)
    metrics = []
    for x, label in zip(xs, labels):
        m = steps.train_step(model, opt, torch.from_numpy(x[world.rank]),
                             torch.from_numpy(label[world.rank]).long(), lr,
                             ddp=ddp)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"val": val, "valid_rows": rows, "metrics": metrics,
            "state": _np_state(model)}


class _PreemptingLoader:
    """Fixed batches; on `signal_rank` this process sends itself SIGTERM
    while the batch `at` is fetched, as a scheduler preempting one node."""

    def __init__(self, batches, rank, signal_rank, at):
        self.batches, self.rank = batches, rank
        self.signal_rank, self.at = signal_rank, at

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, batch in enumerate(self.batches):
            if i == self.at and self.rank == self.signal_rank:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def task_run_pretrain(world, solo, *, cfg, workdir, batches=None,
                      signal_rank=-1, at=-1):
    """run_pretrain in `workdir` on this rank's `batches` (a loader that
    preempts rank `signal_rank` at batch `at`). Returns its info, or the
    name and message of the exception it raised."""
    from coclr_tpu_torch.config import PretrainConfig
    from coclr_tpu_torch.train.pretrain import run_pretrain

    import hashlib

    os.chdir(workdir)
    loader = (None if batches is None else
              _PreemptingLoader(batches, world.rank, signal_rank, at))
    try:
        model, opt, info = run_pretrain(PretrainConfig(**cfg), loader=loader,
                                        device="cpu")
    except Exception as e:  # the caller checks which ranks raised what
        return {"raised": type(e).__name__, "message": str(e)}
    digest = hashlib.sha256()
    for t in list(model.encoder_q.parameters()) + [model.queue,
                                                   model.queue_ptr]:
        digest.update(t.detach().numpy().tobytes())
    out = {k: info[k] for k in ("preempted", "iteration", "step_s",
                                "exp_path", "ranks")}
    out["digest"] = digest.hexdigest()
    out["adam_steps"] = sorted({int(s["step"]) for s in opt.state.values()})
    return out


def _seq_world(world, sp, sph):
    from coclr_tpu_torch.parallel import dist as pdist

    return pdist.with_seqpar(world, sp, sph)


def _member(x, world, t_dim, h_dim):
    """This rank's T and H chunk of x (whole on every rank)."""
    from coclr_tpu_torch.train.pretrain import member_chunk

    out = member_chunk({"x": x}, t_dim, world.sp_rank, world.sp)["x"]
    return member_chunk({"x": out}, h_dim, world.sph_rank, world.sph)["x"]


def task_sp_prims(world, solo, *, sp, sph, x, cts, lo, hi):
    """The ops/seqpar.py primitives named in cts on this rank's T and H
    chunk of x [B, C, T, H, W] (the same x in every data shard) in a (data,
    sp, sph) grid, the local loss sum(y * ct) with ct this rank's block of
    cts[name] (the cotangent of the members' outputs concatenated along T
    over sp and along H over sph), and its gradient: {name: (y, dx)}."""
    import torch

    from coclr_tpu_torch.ops import seqpar

    w = _seq_world(world, sp, sph)
    spec = w.seqpar
    prims = {
        "temporal_halo": lambda a: seqpar.temporal_halo(a, lo, hi, spec.t),
        "spatial_halo": lambda a: seqpar.spatial_halo(a, lo, hi, spec.h),
        "gather_h": lambda a: seqpar.gather_h(a, spec.h),
        "sp_pmean": lambda a: seqpar.sp_pmean(a, spec),
    }
    out = {}
    mine = _member(torch.from_numpy(x), w, 2, 3)
    for name in cts:
        a = mine.clone().requires_grad_(True)
        y = prims[name](a)
        # this member's block of the cotangent of the members' outputs
        t_n, h_n = y.shape[2], y.shape[3]
        ct = torch.from_numpy(cts[name][:, :, w.sp_rank * t_n:
                                        (w.sp_rank + 1) * t_n,
                                        w.sph_rank * h_n:
                                        (w.sph_rank + 1) * h_n])
        (y * ct).sum().backward()
        out[name] = (y.detach().numpy(), a.grad.numpy())
    return out


def task_sp_encoder(world, solo, *, sp, sph, net, sd, x, train, dim):
    """ProjectionEncoder(net) with the state dict sd on this rank's T and H
    chunk of x [B, C, T, H, W] in a (data, sp, sph) grid (data shard 0
    only; the others return None), train or eval mode, float32: the output, the state after the forward, the input
    gradient and, on rank 0, the gradients of sum(out ** 2) averaged over
    the members (the world-mean of a data shard; the same on every
    member)."""
    import torch

    from coclr_tpu_torch.models.encoder import ProjectionEncoder
    from coclr_tpu_torch.ops.seqpar import pmean_group, sp_pmean

    w = _seq_world(world, sp, sph)
    if w.data_rank:  # the members of one data shard suffice
        return None
    enc = ProjectionEncoder(net, dim, torch.float32, sp=w.seqpar)
    enc.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    enc.train(train)
    mine = _member(torch.from_numpy(x), w, 2, 3).clone().requires_grad_(True)
    out = enc(mine)
    (out ** 2).sum().backward()
    assert pmean_group(w.seqpar) is not None
    grads = {n: sp_pmean(p.grad, w.seqpar).numpy()
             for n, p in enc.named_parameters()}
    if world.rank:
        grads = None
    return {"out": out.detach().numpy(), "state": _np_state(enc),
            "grads": grads, "dx": mine.grad.numpy()}


def task_sp_pretrain(world, solo, *, sp, sph, variant, sd, cfg, batches,
                     perms, drops, lr):
    """Steps of `variant` in a (data, sp, sph) grid from state dict sd:
    each rank on its data shard's block of every global batch, cut to its
    T and H chunk, with the gather permutation perms[i] and its data
    shard's self-drop drops[i][d]. Returns the metrics, the state and
    Adam's first moments after each step."""
    import torch

    from coclr_tpu_torch.config import PretrainConfig
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.parallel import dist as pdist
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step

    w = _seq_world(world, sp, sph)
    cfg = PretrainConfig(**cfg)
    model = MoCo(cfg.net, cfg.moco_dim, cfg.moco_k, cfg.dtype, variant=variant,
                 sp=w.seqpar)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    model.train()
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    ddp = pdist.wrap(model.encoder_q, w)
    metrics, states, moments = [], [], []
    for batch, perm, drop in zip(batches, perms, drops):
        b = len(next(iter(batch.values()))) // w.n_data
        d = w.data_rank
        mine = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
        mine = {k: _member(v, w, 2, 3) if v.ndim >= 3 else v
                for k, v in mine.items()}
        m = pretrain_step(model, opt, _tensors(mine, "cpu"), lr, cfg,
                          drop_self=drop[d], update=True, ddp=ddp,
                          perm=torch.from_numpy(perm),
                          data_group=w.data_group)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_np_state(model))
        moments.append({"encoder_q." + n: opt.state[p]["exp_avg"].numpy()
                        .copy() for n, p in model.encoder_q.named_parameters()})
    return {"metrics": metrics, "states": states, "moments": moments}


def task_sp_run_pretrain(world, solo, *, cfg, workdir, batches):
    """run_pretrain in `workdir` with cfg's sp_size and sph_size, this rank
    fed its data shard's `batches[d]`; records the seed of each step's
    generator, the self-drop, the key shuffle's permutation and the clips
    the step got. Returns them with the model's digest and the
    sequence-parallel line it printed."""
    import contextlib
    import hashlib
    import io

    from coclr_tpu_torch.config import PretrainConfig
    from coclr_tpu_torch.train import pretrain

    os.chdir(workdir)
    seen = {"seeds": [], "drops": [], "perms": [], "shapes": []}
    make_pre, step = pretrain.make_pretrain_preprocess, pretrain.pretrain_step

    def recording_pre(cfg_):
        fn = make_pre(cfg_)

        def pre(batch, gen, sp_ctx=None):
            seen["seeds"].append(gen.initial_seed())
            return fn(batch, gen, sp_ctx)
        return pre

    def recording_step(model, opt, batch, lr, cfg_, **kw):
        seen["drops"].append(kw["drop_self"])
        seen["perms"].append(None if kw["perm"] is None
                             else kw["perm"].tolist())
        seen["shapes"].append(list(batch["seq"].shape))
        return step(model, opt, batch, lr, cfg_, **kw)

    pretrain.make_pretrain_preprocess = recording_pre
    pretrain.pretrain_step = recording_step
    printed = io.StringIO()
    try:
        w = _seq_world(world, PretrainConfig(**cfg).sp_size,
                       PretrainConfig(**cfg).sph_size)
        loader = _PreemptingLoader(batches[w.data_rank], world.rank, -1, -1)
        with contextlib.redirect_stdout(printed):
            model, _, info = pretrain.run_pretrain(
                PretrainConfig(**cfg), loader=loader, device="cpu")
    finally:
        pretrain.make_pretrain_preprocess = make_pre
        pretrain.pretrain_step = step
    digest = hashlib.sha256()
    for t in list(model.encoder_q.parameters()) + [model.queue,
                                                   model.queue_ptr]:
        digest.update(t.detach().numpy().tobytes())
    return dict(seen, digest=digest.hexdigest(), printed=printed.getvalue(),
                iteration=info["iteration"], exp_path=info["exp_path"],
                queue_ptr=int(model.queue_ptr))


def task_sp_classifier(world, solo, *, sp, sph, cfg, sd, num_class, lr,
                       xs=(), labels=(), val=None):
    """The classifier (train_what per cfg, num_class classes) in a (data,
    sp, sph) grid from state dict sd: a train step on each of `xs`, the
    preprocessed global batches [n_data x B, T, S, S, 3] with their
    labels, each rank on its data shard's block cut to its T and H chunk
    (DDP over every rank); then, with `val` (a global uint8 batch with
    labels and valid rows), the eval step on the same block, cut in T and
    H before preprocess_eval and summed over the data group. Returns the
    metrics and the state after the steps, the eval metrics and this
    rank's logits."""
    import torch

    from coclr_tpu_torch.config import EvalConfig
    from coclr_tpu_torch.evalsuite import steps
    from coclr_tpu_torch.models.classifier import LinearClassifier
    from coclr_tpu_torch.parallel import dist as pdist

    w = _seq_world(world, sp, sph)
    cfg = EvalConfig(**cfg)
    last = cfg.train_what == "last"  # driver.build_model's policy
    model = LinearClassifier(
        num_class=num_class, network=cfg.net, dropout=cfg.dropout,
        use_dropout=not last, use_l2_norm=last, use_final_bn=last,
        freeze_backbone=last, dtype=cfg.dtype, sp=w.seqpar)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    opt = steps.make_classifier_optimizer(cfg, model)
    ddp = pdist.wrap(model, w)
    d = w.data_rank

    def mine(batch):
        b = len(batch["label"]) // w.n_data
        out = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
        out["seq"] = np.ascontiguousarray(_member(out["seq"], w, 1, 2))
        return out

    metrics = []
    for x, label in zip(xs, labels):
        block = mine({"seq": x, "label": label})
        m = steps.train_step(model, opt, torch.from_numpy(block["seq"]),
                             torch.from_numpy(block["label"]).long(), lr,
                             ddp=ddp)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "state": _np_state(model)}
    if val is not None:
        block = _tensors(mine(val), "cpu")
        m, logits, _ = steps.eval_step(
            model, steps.preprocess_eval(block["seq"], cfg.dtype),
            block["label"], block["valid"], group=w.data_group)
        out["eval"] = {k: float(v) for k, v in m.items()}
        out["logits"] = logits.numpy()
    return out


def task_run_classifier(world, solo, *, cfg, workdir, train, val,
                        max_steps=0):
    """run_classifier_train in `workdir` on in-memory datasets of samples
    {'seq': [1, T, S, S, 3] uint8, 'label'}. Returns its validation means,
    step count, the state, a digest of the parameters and what rank 0
    printed, or the name and message of the exception it raised."""
    import contextlib
    import hashlib
    import io

    from coclr_tpu_torch.config import EvalConfig
    from coclr_tpu_torch.evalsuite.driver import run_classifier_train

    os.chdir(workdir)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            model, _, info = run_classifier_train(
                EvalConfig(**cfg), _Samples(train), _Samples(val),
                max_steps=max_steps, device="cpu")
    except Exception as e:  # the caller checks which ranks raised what
        return {"raised": type(e).__name__, "message": str(e)}
    digest = hashlib.sha256()
    for t in model.parameters():
        digest.update(t.detach().numpy().tobytes())
    return {"val": info["val"], "steps": len(info["step_s"]),
            "state": _np_state(model), "digest": digest.hexdigest(),
            "printed": printed.getvalue(), "exp_path": info["exp_path"]}


TASKS = {"pretrain": task_pretrain, "alltoall": task_alltoall,
         "world_one": task_world_one,
         "classifier": task_classifier, "run_pretrain": task_run_pretrain,
         "sp_prims": task_sp_prims, "sp_encoder": task_sp_encoder,
         "sp_pretrain": task_sp_pretrain,
         "sp_run_pretrain": task_sp_run_pretrain,
         "sp_classifier": task_sp_classifier,
         "run_classifier": task_run_classifier}
