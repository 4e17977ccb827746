"""Finetune / linear-probe driver on one card or as one rank of several,
ported from coclr_tpu/evalsuite/driver.py (the reference's
eval/main_classifier.py): experiment-dir naming, the train_what policy, the
eval datasets, the tolerant load of a pretrained backbone, and the train
loop with validation, best accuracy and the epoch checkpoint in the
reference `.pth.tar` layout (with `model_best` and rotation, and --resume).

Under a distributed launcher (parallel/dist.py) each rank trains on its
block of every global batch of batch_size x ranks clips with its own
preprocess and dropout draws, and validates its block of every global
validation batch: the loader pads the final, partial one to a multiple of
the ranks and marks the padding rows not valid, as the JAX driver pads it
for the devices, and the eval step sums over the ranks. Only rank 0 reads
--resume and --pretrain (the model, the optimizer state and the loop
position are then broadcast from it) and writes checkpoints and logs.

Under sequence parallelism (cfg.sp_size, cfg.sph_size; parallel/dist.py)
the ranks form a (data, sp, sph) grid: the loaders shard by data rank, so
the members of a data shard read the same rows (and the same number of
batches, which their collectives need), each member cuts its T chunk of
the clips, and the draws are seeded by the data rank, so that the members
flip, jitter and drop out alike (the JAX step's fold over the data axis
only). The train preprocess runs at full H before the member's H cut;
validation cuts T and H first and sums over the data group.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from coclr_tpu_torch.config import EvalConfig
from coclr_tpu_torch.data import datasets as D
from coclr_tpu_torch.data.loader import Loader
from coclr_tpu_torch.evalsuite import steps
from coclr_tpu_torch.models.classifier import LinearClassifier
from coclr_tpu_torch.parallel import dist
from coclr_tpu_torch.train.lr import step_schedule
from coclr_tpu_torch.train.pretrain import (NullSink, member_chunk,
                                            step_seed, upload)
from coclr_tpu_torch.utils import malloc_trim, prepare_run
from coclr_tpu_torch.utils.checkpoint import (load_checkpoint, make_payload,
                                              resume_from, save_checkpoint)
from coclr_tpu_torch.utils.logging import Logger, PlotterThread
from coclr_tpu_torch.utils.meters import AverageMeter, ProgressMeter

NUM_CLASS = {"ucf101": 101, "hmdb51": 51, "k400": 400,
             "ucf101-f": 101, "hmdb51-f": 51, "k400-f": 400}
_BACKBONE = "encoder_q.0."


def set_path(cfg: EvalConfig):
    """eval/main_classifier.py:795-813 naming contract."""
    if cfg.resume:
        exp_path = os.path.dirname(os.path.dirname(cfg.resume))
    elif cfg.test:
        exp_path = os.path.dirname(os.path.dirname(cfg.test))
    else:
        pt = "_pt=%s" % cfg.pretrain.replace("/", "-") if cfg.pretrain else ""
        opt = "_SGD" if cfg.optim == "sgd" else "_Adam"
        exp_path = (
            "log-eval-{p}/{ds}-{dim}_sp{sp}_{model}_{net}{opt}_bs{bs}_lr{lr}"
            "_dp{dp}_wd{wd}_seq{nseq}_len{len}_ds{dsr}_train-{tw}{pt}").format(
                p=cfg.prefix, ds=cfg.dataset, dim=cfg.img_dim,
                sp=cfg.which_split, model=cfg.model, net=cfg.net, opt=opt,
                bs=cfg.batch_size, lr=cfg.lr, dp=cfg.dropout, wd=cfg.wd,
                nseq=1, len=cfg.seq_len, dsr=cfg.ds, tw=cfg.train_what, pt=pt)
    img_path = os.path.join(exp_path, "img")
    model_path = os.path.join(exp_path, "model")
    os.makedirs(img_path, exist_ok=True)
    os.makedirs(model_path, exist_ok=True)
    return img_path, model_path, exp_path


def build_model(cfg: EvalConfig, sp=None) -> LinearClassifier:
    """The train_what policy (eval/main_classifier.py:101-109): 'last' has
    final_bn and the L2 norm, no dropout, and a frozen backbone; 'ft' and
    'all' have dropout and neither of the others. Drawn from cfg.seed.
    `sp`: the sequence-parallel spec (World.seqpar), or None."""
    last = cfg.train_what == "last"
    return LinearClassifier(
        num_class=NUM_CLASS[cfg.dataset], network=cfg.net,
        dropout=cfg.dropout, use_dropout=not last, use_l2_norm=last,
        use_final_bn=last, freeze_backbone=last, dtype=cfg.dtype,
        gen=torch.Generator().manual_seed(cfg.seed), sp=sp)


def build_eval_dataset(cfg: EvalConfig, mode: str, root: Optional[str] = None,
                       db_path: Optional[str] = None, window: bool = False,
                       policy=None):
    kw = dict(mode=mode, num_frames=cfg.seq_len, ds=cfg.ds,
              which_split=cfg.which_split, return_label=True,
              img_dim=cfg.img_dim, seed=cfg.seed, window=window,
              policy=policy, max_windows=cfg.max_windows)
    if root:
        kw["root"] = root
    make = {"ucf101": D.UCF101LMDB, "ucf101-f": D.UCF101Flow_LMDB,
            "hmdb51": D.HMDB51LMDB, "hmdb51-f": D.HMDB51Flow_LMDB}
    if cfg.dataset not in make:
        raise ValueError(f"unknown eval dataset {cfg.dataset!r}")
    return make[cfg.dataset](data_root=cfg.data_root, db_path=db_path, **kw)


def load_pretrained_backbone(model: LinearClassifier, path: str
                             ) -> LinearClassifier:
    """--pretrain / --test --retrieval: encoder_q.0.* of a pretraining
    `.pth.tar` (the port's or the reference's) -> backbone.*, tolerant:
    tensors whose name or shape has no match are skipped
    (eval/main_classifier.py:246-262)."""
    if not os.path.isfile(path):
        print(f"[Warning] no checkpoint found at '{path}'")
        return model
    sd = load_checkpoint(path)["state_dict"]
    own = model.backbone.state_dict()
    found = {k[len(_BACKBONE):]: v for k, v in sd.items()
             if k.startswith(_BACKBONE)}
    matched = {k: v for k, v in found.items()
               if k in own and own[k].shape == v.shape}
    model.backbone.load_state_dict(matched, strict=False)
    print(f"=> loaded pretrained backbone from '{path}' ({len(matched)} of "
          f"{len(own)} tensors)")
    return model


def _squeeze(batch, world=None, h_cut: bool = False):
    """The dataset's single window [B, 1, T, S, S, 3] -> [B, T, S, S, 3],
    with the labels and the loader's `valid` rows where it pads; under
    sequence parallelism this member's T chunk (dim 1), and with `h_cut`
    its H rows (dim 2) too."""
    out = {"seq": batch["seq"][:, 0], "label": batch["label"]}
    if "valid" in batch:
        out["valid"] = batch["valid"]
    if world is not None:
        out = member_chunk(out, 1, world.sp_rank, world.sp)
        if h_cut:
            out = member_chunk(out, 2, world.sph_rank, world.sph)
    return out


def run_classifier_train(cfg: EvalConfig, train_dataset=None,
                         val_dataset=None, max_steps: int = 0,
                         device="cuda"):
    """Finetune or linear-probe per cfg on `device` ('cuda' unless the
    caller asks for 'cpu'; raises when CUDA is asked for and missing), as
    one rank of several under a distributed launcher. Datasets and
    `max_steps` (per epoch, train and validation) are injectable for
    tests. Returns (model, optimizer, info)."""
    device = prepare_run(device)
    world = dist.maybe_initialize(device, cfg.dist_backend, cfg.num_devices,
                                  cfg.sp_size, cfg.sph_size)
    rank, n_data = (world.data_rank, world.n_data) if world else (0, 1)
    sp = world.seqpar if world else None
    h_chunk = (world.sph_rank, world.sph) if world else (0, 1)
    print(f"=> creating the {cfg.train_what} classifier with '{cfg.net}' "
          f"backbone on {device}" + (f", {world.size} ranks" if world else "")
          + (f" (sequence-parallel x{world.sp})" if sp and world.sp > 1
             else "")
          + (f" (spatial-sequence-parallel x{world.sph})"
             if sp and world.sph > 1 else ""))
    model = build_model(cfg, sp=sp).to(device)
    optimizer = steps.make_classifier_optimizer(cfg, model)

    img_path, model_path, exp_path = set_path(cfg)
    start = [cfg.start_epoch, 1, 0.0]
    if world is not None and not world.primary:
        pass  # the seeded init, replaced by rank 0's below
    elif cfg.resume and os.path.isfile(cfg.resume):
        start = list(resume_from(cfg.resume, model, optimizer))
    elif cfg.pretrain:
        load_pretrained_backbone(model, cfg.pretrain)
    else:
        print("=> train from scratch")
    start_epoch, iteration, best_acc = dist.from_primary(model, optimizer,
                                                         start, world)
    ddp = dist.wrap(model, world) if world else None

    if train_dataset is None:
        train_dataset = build_eval_dataset(cfg, "train")
    if val_dataset is None:
        val_dataset = build_eval_dataset(cfg, "val")
    shard = (rank, n_data) if world else None
    global_batch = cfg.batch_size * n_data
    train_loader = Loader(train_dataset, global_batch,
                          num_workers=cfg.workers, seed=cfg.seed,
                          worker_mode=cfg.worker_mode, process_shard=shard)
    val_loader = Loader(val_dataset, global_batch, shuffle=False,
                        num_workers=cfg.workers, drop_last=False,
                        seed=cfg.seed, worker_mode=cfg.worker_mode,
                        process_shard=shard)

    if world is None or world.primary:
        plotter = PlotterThread(os.path.join(img_path, "train"))
        logger = Logger(img_path)
    else:
        plotter = logger = NullSink()
    gen = torch.Generator(device)
    step_s, val = [], {}
    train_loss = float("nan")
    for epoch in range(start_epoch, cfg.epochs):
        lr = step_schedule(cfg.lr, epoch, cfg.schedule)
        train_loader.set_epoch(epoch)
        meters = {n: AverageMeter(n) for n in ("Time", "Loss", "acc@1",
                                               "acc@5")}
        progress = ProgressMeter(len(train_loader), list(meters.values()),
                                 prefix=f"Epoch:[{epoch}]")
        pending = None  # the previous step's metrics, read one step late

        def drain(pending):
            if pending is not None:
                for name, key in (("Loss", "loss"), ("acc@1", "top1"),
                                  ("acc@5", "top5")):
                    meters[name].update(float(pending[key]), global_batch)

        end = time.time()
        for idx, batch in enumerate(train_loader):
            batch = upload(_squeeze(batch, world), device)
            gen.manual_seed(step_seed(cfg.seed, iteration, rank))
            x = steps.preprocess_train(batch["seq"], gen, cfg.dtype, h_chunk)
            metrics = steps.train_step(model, optimizer, x, batch["label"], lr,
                                       drop_gen=gen, ddp=ddp)
            drain(pending)  # waits for step i-1 while step i runs
            pending = metrics
            step_s.append(time.time() - end)
            meters["Time"].update(step_s[-1])
            end = time.time()
            if idx % cfg.print_freq == 0:
                drain(pending)
                pending = None
                progress.display(idx)
            iteration += 1
            if max_steps and idx + 1 >= max_steps:
                break
        drain(pending)
        malloc_trim()
        train_loss = meters["Loss"].avg
        print(f"train epoch {epoch}: loss {train_loss:.4f} "
              f"top1 {meters['acc@1'].avg:.4f}")
        logger.log(f"train epoch {epoch} loss {train_loss:.4f} "
                   f"top1 {meters['acc@1'].avg:.4f}")
        plotter.add_data("global/loss", train_loss, epoch)
        plotter.add_data("global/top1", meters["acc@1"].avg, epoch)

        val = validate(model, val_loader, cfg, device, max_steps, world)
        print(f"val epoch {epoch}: loss {val['loss']:.4f} "
              f"top1 {val['top1']:.4f}")
        logger.log(f"val epoch {epoch} top1 {val['top1']:.4f}")
        is_best = val["top1"] > best_acc
        best_acc = max(val["top1"], best_acc)
        if world is None or world.primary:
            save_checkpoint(make_payload(model, optimizer, epoch, best_acc,
                                         iteration),
                            is_best=is_best, gap=1,
                            filename=os.path.join(model_path,
                                                  f"epoch{epoch}.pth.tar"))
    plotter.close()
    return model, optimizer, {"best_acc": best_acc, "exp_path": exp_path,
                              "loss": train_loss, "val": val,
                              "step_s": step_s}


def validate(model, loader, cfg: EvalConfig, device, max_steps: int = 0,
             world: Optional[dist.World] = None):
    """Means of the eval step's metrics over the loader's clips (of every
    data shard of `world`; padding rows do not count), with `count`, the
    clips counted."""
    vmeters = {k: AverageMeter(k) for k in ("loss", "top1", "top5")}
    for vidx, batch in enumerate(loader):
        batch = upload(_squeeze(batch, world, h_cut=True), device)
        x = steps.preprocess_eval(batch["seq"], cfg.dtype)
        m, _, _ = steps.eval_step(model, x, batch["label"],
                                  batch.get("valid"),
                                  group=world.data_group if world else None)
        for k, meter in vmeters.items():
            meter.update(float(m[k]), float(m["count"]))
        if max_steps and vidx + 1 >= max_steps:
            break
    out = {k: meter.avg for k, meter in vmeters.items()}
    out["count"] = vmeters["loss"].count
    return out
