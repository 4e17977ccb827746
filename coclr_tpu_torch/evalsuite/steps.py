"""Classifier train and eval steps (finetune and linear probe), ported from
coclr_tpu/evalsuite/steps.py (the reference's eval/main_classifier.py).

- The optimizer: Adam, or SGD with momentum 0.9, weight decay as L2 on the
  gradient, and one param group per `_group_scale`: `ft` trains the
  backbone at lr / 10, `all` at lr, and `last` leaves it out (frozen).
- The train preprocess: per-clip hflip at p 0.5 on the uint8 clips, then
  ColorJitter(0.4, 0.4, 0.4, 0.1) at p 0.3 per clip and the normalize in one
  launch of the jitter kernel with gray off. The flip commutes with the
  jitter chain exactly (every op is pixel-local and the contrast mean is
  flip-invariant), so it runs on the 4 x smaller uint8 clips. Draws and
  apply are split (`draw_train_preprocess`, `apply_train_preprocess`).
- The train step: cross-entropy, top-1 / top-5, the update scaled per
  group; the eval step: the same metrics as means over the valid rows.
- As one rank of several (parallel/dist.py), the train step runs the model
  in DistributedDataParallel, whose backward averages the gradients over
  the ranks (the JAX step's pmean; with the backbone frozen only the head
  takes part), and averages the metrics; the eval step sums its metrics
  and count over the ranks before it divides (the JAX step's psum).
- Under sequence parallelism (ops/seqpar.py) a member takes its T chunk of
  its data shard's clips. The train preprocess runs on that chunk at full
  H, since the contrast mean is per frame, and the member cuts its H rows
  after it (`preprocess_train`'s `h_chunk`; the JAX step's slice after its
  H-replicated upload). DDP still averages over every rank, which is exact
  through sp_pmean's transpose, and the replicated metrics' mean over
  every rank is their mean over the data shards. Eval clips are cut in T
  and H before the pixel-local `preprocess_eval`, and the eval step sums
  over the data group only, so each data shard's rows count once.
"""

from __future__ import annotations

from typing import Dict

import torch

from coclr_tpu_torch.models.moco import topk_accuracy
from coclr_tpu_torch.ops.augment import (apply_eval_jitter,
                                         draw_eval_jitter_params, normalize)
from coclr_tpu_torch.parallel.dist import all_mean_dict, all_sum
from coclr_tpu_torch.parallel.train_step import to_ncdhw
from coclr_tpu_torch.train.pretrain import member_chunk

TRAIN_JITTER = dict(p=0.3, strength=(0.4, 0.4, 0.4, 0.1))


def _group_scale(is_backbone: bool, train_what: str) -> float:
    """'last' -> backbone frozen; 'ft' -> backbone at lr / 10; 'all' ->
    uniform (eval/main_classifier.py:125-147)."""
    if train_what == "last":
        return 0.0 if is_backbone else 1.0
    if train_what == "ft":
        return 0.1 if is_backbone else 1.0
    return 1.0


def make_classifier_optimizer(cfg, model) -> torch.optim.Optimizer:
    """Param groups of the backbone and the head, each with its `lr_scale`
    (a group of scale 0 is left out). torch's Adam and SGD add wd * p to
    the gradient as optax add_decayed_weights does, and scale_by_adam /
    trace(0.9) times -lr is their update, so lr * lr_scale per group is
    the JAX package's per-group scaling of the update."""
    groups = []
    for is_backbone in (True, False):
        params = [p for n, p in model.named_parameters()
                  if n.startswith("backbone.") == is_backbone]
        scale = _group_scale(is_backbone, cfg.train_what)
        if scale:
            groups.append({"params": params, "lr_scale": scale,
                           "lr": cfg.lr * scale})
    if cfg.optim == "adam":
        return torch.optim.Adam(groups, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.wd)
    if cfg.optim == "sgd":
        return torch.optim.SGD(groups, lr=cfg.lr, momentum=0.9,
                               weight_decay=cfg.wd)
    raise ValueError(cfg.optim)


def draw_train_preprocess(gen: torch.Generator, b: int) -> Dict[str, torch.Tensor]:
    """The train preprocess's draws for b clips, on gen's device: `do_flip`
    and the jitter draws of `draw_eval_jitter_params`."""
    do_flip = torch.rand(b, generator=gen, device=gen.device) < 0.5
    return dict(draw_eval_jitter_params(gen, b, **TRAIN_JITTER),
                do_flip=do_flip)


def apply_train_preprocess(seq_u8, params: Dict[str, torch.Tensor],
                           dtype=torch.bfloat16):
    """[B, T, S, S, 3] uint8 -> [B, T, S, S, 3] `dtype`: flip the uint8
    clips along W where drawn, then jitter and normalize (one kernel
    launch)."""
    flip = params["do_flip"][:, None, None, None, None]
    x = torch.where(flip, seq_u8.flip(3), seq_u8)
    return apply_eval_jitter(x, params, dtype)


def preprocess_train(seq_u8, gen: torch.Generator, dtype=torch.bfloat16,
                     h_chunk=(0, 1)):
    """The train preprocess of `seq_u8` [B, T, H, W, 3] on gen's draws; with
    `h_chunk` (index, parts) only rows [index * H / parts, (index + 1) * H /
    parts) of the result, cut after the preprocess ran at full H."""
    x = apply_train_preprocess(
        seq_u8, draw_train_preprocess(gen, seq_u8.shape[0]), dtype)
    return member_chunk({"seq": x}, 2, *h_chunk)["seq"]


def preprocess_eval(seq_u8, dtype=torch.bfloat16):
    """uint8 / 255, then normalize, in float32, cast to `dtype`."""
    return normalize(seq_u8.to(torch.float32) / 255.0, dtype=dtype)


def _per_row_loss(logits, label):
    return (torch.logsumexp(logits, dim=1)
            - logits.gather(1, label[:, None].long())[:, 0])


def train_step(model, optimizer, x, label, lr: float,
               drop_gen: torch.Generator = None, ddp=None):
    """One update on preprocessed clips x [B, T, S, S, 3] (JAX layout) with
    integer labels [B]. The model is put in train mode (its backbone stays
    in eval mode when frozen). `ddp`: the model in DistributedDataParallel
    over the ranks' process group, or None for one process. Returns
    device-tensor metrics {'loss', 'top1', 'top5'}, averaged over the
    ranks."""
    model.train()
    logits, _ = (model if ddp is None else ddp)(to_ncdhw(x), drop_gen)
    loss = _per_row_loss(logits, label).mean()
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_scale"]
    optimizer.step()
    top1, top5 = topk_accuracy(logits.detach(), label.long())
    return all_mean_dict({"loss": loss.detach(), "top1": top1, "top5": top5},
                         None if ddp is None else ddp.process_group)


@torch.no_grad()
def eval_step(model, x, label, valid=None, group=None):
    """Metrics of eval-mode logits on preprocessed clips x, as exact means
    over the rows where `valid` ([B] of 0 / 1, default all) is 1, so padded
    rows do not count; with a process `group`, over the valid rows of
    every rank. Returns (metrics {'loss', 'top1', 'top5', 'count'}, this
    rank's logits, feature). Under sequence parallelism `group` is the
    data group: the members of a data shard hold the same rows."""
    model.eval()
    logits, feat = model(to_ncdhw(x))
    label = label.long()
    valid = (torch.ones(logits.shape[0], device=logits.device)
             if valid is None else valid.to(torch.float32))
    correct = logits.topk(5, dim=1).indices == label[:, None]
    sums = torch.stack([torch.sum(_per_row_loss(logits, label) * valid),
                        torch.sum(correct[:, :1].any(dim=1).float() * valid),
                        torch.sum(correct.any(dim=1).float() * valid),
                        valid.sum()])
    sums = all_sum(sums, group)
    count = sums[3]
    metrics = {k: sums[i] / torch.clamp_min(count, 1.0)
               for i, k in enumerate(("loss", "top1", "top5"))}
    metrics["count"] = count
    return metrics, logits, feat
