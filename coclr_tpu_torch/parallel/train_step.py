"""The pretrain step for InfoNCE, UberNCE and CoCLR, on one card or as one
rank of several, ported from coclr_tpu/parallel/train_step.py::
_pretrain_step.

EMA of the key encoder, key encode (train-mode BN, no gradients), for CoCLR
the frozen sampler's encode of the other modality (eval mode), the masks
from the queues as they were before this step's enqueue, query encode,
logits over the queue, the variant's loss, Adam, then the ring enqueue, in
the reference's order (main_nce.py, main_coclr.py, model/pretrain.py).

Two decisions the JAX step takes on the device arrive here as host values,
so the step never waits for the card:
- `drop_self`: CoCLR's one draw per step of `random.random() < 0.9`, which
  zeroes the self-positive where other positives exist;
- `update`: CoCLR's queue-fill gate. While any queue_label is -1 the JAX
  step computes the update and keeps the old parameters and optimizer
  state; here the backward still runs and `optimizer.step()` is skipped,
  which gives the same state. The loop keeps the gate's host mirror
  (train/pretrain.py QueueFill).

As one rank of several (the JAX step under shard_map over the `data`
axis), the step takes encoder_q wrapped in DistributedDataParallel
(parallel/dist.py wrap), whose backward averages the gradients over the
ranks (the JAX step's pmean), and the permutations of the key shuffle:
the keys are shuffled across ranks around the key encode (--bn_shuffle
gather or alltoall; none skips it), the metrics are averaged over the
ranks, and the enqueue writes the keys, labels, sampler keys and video
names of every rank in rank order. CoCLR's masks still come from this
rank's rows against the queues as they were before the enqueue, and
`drop_self` is this rank's own draw.

Under sequence parallelism (ops/seqpar.py) the clips are this member's T
and H chunk, and the encoders are built with the spec. The key shuffle and
the enqueue run over the data group (`data_group`), the ranks that hold
the same chunk of different clips. The gradients are averaged over every
rank by DistributedDataParallel over the world group: the one uniform mean
of the JAX step's pmean over all mesh axes (coclr_tpu/parallel/
train_step.py), exact because a backbone member's gradient comes out sp x
its share and the head's is replicated (ops/seqpar.py). DDP is kept over a
separate all-reduce after the backward because it overlaps the reduction
with the backward, as the data-parallel path already does. The metrics are
averaged over the world, where the members of a clip hold the same ones.
"""

from __future__ import annotations

import torch

from coclr_tpu_torch.models import moco
from coclr_tpu_torch.parallel.dist import all_mean_dict, size_of


def make_optimizer(cfg, params):
    """Adam with L2 weight decay added to the gradient and lr applied outside
    the moments: optax add_decayed_weights(wd) + scale_by_adam(0.9, 0.999,
    1e-8) followed by -lr is torch.optim.Adam with weight_decay=wd."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.wd)


def to_ncdhw(clip):
    """[B, T, H, W, C] clips (the JAX layout) -> contiguous [B, C, T, H, W]."""
    return clip.permute(0, 4, 1, 2, 3).contiguous()


def _encode(encoder, x):
    return moco.l2_normalize(encoder(x).to(torch.float32))


def _encode_keys(model, x2, group, perm, bn_shuffle):
    """The key encoder's l2-normalised keys of x2, shuffled across the ranks
    of `group` around the encode in the form moco.shuffle_mode gives."""
    mode = moco.shuffle_mode(bn_shuffle, x2.shape[0], size_of(group))
    if mode == "none":
        return _encode(model.encoder_k, x2)
    if perm is None:
        raise ValueError("the key batch shuffle needs its permutations")
    if mode == "alltoall":
        x2 = moco.batch_shuffle_alltoall(x2, perm, group)
        return moco.batch_unshuffle_alltoall(_encode(model.encoder_k, x2),
                                             perm, group)
    x2, inv = moco.batch_shuffle(x2, perm, group)
    return moco.batch_unshuffle(_encode(model.encoder_k, x2), inv, group)


def pretrain_step(model: moco.MoCo, optimizer, batch, lr: float, cfg, *,
                  drop_self: bool = True, update: bool = True, ddp=None,
                  perm=None, data_group=None):
    """One step of cfg.model on an augmented batch: {'seq': [B, 2, T, H, W,
    C]} (+ 'label' for UberNCE), {'seq_rgb', 'seq_flow', 'vname'} for
    CoCLR, or for InfoNCE the clips tensor alone. Updates model and
    optimizer in place; returns device-tensor metrics {'loss', 'top1',
    'top5'} (+ 'top1_self', 'top5_self' for UberNCE and CoCLR, and
    'queue_is_full' for CoCLR), averaged over the ranks.

    `ddp`: model.encoder_q in DistributedDataParallel over the ranks'
    process group, or None for one process; `perm`: what the key shuffle
    needs with 2 or more ranks: the shared permutation of the global key
    batch (moco.draw_shuffle) for gather, this rank's pair of local
    permutations (moco.draw_shuffle_alltoall) for alltoall;
    `data_group`: the group of the key shuffle and the enqueue under
    sequence parallelism (World.data_group), else ddp's process group."""
    variant = model.variant
    world = None if ddp is None else ddp.process_group
    group = world if data_group is None else data_group
    if not isinstance(batch, dict):
        batch = {"seq": batch}
    if variant == "coclr":
        primary, other = ((batch["seq_flow"], batch["seq_rgb"]) if cfg.reverse
                          else (batch["seq_rgb"], batch["seq_flow"]))
        x1, x2 = to_ncdhw(primary[:, 0]), to_ncdhw(primary[:, 1])
        f2 = to_ncdhw(other[:, 1])
    else:
        x1, x2 = to_ncdhw(batch["seq"][:, 0]), to_ncdhw(batch["seq"][:, 1])

    params_q = list(model.encoder_q.parameters())
    moco.momentum_update(params_q, list(model.encoder_k.parameters()),
                         cfg.moco_m)
    with torch.no_grad():
        k = _encode_keys(model, x2, group, perm, cfg.bn_shuffle)
        if variant == "coclr":
            kf = _encode(model.sampler, f2)
            mask = moco.coclr_mask(kf, batch["vname"], model.queue_second,
                                   model.queue_vname, model.queue_label,
                                   cfg.topk)
        elif variant == "ubernce":
            mask = moco.ubernce_mask(batch["label"], model.queue_label)

    q = _encode(model.encoder_q if ddp is None else ddp, x1)
    logits = moco.moco_logits(q, k, model.queue, cfg.moco_t)
    if variant == "infonce":
        loss = moco.infonce_loss(logits)
    elif variant == "ubernce":
        loss = moco.ubernce_loss(logits, mask)
    else:
        used = mask
        if drop_self:
            used = mask.clone()
            used[:, 0] = torch.where(mask.sum(dim=1) != 1, 0.0, mask[:, 0])
        loss = moco.multi_nce_loss(logits, used)

    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if update:
        for param_group in optimizer.param_groups:
            param_group["lr"] = lr
        optimizer.step()

    logits = logits.detach()
    zeros = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    metrics = {"loss": loss.detach()}
    if variant == "infonce":
        metrics["top1"], metrics["top5"] = moco.topk_accuracy(logits, zeros)
        moco.dequeue_and_enqueue(model.queue, model.queue_ptr, k, group=group)
        return all_mean_dict(metrics, world)
    metrics["top1"], metrics["top5"] = moco.mask_accuracy(logits, mask)
    metrics["top1_self"], metrics["top5_self"] = moco.topk_accuracy(logits, zeros)
    if variant == "ubernce":
        moco.dequeue_and_enqueue(model.queue, model.queue_ptr, k,
                                 queue_label=model.queue_label,
                                 labels=batch["label"], group=group)
    else:
        metrics["queue_is_full"] = torch.all(
            model.queue_label != -1).to(torch.float32)
        moco.dequeue_and_enqueue(model.queue, model.queue_ptr, k,
                                 queue_label=model.queue_label,
                                 queue_second=model.queue_second,
                                 keys_second=kf, queue_vname=model.queue_vname,
                                 vnames=batch["vname"], group=group)
    return all_mean_dict(metrics, world)
