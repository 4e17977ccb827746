"""The pretrain step for InfoNCE, UberNCE and CoCLR, on one card or as one
rank of several, ported from coclr_tpu/parallel/train_step.py::
_pretrain_step.

EMA of the key encoder, key encode (train-mode BN, no gradients), for CoCLR
the frozen sampler's encode of the other modality (eval mode), the masks
from the queues as they were before this step's enqueue, query encode,
logits over the queue, the variant's loss and its backward, the ring
enqueue, then Adam (main_nce.py, main_coclr.py, model/pretrain.py; Adam
steps before the enqueue there, which reads nothing Adam writes).

Two decisions the JAX step takes on the device arrive here as host values,
so the step never waits for the card:
- `drop_self`: CoCLR's one draw per step of `random.random() < 0.9`, which
  zeroes the self-positive where other positives exist (the step writes
  it into a 0-d device flag, which the body reads);
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

On one card in one process (`graph_engages`) all of the step but Adam is
replayed as a CUDA graph (`StepGraph`), so the host makes one graph
launch and Adam's few multi-tensor launches a step in place of the step's
thousands of kernel launches. Both paths run one body, `step_body`, on
[B, C, T, H, W] clips: the eager path on the copies that `to_ncdhw` makes,
the graph on static buffers that the same permuted copy fills. CoCLR's
`drop_self` reaches the body as a 0-d device flag on both paths. Adam
(`adam_step`) runs eagerly after the body on both: torch's capturable Adam,
which a graph could hold, works out its bias correction on the device in
float32 with two kernels a parameter tensor (S3D has 235), where the eager
Adam does it on the host. Outside the graph the update stays the eager
path's bit for bit, and neither the learning rate nor CoCLR's gate is baked
into the graph. Every other call (the CPU, DDP ranks, sequence-parallel
ranks) runs eagerly, op by op.
"""

from __future__ import annotations

import weakref

import torch

from coclr_tpu_torch.models import moco
from coclr_tpu_torch.parallel.dist import all_mean_dict, size_of

# PyTorch's whole-network capture recipe: eager calls on a side stream
# before the capture, so that cuDNN has settled its choices and the
# caching allocator its blocks by the time the graph records them.
WARMUP_CALLS = 3
CLIPS = ("x1", "x2", "f2")


def make_optimizer(cfg, params):
    """Adam with L2 weight decay added to the gradient and lr applied outside
    the moments: optax add_decayed_weights(wd) + scale_by_adam(0.9, 0.999,
    1e-8) followed by -lr is torch.optim.Adam with weight_decay=wd."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.wd)


def to_ncdhw(clip):
    """[B, T, H, W, C] clips (the JAX layout) -> contiguous [B, C, T, H, W]."""
    return clip.permute(0, 4, 1, 2, 3).contiguous()


def step_inputs(batch, cfg, variant):
    """What the step reads of a batch: the clips `x1` and `x2` (the primary
    stream's two views) and for CoCLR `f2` (the other stream's second
    view), each [B, T, H, W, C] as the batch holds it; UberNCE's `label`,
    CoCLR's `vname`."""
    if not isinstance(batch, dict):
        batch = {"seq": batch}
    if variant == "coclr":
        primary, other = ((batch["seq_flow"], batch["seq_rgb"]) if cfg.reverse
                          else (batch["seq_rgb"], batch["seq_flow"]))
        return {"x1": primary[:, 0], "x2": primary[:, 1], "f2": other[:, 1],
                "vname": batch["vname"]}
    inputs = {"x1": batch["seq"][:, 0], "x2": batch["seq"][:, 1]}
    if variant == "ubernce":
        inputs["label"] = batch["label"]
    return inputs


def graph_engages(model: moco.MoCo, device, ddp=None, perm=None,
                  data_group=None) -> bool:
    """Whether pretrain_step runs as a CUDA graph: clips on a card, one
    process (no DDP wrapper, no key-shuffle permutations, no data group, no
    process group) and encoders without a sequence-parallel spec."""
    return (torch.device(device).type == "cuda" and ddp is None
            and perm is None and data_group is None
            and not (torch.distributed.is_available()
                     and torch.distributed.is_initialized())
            and model.encoder_q.sp is None)


def drop_self_positive(mask, drop):
    """CoCLR's self-drop: where `drop` (a 0-d bool tensor) is true, the
    self-positive (column 0) of each row with another positive is zeroed."""
    used = mask.clone()
    used[:, 0] = torch.where(drop & (mask.sum(dim=1) != 1), 0.0, mask[:, 0])
    return used


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


def step_body(model: moco.MoCo, optimizer, x, drop, cfg, ddp=None,
              perm=None, group=None):
    """The step but Adam on `x`: step_inputs' clips as [B, C, T, H, W]
    beside its other inputs; `drop` CoCLR's self-drop flag. The one body of
    the eager path and the graph: it leaves the gradients in the
    parameters' .grad for adam_step."""
    variant = model.variant
    world = None if ddp is None else ddp.process_group
    params_q = list(model.encoder_q.parameters())
    moco.momentum_update(params_q, list(model.encoder_k.parameters()),
                         cfg.moco_m)
    with torch.no_grad():
        k = _encode_keys(model, x["x2"], group, perm, cfg.bn_shuffle)
        if variant == "coclr":
            kf = _encode(model.sampler, x["f2"])
            mask = moco.coclr_mask(kf, x["vname"], model.queue_second,
                                   model.queue_vname, model.queue_label,
                                   cfg.topk)
        elif variant == "ubernce":
            mask = moco.ubernce_mask(x["label"], model.queue_label)

    q = _encode(model.encoder_q if ddp is None else ddp, x["x1"])
    logits = moco.moco_logits(q, k, model.queue, cfg.moco_t)
    if variant == "infonce":
        loss = moco.infonce_loss(logits)
    elif variant == "ubernce":
        loss = moco.ubernce_loss(logits, mask)
    else:
        loss = moco.multi_nce_loss(logits, drop_self_positive(mask, drop))

    optimizer.zero_grad(set_to_none=True)
    loss.backward()

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
                                 labels=x["label"], group=group)
    else:
        metrics["queue_is_full"] = torch.all(
            model.queue_label != -1).to(torch.float32)
        moco.dequeue_and_enqueue(model.queue, model.queue_ptr, k,
                                 queue_label=model.queue_label,
                                 queue_second=model.queue_second,
                                 keys_second=kf, queue_vname=model.queue_vname,
                                 vnames=x["vname"], group=group)
    return all_mean_dict(metrics, world)


def adam_step(optimizer, lr: float, update: bool) -> None:
    """Adam at `lr` on the gradients step_body left, unless CoCLR's gate is
    closed (`update` false)."""
    if update:
        for param_group in optimizer.param_groups:
            param_group["lr"] = lr
        optimizer.step()


def eager_step(model: moco.MoCo, optimizer, batch, lr: float, cfg, *,
               drop_self: bool = True, update: bool = True, ddp=None,
               perm=None, data_group=None):
    """pretrain_step op by op, as every call off the graph path runs it."""
    world = None if ddp is None else ddp.process_group
    inputs = step_inputs(batch, cfg, model.variant)
    x = {k: to_ncdhw(v) if k in CLIPS else v for k, v in inputs.items()}
    drop = None
    if model.variant == "coclr":
        drop = torch.full((), drop_self, dtype=torch.bool,
                          device=x["x1"].device)
    metrics = step_body(model, optimizer, x, drop, cfg, ddp, perm,
                        world if data_group is None else data_group)
    adam_step(optimizer, lr, update)
    return metrics


def step_key(model: moco.MoCo, inputs, cfg) -> tuple:
    """What a captured step holds fixed: the variant, every input's shape,
    dtype and device, and the step's constants. The learning rate and
    CoCLR's gate reach Adam only, which runs outside the graph."""
    shapes = tuple((k, tuple(v.shape), v.dtype, v.device)
                   for k, v in inputs.items())
    return (model.variant, shapes, bool(cfg.reverse), int(cfg.topk),
            float(cfg.moco_t), float(cfg.moco_m))


class StepGraph:
    """One model's step_body as a CUDA graph, after PyTorch's whole-network
    capture recipe: the first WARMUP_CALLS calls for its key run the body
    eagerly on a side stream, the next captures it into a CUDAGraph, and
    every call from that one on copies its inputs into the static buffers
    and replays the graph. The permuted copy into the static clips is the
    copy that to_ncdhw makes on the eager path. Adam follows on the
    caller's stream, on the gradients the body left (after the capture,
    buffers of the graph's pool that every replay rewrites).

    A replay runs no Python: the kernel wrappers' launch counts
    (kernels/build.py) count the warm-ups and the capture, and a device
    trace shows the replays' kernels. Metrics come back as clones of the
    graph's outputs, which the next replay overwrites."""

    def __init__(self, key, inputs):
        self.key = key
        self.device = inputs["x1"].device
        self.static = {
            k: torch.empty(v.permute(0, 4, 1, 2, 3).shape if k in CLIPS
                           else v.shape, dtype=v.dtype, device=self.device)
            for k, v in inputs.items()}
        self.drop = torch.zeros((), dtype=torch.bool, device=self.device)
        self.calls = 0
        self.mode = "eager"
        self.stream = self.graph = self.outputs = None

    def release(self) -> None:
        """Let go of the graph, its private memory pool and the buffers."""
        self.graph = self.outputs = self.static = self.drop = None

    def __call__(self, model, optimizer, inputs, drop_self: bool, lr: float,
                 cfg, update: bool):
        for k, v in inputs.items():
            self.static[k].copy_(v.permute(0, 4, 1, 2, 3) if k in CLIPS else v)
        if model.variant == "coclr":
            self.drop.fill_(drop_self)

        def run():
            return step_body(model, optimizer, self.static, self.drop, cfg)

        with torch.cuda.device(self.device):
            if self.calls < WARMUP_CALLS:
                self.calls += 1
                self.mode = "eager"
                metrics = self._warm_up(run)
            else:
                if self.graph is None:
                    self.mode = "capture"
                    self._capture(run, optimizer)
                else:
                    self.mode = "replay"
                self.graph.replay()
                metrics = {k: v.clone() for k, v in self.outputs.items()}
            adam_step(optimizer, lr, update)
        return metrics

    def _warm_up(self, run):
        current = torch.cuda.current_stream()
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = run()
        current.wait_stream(self.stream)
        return out

    def _capture(self, run, optimizer):
        graph = torch.cuda.CUDAGraph()
        # the gradients are then made inside the graph's pool
        optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            self.outputs = run()
        self.graph = graph


# each model's StepGraph; it dies with the model
_GRAPHS = weakref.WeakKeyDictionary()


def graph_for(model: moco.MoCo, key, inputs) -> StepGraph:
    """The model's StepGraph for `key`. A model keeps one: a new key
    releases the old graph (and the gradients in its pool) first, so two
    private pools are never held at once."""
    graph = _GRAPHS.get(model)
    if graph is not None and graph.key == key:
        return graph
    release_graph(model)
    graph = _GRAPHS[model] = StepGraph(key, inputs)
    return graph


def release_graph(model: moco.MoCo) -> None:
    graph = _GRAPHS.pop(model, None)
    if graph is not None:
        graph.release()
        model.encoder_q.zero_grad(set_to_none=True)


def step_mode(model: moco.MoCo) -> str:
    """How the last pretrain_step on `model` ran: 'eager', 'capture' or
    'replay'."""
    graph = _GRAPHS.get(model)
    return "eager" if graph is None else graph.mode


def pretrain_step(model: moco.MoCo, optimizer, batch, lr: float, cfg, *,
                  drop_self: bool = True, update: bool = True, ddp=None,
                  perm=None, data_group=None):
    """One step of cfg.model on an augmented batch: {'seq': [B, 2, T, H, W,
    C]} (+ 'label' for UberNCE), {'seq_rgb', 'seq_flow', 'vname'} for
    CoCLR, or for InfoNCE the clips tensor alone. Updates model and
    optimizer in place; returns device-tensor metrics {'loss', 'top1',
    'top5'} (+ 'top1_self', 'top5_self' for UberNCE and CoCLR, and
    'queue_is_full' for CoCLR), averaged over the ranks. Where
    graph_engages, the model's StepGraph runs it (step_mode says how);
    otherwise eager_step.

    `ddp`: model.encoder_q in DistributedDataParallel over the ranks'
    process group, or None for one process; `perm`: what the key shuffle
    needs with 2 or more ranks: the shared permutation of the global key
    batch (moco.draw_shuffle) for gather, this rank's pair of local
    permutations (moco.draw_shuffle_alltoall) for alltoall;
    `data_group`: the group of the key shuffle and the enqueue under
    sequence parallelism (World.data_group), else ddp's process group."""
    inputs = step_inputs(batch, cfg, model.variant)
    if not graph_engages(model, inputs["x1"].device, ddp, perm, data_group):
        release_graph(model)
        return eager_step(model, optimizer, batch, lr, cfg,
                          drop_self=drop_self, update=update, ddp=ddp,
                          perm=perm, data_group=data_group)
    key = step_key(model, inputs, cfg)
    return graph_for(model, key, inputs)(model, optimizer, inputs, drop_self,
                                         lr, cfg, update)
