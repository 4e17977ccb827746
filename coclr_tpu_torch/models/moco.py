"""MoCo core for InfoNCE, UberNCE and CoCLR, ported from
coclr_tpu/models/moco.py.

`MoCo` holds the state in the reference's key grammar (model/pretrain.py):
encoder_q, encoder_k (the EMA copy, no gradients), `queue` and
`queue_ptr`; UberNCE adds `queue_label`; CoCLR adds the frozen `sampler`,
`queue_second`, `queue_vname` and `queue_label` (its is-filled flag). The
queues are stored [K, dim] so the enqueue writes rows; the reference's
.pth.tar layout [dim, K] is produced at checkpoint time
(utils/checkpoint.py). The queue pointer stays on the device and the
enqueue indexes with it, so a step never waits for the card.

Across ranks (parallel/dist.py) the key batch is shuffled before the key
encode and unshuffled after it, so that each rank's BatchNorm statistics
cover keys drawn from every rank, and the enqueue writes the keys of all
ranks in rank order. Two forms, as in coclr_tpu/models/moco.py:
`--bn_shuffle gather` (`batch_shuffle` / `batch_unshuffle`: all-gather the
global batch, take this rank's slice of one shared permutation) and
`alltoall` (`batch_shuffle_alltoall` / `batch_unshuffle_alltoall`: a local
permutation, an all-to-all of equal shards, a second local permutation,
so each row crosses the wire once). In one process the shuffle is skipped:
a permutation within the one BN batch changes neither the BN statistics
nor the unshuffled keys (coclr_tpu/models/moco.py encode_keys); alltoall
with a batch that the ranks do not divide falls back to gather
(`shuffle_mode`).

Under sequence parallelism the shuffle and the enqueue run over the data
group (parallel/dist.py), the ranks that hold the same T and H chunk of
different clips, never over the members that share a clip.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from coclr_tpu_torch.models.encoder import ProjectionEncoder, init_params_
from coclr_tpu_torch.parallel.dist import all_to_all_rows, gather_rows, rank_of

NEG_INF = -1e30
VARIANTS = ("infonce", "ubernce", "coclr")
BN_SHUFFLES = ("gather", "alltoall", "none")


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                               eps)


class MoCo(nn.Module):
    """encoder_q / encoder_k + the negative queue, and per `variant` the
    buffers of coclr_tpu's init_moco_state. Parameters and queues are drawn
    from `gen` (on the CPU), then the module can be moved.

    The CoCLR sampler has no gradients and stays in eval mode whatever
    `train()` is asked for: the JAX package applies it with train=False, so
    its BatchNorm normalises with, and never updates, its running
    statistics.

    `sp`: the sequence-parallel spec of the three encoders (ops/seqpar.py);
    the members that share a clip hold identical keys, queues and state."""

    def __init__(self, network: str = "s3d", dim: int = 128, K: int = 2048,
                 dtype=torch.bfloat16, gen: torch.Generator = None,
                 variant: str = "infonce", sp=None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown MoCo variant {variant!r}")
        if gen is None:
            gen = torch.Generator().manual_seed(0)
        self.variant = variant
        self.encoder_q = ProjectionEncoder(network, dim, dtype, sp)
        init_params_(self.encoder_q, gen)
        self.encoder_k = copy.deepcopy(self.encoder_q)
        self.encoder_k.requires_grad_(False)
        self.register_buffer(
            "queue", l2_normalize(torch.randn(K, dim, generator=gen)))
        self.register_buffer("queue_ptr", torch.zeros(1, dtype=torch.long))
        if variant in ("ubernce", "coclr"):
            self.register_buffer("queue_label",
                                 torch.full((K,), -1, dtype=torch.long))
        if variant == "coclr":
            self.register_buffer("queue_vname",
                                 torch.full((K,), -1, dtype=torch.long))
            self.register_buffer(
                "queue_second", l2_normalize(torch.randn(K, dim, generator=gen)))
            self.sampler = ProjectionEncoder(network, dim, dtype, sp)
            init_params_(self.sampler, gen)
            self.sampler.requires_grad_(False)
            self.sampler.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        if self.variant == "coclr":
            self.sampler.eval()
        return self


@torch.no_grad()
def momentum_update(params_q, params_k, m: float) -> None:
    """params_k <- m * params_k + (1 - m) * params_q, in place."""
    torch._foreach_mul_(params_k, m)
    torch._foreach_add_(params_k, params_q, alpha=1.0 - m)


def moco_logits(q, k, queue, temperature: float):
    """[l_pos, l_neg] / T. q, k: [b, d]; queue: [K, d]."""
    l_pos = torch.sum(q * k, dim=1, keepdim=True)
    l_neg = q @ queue.t()
    return torch.cat([l_pos, l_neg], dim=1) / temperature


def infonce_loss(logits):
    """Cross-entropy with target 0."""
    return torch.mean(torch.logsumexp(logits, dim=1) - logits[:, 0])


def ubernce_loss(logits, mask):
    """Mean over positives of -log-softmax, mean over the batch."""
    logp = torch.log_softmax(logits, dim=1)
    return torch.mean(-torch.sum(logp * mask, dim=1) / torch.sum(mask, dim=1))


def multi_nce_loss(logits, mask):
    """-log of the softmax mass on the positives (main_coclr.py)."""
    logp = torch.log_softmax(logits, dim=1)
    pos = torch.where(mask > 0, logp, NEG_INF)
    return torch.mean(-torch.logsumexp(pos, dim=1))


def ubernce_mask(k_label, queue_label):
    """[1, k_label == queue_label] as float32 [b, 1 + K]."""
    m = (k_label[:, None] == queue_label[None, :]).to(torch.float32)
    return torch.cat([torch.ones_like(m[:, :1]), m], dim=1)


def coclr_mask(kf, k_vsource, queue_second, queue_vname, queue_label,
               topk: int):
    """Sibling-source mask, joined by the sampler's top-k neighbours in
    `queue_second` once the queue is full (no queue_label is -1). Float32
    [b, 1 + K]. The fullness test stays on the device."""
    mask = k_vsource[:, None] == queue_vname[None, :]
    if topk != 0:
        sim = (kf @ queue_second.t()).masked_fill(mask, NEG_INF)
        idx = sim.topk(topk, dim=1).indices
        mined = torch.zeros_like(mask).scatter_(1, idx, True)
        full = torch.all(queue_label != -1)
        mask = torch.where(full, mask | mined, mask)
    ones = torch.ones_like(mask[:, :1])
    return torch.cat([ones, mask], dim=1).to(torch.float32)


def draw_shuffle(gen: torch.Generator, n: int) -> torch.Tensor:
    """The permutation of the global key batch of n rows that every rank
    shares (--bn_shuffle gather): a draw on the host from `gen`, which each
    rank seeds alike (the part of the JAX step's shared rng_shuffle)."""
    return torch.randperm(n, generator=gen)


def draw_shuffle_alltoall(gen: torch.Generator, b: int):
    """This rank's two local permutations of its b key rows (--bn_shuffle
    alltoall): draws on the host from `gen`, which each rank seeds with its
    own rank (the JAX step's fold_in(r_local, rank) and fold_in(r_cross,
    rank))."""
    return torch.randperm(b, generator=gen), torch.randperm(b, generator=gen)


def shuffle_mode(mode: str, b: int, ranks: int) -> str:
    """The form the key shuffle takes for --bn_shuffle `mode` with b rows a
    rank over `ranks` ranks, as coclr_tpu/models/moco.py encode_keys
    decides it: none in one process; gather for alltoall when the ranks do
    not divide b (its shards are b / ranks rows). Raises on an unknown
    mode."""
    if mode not in BN_SHUFFLES:
        raise ValueError(f"unknown --bn_shuffle {mode!r}")
    if ranks == 1:
        return "none"
    if mode == "alltoall" and b % ranks:
        return "gather"
    return mode


def batch_shuffle(x, perm, group):
    """This rank's slice of the global key batch under `perm` (the same on
    every rank): all-gather the rows in rank order, take rows perm[r * b:
    (r + 1) * b]. Returns (rows, the inverse permutation)."""
    b = x.shape[0]
    r = rank_of(group)
    perm = perm.to(x.device, non_blocking=True)
    mine = perm[r * b:(r + 1) * b]
    return gather_rows(x, group).index_select(0, mine), torch.argsort(perm)


def batch_unshuffle(k, inv, group):
    """The keys of this rank's own rows again: all-gather the encoded keys
    and take rows inv[r * b:(r + 1) * b]."""
    b = k.shape[0]
    r = rank_of(group)
    return gather_rows(k, group).index_select(0, inv[r * b:(r + 1) * b])


def batch_shuffle_alltoall(x, perms, group):
    """This rank's BN batch under the alltoall shuffle: its rows permuted by
    perms[0], split into one shard of b / n rows per rank and exchanged
    (shard j to rank j; rank j's shard for this rank lands j-th), then
    permuted by perms[1]. Every rank's batch so holds b / n rows of every
    rank. b % n == 0."""
    perm, perm2 = (p.to(x.device, non_blocking=True) for p in perms)
    x = all_to_all_rows(x.index_select(0, perm), group)
    return x.index_select(0, perm2)


def batch_unshuffle_alltoall(k, perms, group):
    """The inverse of batch_shuffle_alltoall on the encoded keys: the keys
    of this rank's own rows, in their order."""
    perm, perm2 = (p.to(k.device, non_blocking=True) for p in perms)
    k = all_to_all_rows(k.index_select(0, torch.argsort(perm2)), group)
    return k.index_select(0, torch.argsort(perm))


@torch.no_grad()
def dequeue_and_enqueue(queue, queue_ptr, keys, *, queue_label=None,
                        labels=None, queue_second=None, keys_second=None,
                        queue_vname=None, vnames=None, group=None) -> None:
    """Write `keys` (and per variant labels, second-modality keys, video
    names) at the ring pointer and advance it (K % batch == 0). With a
    process `group` each is first all-gathered, rank 0's rows first, so
    every rank writes the same global batch. CoCLR writes queue_label = 1
    beside the names: its is-filled flag, not the class."""
    keys = gather_rows(keys, group)
    if labels is not None:
        labels = gather_rows(labels, group)
    if keys_second is not None:
        keys_second = gather_rows(keys_second, group)
    if vnames is not None:
        vnames = gather_rows(vnames, group)
    bs = keys.shape[0]
    idx = queue_ptr + torch.arange(bs, device=queue.device)
    queue.index_copy_(0, idx, keys.to(queue.dtype))
    if labels is not None:
        queue_label.index_copy_(0, idx, labels.to(queue_label.dtype))
    if keys_second is not None:
        queue_second.index_copy_(0, idx, keys_second.to(queue_second.dtype))
    if vnames is not None:
        queue_vname.index_copy_(0, idx, vnames.to(queue_vname.dtype))
        queue_label.index_fill_(0, idx, 1)
    queue_ptr.copy_((queue_ptr + bs) % queue.shape[0])


def topk_accuracy(logits, target, ks=(1, 5)):
    """Share of rows whose target is among the top-k logits, per k."""
    pred = logits.topk(max(ks), dim=1).indices
    correct = pred == target[:, None]
    return tuple(correct[:, :k].any(dim=1).to(torch.float32).mean() for k in ks)


def mask_accuracy(logits, mask, ks=(1, 5)):
    """Share of rows with a positive among the top-k logits, per k."""
    pred = logits.topk(max(ks), dim=1).indices
    hit = torch.gather(mask, 1, pred) > 0
    return tuple(hit[:, :k].any(dim=1).to(torch.float32).mean() for k in ks)
