"""Temporal and spatial sequence parallelism, ported from
coclr_tpu/ops/seqpar.py.

A clip's time axis is sharded over the ranks of an `sp` group and/or its
height axis over an `sph` group (parallel/dist.py builds both). The 3D-CNN
backbones are local along both axes (separable (k,1,1) / (1,k,k) convs and
max pools with k <= 7), so the only communication is

  - a halo exchange (`temporal_halo` / `spatial_halo`) before each op whose
    kernel spans a sharded axis, which turns its padded conv or pool into
    an unpadded one on the halo-extended local block: exact, because global
    output j of a conv with pad p, kernel 2p + 1 and stride s over
    N = n * N_loc reads padded input [j * s - p, j * s + p], which for
    member i's outputs lies inside [halo p, local block, halo p] as long as
    N_loc % s == 0;
  - `sp_pmean` wherever the unsharded program reduces over time or space:
    the global average pool, the self-gating means and the BatchNorm batch
    statistics (whose scope stays "this data shard's batch, full T x H",
    as MoCo's shuffle-BN needs);
  - `gather_h`, once, where a stride-2 H site no longer tiles the local H
    chunk: the later blocks run on the full H, replicated over sph.

Gradients. Every member computes the same loss from the same pooled
feature, so the head's gradients are replicated, while a backbone
parameter's gradient on a member comes out n x its share of the true
gradient (the backward of `sp_pmean` is all_reduce(ct) / n, the exact
transpose of its forward, and the cotangents arriving at it are equal on
every member). One uniform mean of the gradients over every rank (the data
parallel all-reduce, parallel/train_step.py) is then the true gradient for
both groups of parameters. This is not torch.distributed.nn.all_reduce,
whose backward is a sum.

Transport: one all_gather of each member's edge rows over the group, the
same call on nccl and on gloo (gloo has no reduce_scatter and does not take
CUDA tensors for send / recv). Every member must call the primitives in the
same order, forward and backward, which the identical programs of the
members give.

`SPAxes` carries the groups; `None` (or an SPAxes with no group) is the
unsharded program, and every primitive is then the identity, so callers
need no branching.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

T_DIM, H_DIM = 2, 3  # the T and H axes of an NCDHW activation


@dataclasses.dataclass(frozen=True)
class SPAxes:
    """The process groups that shard a clip: `t` the sp group (temporal
    halos), `h` the sph group (spatial halos, gather_h), `both` the group
    over the two (sp_pmean when t and h are both set). A group of one rank
    is given as None. Modules keep it as an attribute; deep copies (the
    MoCo key encoder) share it."""

    t: Optional[Any] = None
    h: Optional[Any] = None
    both: Optional[Any] = None

    def __deepcopy__(self, memo):
        return self


def sp_axes(sp) -> SPAxes:
    """`sp` (None or an SPAxes) as an SPAxes."""
    return SPAxes() if sp is None else sp


def pmean_group(sp):
    """The group `sp_pmean` reduces over: both axes, one of them, or None."""
    a = sp_axes(sp)
    if a.t is not None and a.h is not None:
        return a.both
    return a.t if a.t is not None else a.h


def sp_size(sp) -> int:
    """The number of members that share one clip under `sp`."""
    g = pmean_group(sp)
    return 1 if g is None else dist.get_world_size(g)


def drop_h(sp) -> Optional[SPAxes]:
    """The spec with the spatial axis removed (the blocks after gather_h)."""
    a = sp_axes(sp)
    return None if a.t is None else SPAxes(t=a.t)


def _members(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _all_gather(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _Halo(torch.autograd.Function):
    """x extended along `dim` by `lo` rows of the previous member's tail and
    `hi` rows of the next member's head; zeros at the global edges. The
    backward sends each halo's cotangent back to its owner, which adds it
    onto its edge rows."""

    @staticmethod
    def forward(ctx, x, lo, hi, group, dim):
        n, i = _members(group)
        size = x.shape[dim]
        ctx.cfg = (lo, hi, group, dim, size)
        edges = torch.cat([x.narrow(dim, size - lo, lo), x.narrow(dim, 0, hi)],
                          dim)
        parts = _all_gather(edges, group)
        zeros = lambda k: x.new_zeros(x.shape[:dim] + (k,) + x.shape[dim + 1:])
        left = parts[i - 1].narrow(dim, 0, lo) if i > 0 else zeros(lo)
        right = parts[i + 1].narrow(dim, lo, hi) if i < n - 1 else zeros(hi)
        return torch.cat([left, x, right], dim)

    @staticmethod
    def backward(ctx, g):
        lo, hi, group, dim, size = ctx.cfg
        n, i = _members(group)
        g = g.contiguous()
        # this member's cotangents of its neighbours' rows: the left halo
        # (the previous member's tail), then the right halo (the next's head)
        sent = torch.cat([g.narrow(dim, 0, lo), g.narrow(dim, lo + size, hi)],
                         dim)
        parts = _all_gather(sent, group)
        dx = g.narrow(dim, lo, size).clone()
        if i < n - 1 and lo:  # the next member's left halo is our tail
            dx.narrow(dim, size - lo, lo).add_(parts[i + 1].narrow(dim, 0, lo))
        if i > 0 and hi:      # the previous member's right halo is our head
            dx.narrow(dim, 0, hi).add_(parts[i - 1].narrow(dim, lo, hi))
        return dx, None, None, None, None


def halo(x, lo: int, hi: int, group, dim: int):
    """`x` extended along `dim` with `lo` trailing rows of the previous
    member of `group` and `hi` leading rows of the next; the global edges
    get zeros, the explicit zero padding of the unsharded convs (and, on
    the post-ReLU inputs of the max pools, the value of their -inf pad).
    The identity for no group or no halo."""
    if group is None or (lo == 0 and hi == 0):
        return x
    size = x.shape[dim]
    if lo > size or hi > size:
        raise ValueError(f"halo ({lo}, {hi}) exceeds the local chunk {size} "
                         f"on dim {dim}: increase the sharded extent or "
                         "decrease the sp size")
    return _Halo.apply(x, lo, hi, group, dim)


def temporal_halo(x, lo: int, hi: int, group):
    """Halo exchange on the clip time axis (dim 2 of [B, C, T, H, W])."""
    return halo(x, lo, hi, group, T_DIM)


def spatial_halo(x, lo: int, hi: int, group):
    """Halo exchange on the clip height axis (dim 3 of [B, C, T, H, W])."""
    return halo(x, lo, hi, group, H_DIM)


class _PMean(torch.autograd.Function):
    """Mean over the group with the exact transpose: forward all_reduce(x)
    / n, backward all_reduce(ct) / n (the cotangents may differ per member,
    e.g. those of BatchNorm statistics)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def sp_pmean(x, sp):
    """Mean of x over the members that share a clip under `sp` (both axes
    where both are set), with the exact transpose; the identity without."""
    group = pmean_group(sp)
    return x if group is None else _PMean.apply(x, group)


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[H_DIM]
        return torch.cat(_all_gather(x, group), H_DIM)

    @staticmethod
    def backward(ctx, g):
        # the transpose of the gather: the sum of every member's cotangent,
        # this member's rows of it (a reduce-scatter, as all_reduce + slice)
        total = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=ctx.group)
        i = dist.get_rank(ctx.group)
        return total.narrow(H_DIM, i * ctx.rows, ctx.rows).to(g.dtype), None


def gather_h(x, group):
    """All-gather the H shards of [B, C, T, H_loc, W] into the full H on
    every member of `group`. Backward: the sum of the members' cotangents
    at this member's rows, which is sph x its share where the computation
    after the gather is replicated: the scaling the uniform gradient mean
    expects (module docstring)."""
    return _GatherH.apply(x, group)


__all__ = ["SPAxes", "sp_axes", "pmean_group", "sp_size", "drop_h", "halo",
           "temporal_halo", "spatial_halo", "sp_pmean", "gather_h"]
