"""BatchNorm with the normalize folded into one per-channel affine, ported
from coclr_tpu/backbones/norm.py.

Semantics of torch nn.BatchNorm3d as the reference backbones use it: batch
statistics in training, running averages in eval, and the running variance
updated with the UNBIASED n/(n-1) batch variance while the normalize uses
the biased one. Statistics are float32 over (N, T, H, W); the affine
y = x * s + o with s = weight * rsqrt(var + eps), o = bias - mean * s is
applied in the compute dtype. `momentum` keeps torch's convention (0.1, the
JAX package's flax momentum 0.9).

Parameter and buffer names are nn.BatchNorm3d's (weight, bias,
running_mean, running_var, num_batches_tracked), so the reference key
grammar loads with strict=True. The ReLU that follows is torch.relu, whose
gradient is keyed on its output, as relu_keyed_on_output's is.

Under sequence parallelism (`sp`, an ops/seqpar.py spec) E[x] and E[x^2]
are averaged over the members that share the clip (sp_pmean; the shards
are equal, so the mean of the means is the mean), and the running
variance's n / (n - 1) uses the global n.
"""

from __future__ import annotations

import torch
from torch import nn

from coclr_tpu_torch.ops.seqpar import pmean_group, sp_pmean, sp_size


class _BatchStats(torch.autograd.Function):
    """Per-channel (mean, biased var) in float32 over all axes but 1.

    The backward is the analytic one, dx = gm / n + (x - mean) * 2 / n * gv,
    which is what autograd of the E[x^2] - E[x]^2 form gives, but it keeps
    only x (already alive as the conv output) and the mean, not a float32
    copy of x."""

    @staticmethod
    def forward(ctx, x):
        dims = (0,) + tuple(range(2, x.dim()))
        xf = x.to(torch.float32)
        mean = xf.mean(dim=dims)
        var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, gm, gv):
        x, mean = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        view = (1, -1) + (1,) * (x.dim() - 2)
        dx = (gm.view(view) / n
              + (x.to(torch.float32) - mean.view(view)) * (2.0 / n) * gv.view(view))
        return dx.to(x.dtype)


class _BatchMoments(torch.autograd.Function):
    """Per-channel (E[x], E[x^2]) in float32 over all axes but 1, with the
    analytic backward dx = gm / n + x * 2 / n * g2 (the sequence-parallel
    statistics: both moments are averaged over the members first)."""

    @staticmethod
    def forward(ctx, x):
        dims = (0,) + tuple(range(2, x.dim()))
        xf = x.to(torch.float32)
        ctx.save_for_backward(x)
        return xf.mean(dim=dims), (xf * xf).mean(dim=dims)

    @staticmethod
    def backward(ctx, gm, g2):
        x, = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        view = (1, -1) + (1,) * (x.dim() - 2)
        dx = gm.view(view) / n + x.to(torch.float32) * (2.0 / n) * g2.view(view)
        return dx.to(x.dtype)


def _sp_stats(x, sp):
    """(mean, biased var) of the clip that the members of `sp` share."""
    # both moments in one all-reduce: half the collectives of two calls
    mean, ex2 = sp_pmean(torch.stack(_BatchMoments.apply(x)), sp)
    return mean, torch.clamp_min(ex2 - mean * mean, 0.0)


def _folded_forward(bn, x, sp=None):
    """The folded BatchNorm forward of `bn` (an nn.BatchNorm*d with a
    `compute_dtype`) on x [N, C, ...], its statistics over the members of
    `sp` (ops/seqpar.py) where given."""
    if bn.training:
        if pmean_group(sp) is None:
            mean, var = _BatchStats.apply(x)
        else:
            mean, var = _sp_stats(x, sp)
        with torch.no_grad():
            n = x.numel() // x.shape[1] * sp_size(sp)
            bn.running_mean.mul_(1.0 - bn.momentum).add_(
                mean.detach(), alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(
                var.detach() * (n / max(n - 1, 1)), alpha=bn.momentum)
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    s = bn.weight * torch.rsqrt(var + bn.eps)
    o = bn.bias - mean * s
    d = bn.compute_dtype
    view = (1, -1) + (1,) * (x.dim() - 2)
    return x.to(d) * s.to(d).view(view) + o.to(d).view(view)


class FoldedBatchNorm(nn.BatchNorm3d):
    """nn.BatchNorm3d state, folded-affine forward in `dtype`."""

    def __init__(self, num_features: int, dtype=torch.bfloat16):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x, sp=None):
        return _folded_forward(self, x, sp)


class FoldedBatchNorm1d(nn.BatchNorm1d):
    """The same on [N, C] features: nn.BatchNorm1d state (the classifier's
    final_bn), float32 by default."""

    def __init__(self, num_features: int, dtype=torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x):
        return _folded_forward(self, x)


def bn_relu(bn: FoldedBatchNorm, x, sp=None):
    """FoldedBatchNorm + ReLU, the backbone's BN+ReLU unit."""
    return torch.relu(bn(x, sp))
