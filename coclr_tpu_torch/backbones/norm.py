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
"""

from __future__ import annotations

import torch
from torch import nn


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


def _folded_forward(bn, x):
    """The folded BatchNorm forward of `bn` (an nn.BatchNorm*d with a
    `compute_dtype`) on x [N, C, ...]."""
    if bn.training:
        mean, var = _BatchStats.apply(x)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
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

    def forward(self, x):
        return _folded_forward(self, x)


class FoldedBatchNorm1d(nn.BatchNorm1d):
    """The same on [N, C] features: nn.BatchNorm1d state (the classifier's
    final_bn), float32 by default."""

    def __init__(self, num_features: int, dtype=torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x):
        return _folded_forward(self, x)


def bn_relu(bn: FoldedBatchNorm, x):
    """FoldedBatchNorm + ReLU, the backbone's BN+ReLU unit."""
    return torch.relu(bn(x))
