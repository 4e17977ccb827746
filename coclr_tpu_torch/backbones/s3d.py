"""S3D / S3D-G backbone, ported from coclr_tpu/backbones/s3d.py.

Architecture of the reference separable-3D Inception network (CoCLR
backbone/s3dg.py): factored spatial (1,k,k) and temporal (k,1,1)
convolutions, five blocks, optional self-gating. Module names follow the
reference's state_dict key grammar, including its duplicate `blockN`
registration of every block member, so a reference or converted JAX state
loads with `load_state_dict(strict=True)`.

Layout is NCDHW. Convolutions compute in `dtype` (bfloat16 on the card) from
float32 parameters; BatchNorm statistics are float32. Conv weights are
initialized Normal(0, 0.01), BN weight 1 and bias 0, as the reference does.
Max pools are separable 1-D pools whose backward is the pool1d_bwd kernel.

Sequence parallelism (ops/seqpar.py): `S3D(sp=...)` holds the spec and
passes it down through each module's forward. A conv or pool whose kernel
spans a sharded T or H axis takes a halo of its pad width and runs
unpadded there (the local chunk must divide by its stride); BatchNorm and
self-gating average their means over the members. Where a stride-2 H site
no longer tiles the local H chunk, the forward gathers the full H once and
runs the later blocks without the H axis (`degrade_h`), so any img_dim
works at any sph.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from coclr_tpu_torch.backbones.norm import FoldedBatchNorm, bn_relu
from coclr_tpu_torch.kernels.pool import max_pool_3d
from coclr_tpu_torch.ops.seqpar import (drop_h, gather_h, halo, sp_axes,
                                        sp_pmean)


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def _conv(conv: nn.Conv3d, x, dtype, sp=None):
    """`conv` in `dtype`; under `sp` its T and H pads become halos where its
    kernel or pad spans a sharded axis (ops/seqpar.py)."""
    pads = list(conv.padding)
    for i, group in enumerate((sp_axes(sp).t, sp_axes(sp).h)):
        if group is None or (conv.kernel_size[i] == 1 and pads[i] == 0):
            continue
        if x.shape[i + 2] % conv.stride[i]:
            raise ValueError(f"the local chunk {x.shape[i + 2]} (dim {i + 2}) "
                             f"does not divide by the conv stride "
                             f"{conv.stride[i]} under sequence parallelism")
        x = halo(x, pads[i], pads[i], group, i + 2)
        pads[i] = 0
    return F.conv3d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    tuple(pads))


def run(seq: nn.Sequential, x, sp):
    """The modules of `seq` in order, each given the spec `sp`."""
    for mod in seq:
        x = mod(x, sp)
    return x


class BasicConv3d(nn.Module):
    """Conv3d(bias=False) + BN + ReLU (s3dg.py BasicConv3d)."""

    def __init__(self, in_planes, out_planes, kernel_size, stride=1, padding=0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv3d(in_planes, out_planes, _triple(kernel_size),
                              _triple(stride), _triple(padding), bias=False)
        self.bn = FoldedBatchNorm(out_planes, dtype=dtype)
        self.dtype = dtype

    def forward(self, x, sp=None):
        return bn_relu(self.bn, _conv(self.conv, x, self.dtype, sp), sp)


class STConv3d(nn.Module):
    """Separable conv: (1,k,k) then (k,1,1), each + BN + ReLU. `stride` is
    (temporal, spatial)."""

    def __init__(self, in_planes, out_planes, kernel_size: int,
                 stride: Tuple[int, int], padding: int, dtype=torch.bfloat16):
        super().__init__()
        k, p = kernel_size, padding
        t_stride, s_stride = stride
        self.conv1 = nn.Conv3d(in_planes, out_planes, (1, k, k),
                               (1, s_stride, s_stride), (0, p, p), bias=False)
        self.bn1 = FoldedBatchNorm(out_planes, dtype=dtype)
        self.conv2 = nn.Conv3d(out_planes, out_planes, (k, 1, 1),
                               (t_stride, 1, 1), (p, 0, 0), bias=False)
        self.bn2 = FoldedBatchNorm(out_planes, dtype=dtype)
        self.dtype = dtype

    def forward(self, x, sp=None):
        x = bn_relu(self.bn1, _conv(self.conv1, x, self.dtype, sp), sp)
        return bn_relu(self.bn2, _conv(self.conv2, x, self.dtype, sp), sp)


class SelfGating(nn.Module):
    """S3D-G feature gating: sigmoid(FC(spatiotemporal mean)) * x, in
    float32."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.fc = nn.Linear(input_dim, input_dim)

    def forward(self, x, sp=None):
        xf = x.to(torch.float32)
        w = torch.sigmoid(self.fc(sp_pmean(xf.mean(dim=(2, 3, 4)), sp)))
        return (w[:, :, None, None, None] * xf).to(x.dtype)


class MaxPool3d(nn.Module):
    """Separable max pool (kernels/pool.py max_pool_3d); no parameters, it
    holds the reference's place in the block Sequentials."""

    def __init__(self, window, strides, padding):
        super().__init__()
        self.window, self.strides, self.padding = window, strides, padding

    def forward(self, x, sp=None):
        return max_pool_3d(x, self.window, self.strides, self.padding, sp)


class SepInception(nn.Module):
    """Inception block with separable 3x3x3 branches (s3dg.py SepInception).
    out_planes = [b0, b1a, b1b, b2a, b2b, b3b]."""

    def __init__(self, in_planes: int, out_planes: Sequence[int],
                 gating: bool = False, dtype=torch.bfloat16):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = out_planes
        d = dtype
        self.branch0 = nn.Sequential(BasicConv3d(in_planes, b0, 1, dtype=d))
        self.branch1 = nn.Sequential(BasicConv3d(in_planes, b1a, 1, dtype=d),
                                     STConv3d(b1a, b1b, 3, (1, 1), 1, dtype=d))
        self.branch2 = nn.Sequential(BasicConv3d(in_planes, b2a, 1, dtype=d),
                                     STConv3d(b2a, b2b, 3, (1, 1), 1, dtype=d))
        self.branch3 = nn.Sequential(MaxPool3d((3, 3, 3), (1, 1, 1), (1, 1, 1)),
                                     BasicConv3d(in_planes, b3b, 1, dtype=d))
        self.gating = gating
        if gating:
            self.gating_b0 = SelfGating(b0)
            self.gating_b1 = SelfGating(b1b)
            self.gating_b2 = SelfGating(b2b)
            self.gating_b3 = SelfGating(b3b)

    def forward(self, x, sp=None):
        xs = [run(branch, x, sp) for branch in
              (self.branch0, self.branch1, self.branch2, self.branch3)]
        if self.gating:
            gates = (self.gating_b0, self.gating_b1, self.gating_b2,
                     self.gating_b3)
            xs = [gate(v, sp) for gate, v in zip(gates, xs)]
        return torch.cat(xs, dim=1)


def degrade_h(x, sp):
    """Before a stride-2 H site: where the local H chunk no longer tiles the
    stride, gather the full H once and drop the H axis from the spec of
    every later module (ops/seqpar.py gather_h). Returns (x, sp)."""
    h = sp_axes(sp).h
    if h is None or x.shape[3] % 2 == 0:
        return x, sp
    return gather_h(x, h), drop_h(sp)


class S3D(nn.Module):
    """S3D backbone (s3dg.py S3D). Input [B, C, T, H, W]; output
    [B, 1024, T/8 (T/4 if slow), H/32, W/32]. Under sequence parallelism
    (`sp`) the input is this member's T and H chunk: the local T must divide
    by the total temporal stride (8, 4 if slow) and the local H be even."""

    def __init__(self, input_channel: int = 3, gating: bool = False,
                 slow: bool = False, dtype=torch.bfloat16, sp=None):
        super().__init__()
        d = dtype
        self.dtype = dtype
        self.sp = sp
        self.slow = slow
        self.Conv_1a = STConv3d(input_channel, 64, 7, (1 if slow else 2, 2), 3,
                                dtype=d)
        self.block1 = nn.Sequential(self.Conv_1a)

        self.MaxPool_2a = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.Conv_2b = BasicConv3d(64, 64, 1, dtype=d)
        self.Conv_2c = STConv3d(64, 192, 3, (1, 1), 1, dtype=d)
        self.block2 = nn.Sequential(self.MaxPool_2a, self.Conv_2b, self.Conv_2c)

        self.MaxPool_3a = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.Mixed_3b = SepInception(192, [64, 96, 128, 16, 32, 32], gating, d)
        self.Mixed_3c = SepInception(256, [128, 128, 192, 32, 96, 64], gating, d)
        self.block3 = nn.Sequential(self.MaxPool_3a, self.Mixed_3b, self.Mixed_3c)

        self.MaxPool_4a = MaxPool3d((3, 3, 3), (2, 2, 2), (1, 1, 1))
        self.Mixed_4b = SepInception(480, [192, 96, 208, 16, 48, 64], gating, d)
        self.Mixed_4c = SepInception(512, [160, 112, 224, 24, 64, 64], gating, d)
        self.Mixed_4d = SepInception(512, [128, 128, 256, 24, 64, 64], gating, d)
        self.Mixed_4e = SepInception(512, [112, 144, 288, 32, 64, 64], gating, d)
        self.Mixed_4f = SepInception(528, [256, 160, 320, 32, 128, 128], gating, d)
        self.block4 = nn.Sequential(self.MaxPool_4a, self.Mixed_4b, self.Mixed_4c,
                                    self.Mixed_4d, self.Mixed_4e, self.Mixed_4f)

        self.MaxPool_5a = MaxPool3d((2, 2, 2), (2, 2, 2), (0, 0, 0))
        self.Mixed_5b = SepInception(832, [256, 160, 320, 32, 128, 128], gating, d)
        self.Mixed_5c = SepInception(832, [384, 192, 384, 48, 128, 128], gating, d)
        self.block5 = nn.Sequential(self.MaxPool_5a, self.Mixed_5b, self.Mixed_5c)

    def forward(self, x):
        x = x.to(self.dtype)
        sp = self.sp
        t, h = sp_axes(sp).t, sp_axes(sp).h
        div = 4 if self.slow else 8
        if t is not None and x.shape[2] % div:
            raise ValueError(f"sequence-parallel S3D needs the local T chunk "
                             f"({x.shape[2]}) divisible by its total temporal "
                             f"stride {div}")
        if h is not None and x.shape[3] % 2:
            raise ValueError(f"spatially sequence-parallel S3D needs an even "
                             f"local H chunk ({x.shape[3]}) for its stem")
        x = run(self.block1, x, sp)
        for block in (self.block2, self.block3, self.block4, self.block5):
            x, sp = degrade_h(x, sp)
            x = run(block, x, sp)
        return x
