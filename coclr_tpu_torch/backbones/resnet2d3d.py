"""ResNet-2d3d backbone (r50, r3d50), ported from
coclr_tpu/backbones/resnet2d3d.py (the reference's backbone/resnet_2d3d.py).

Bottleneck blocks of two kinds: "2D" ((1,3,3) middle conv between 1x1x1
convs) and "3D" (a (3,1,1) temporal conv1 before the (1,3,3) conv2). r50
(CVRL's R50) uses 2D blocks in layers 1-2 and 3D blocks in layers 3-4;
r3d50 uses 3D blocks throughout. Layers 2-4 open with a spatial stride of
2. The last block of layer 4 has no final ReLU and the network applies ReLU
once more at the end, as the reference does.

Module names follow the reference's key grammar (`conv1`, `bn1`,
`layerN.i.convJ`, `.bnJ`, `.downsample.0` conv and `.downsample.1` BN), so
a reference or converted JAX state loads with strict=True. Layout is NCDHW;
convolutions compute in `dtype` from float32 parameters, BatchNorm
statistics are float32. The stem's max pool is the separable pool whose
backward is the pool1d_bwd kernel. Convolutions are initialized kaiming
normal with fan_out (models/encoder.py init_backbone_).

Sequence parallelism (`sp`, ops/seqpar.py) as in S3D: the stem (T pad 2,
H pad 3, stride 2: the local T and H chunks must be even), the 3D blocks'
(3,1,1) conv1, every (1,3,3) conv2 and the stem pool take halos of their
pad widths; the stride-2 1x1x1 downsample convs tile without one; the
BatchNorms average their means over the members; and where a stride-2 H
site no longer tiles the local H chunk the full H is gathered once
(s3d.py degrade_h).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from coclr_tpu_torch.backbones.norm import FoldedBatchNorm, bn_relu
from coclr_tpu_torch.backbones.s3d import _conv, degrade_h
from coclr_tpu_torch.kernels.pool import max_pool_3d

EXPANSION = 4


def _conv3d(in_planes, out_planes, kernel, stride=(1, 1, 1),
            padding=(0, 0, 0)) -> nn.Conv3d:
    return nn.Conv3d(in_planes, out_planes, kernel, stride, padding,
                     bias=False)


class Bottleneck(nn.Module):
    """Bottleneck2d / Bottleneck3d in one module. `stride` is the spatial
    stride of conv2 and the downsample conv, (1, stride, stride): no
    published configuration strides time inside a layer."""

    def __init__(self, in_planes: int, planes: int, is_3d: bool,
                 stride: int = 1, use_final_relu: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        out_planes = planes * EXPANSION
        if is_3d:
            self.conv1 = _conv3d(in_planes, planes, (3, 1, 1),
                                 padding=(1, 0, 0))
        else:
            self.conv1 = _conv3d(in_planes, planes, (1, 1, 1))
        self.bn1 = FoldedBatchNorm(planes, dtype=dtype)
        self.conv2 = _conv3d(planes, planes, (1, 3, 3), (1, stride, stride),
                             (0, 1, 1))
        self.bn2 = FoldedBatchNorm(planes, dtype=dtype)
        self.conv3 = _conv3d(planes, out_planes, (1, 1, 1))
        self.bn3 = FoldedBatchNorm(out_planes, dtype=dtype)
        self.downsample = None
        if stride != 1 or in_planes != out_planes:
            self.downsample = nn.Sequential(
                _conv3d(in_planes, out_planes, (1, 1, 1), (1, stride, stride)),
                FoldedBatchNorm(out_planes, dtype=dtype))
        self.use_final_relu = use_final_relu
        self.dtype = dtype

    def forward(self, x, sp=None):
        d = self.dtype
        h = bn_relu(self.bn1, _conv(self.conv1, x, d, sp), sp)
        h = bn_relu(self.bn2, _conv(self.conv2, h, d, sp), sp)
        h = self.bn3(_conv(self.conv3, h, d), sp)  # no ReLU before the sum
        if self.downsample is None:
            residual = x
        else:
            conv, bn = self.downsample
            residual = bn(_conv(conv, x, d, sp), sp)
        out = h + residual.to(h.dtype)
        if self.use_final_relu:
            out = torch.relu(out)
        return out.to(d)


class ResNet2d3d(nn.Module):
    """blocks_3d[i] says whether layer i + 1 uses 3D bottlenecks; layers
    gives the block counts. Input [B, C, T, H, W]; output
    [B, 2048, T/2, H/32, W/32]."""

    def __init__(self, blocks_3d: Sequence[bool] = (False, False, True, True),
                 layers: Sequence[int] = (3, 4, 6, 3), input_channel: int = 3,
                 dtype=torch.bfloat16, sp=None):
        super().__init__()
        self.dtype = dtype
        self.sp = sp
        self.conv1 = _conv3d(input_channel, 64, (5, 7, 7), (2, 2, 2), (2, 3, 3))
        self.bn1 = FoldedBatchNorm(64, dtype=dtype)
        in_planes = 64
        for li, (planes, is_3d, n_blocks) in enumerate(
                zip((64, 128, 256, 512), blocks_3d, layers)):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if li > 0 and bi == 0 else 1
                final = li == 3 and bi == n_blocks - 1
                blocks.append(Bottleneck(in_planes, planes, is_3d, stride,
                                         use_final_relu=not final, dtype=dtype))
                in_planes = planes * EXPANSION
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        sp = self.sp
        x = bn_relu(self.bn1, _conv(self.conv1, x, self.dtype, sp), sp)
        x, sp = degrade_h(x, sp)
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1), sp)
        for li, layer in enumerate((self.layer1, self.layer2, self.layer3,
                                    self.layer4)):
            if li > 0:  # layers 2-4 open with a spatial stride of 2
                x, sp = degrade_h(x, sp)
            for block in layer:
                x = block(x, sp)
        return torch.relu(x)


def r2d3d50(input_channel: int = 3, dtype=torch.bfloat16,
            sp=None) -> ResNet2d3d:
    """CVRL ResNet-50: 2D, 2D, 3D, 3D bottlenecks."""
    return ResNet2d3d((False, False, True, True), (3, 4, 6, 3), input_channel,
                      dtype, sp)


def r3d50(input_channel: int = 3, dtype=torch.bfloat16,
          sp=None) -> ResNet2d3d:
    """ResNet3D-50: 3D bottlenecks in every layer."""
    return ResNet2d3d((True, True, True, True), (3, 4, 6, 3), input_channel,
                      dtype, sp)
