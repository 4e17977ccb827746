"""S3D without gating (Xie et al. 2018, arXiv:1712.04851), as CoCLR's
backbone/s3dg.py builds it: [B, 3, T, H, W] -> [B, 1024, T/8, H/32, W/32],
pooled by the mean over T, H and W. Frozen copy of
coclr_tpu_torch/backbones/s3d.py at commit
aac8d1afaaa1f842512867f379867b56b8e4edf4, without the port's kernels or
folded BatchNorm (reference/models.py says what the shared layers compute).
Convolutions are drawn N(0, 0.01), BatchNorm weight 1 and bias 0. The stem
is Conv_1a: both convolutions, BatchNorms and ReLUs.
"""

from __future__ import annotations

import torch
from torch import nn

from gpubench.reference import models
from gpubench.reference.models import FP32, BasicConv3d, MaxPool3d


class STConv3d(nn.Module):
    """(1, k, k) conv + BN + ReLU, then (k, 1, 1) conv + BN + ReLU."""

    def __init__(self, cin, cout, k, stride, p):
        super().__init__()
        t_stride, s_stride = stride
        self.conv1 = nn.Conv3d(cin, cout, (1, k, k), (1, s_stride, s_stride),
                               (0, p, p), bias=False)
        self.bn1 = nn.BatchNorm3d(cout)
        self.conv2 = nn.Conv3d(cout, cout, (k, 1, 1), (t_stride, 1, 1),
                               (p, 0, 0), bias=False)
        self.bn2 = nn.BatchNorm3d(cout)

    def forward(self, x, prec):
        x = torch.relu(models.bn(self.bn1, models.conv(self.conv1, x, prec)))
        return torch.relu(models.bn(self.bn2, models.conv(self.conv2, x, prec)))


class SepInception(nn.Module):
    def __init__(self, cin, planes):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = planes
        self.branch0 = nn.Sequential(BasicConv3d(cin, b0, 1))
        self.branch1 = nn.Sequential(BasicConv3d(cin, b1a, 1),
                                     STConv3d(b1a, b1b, 3, (1, 1), 1))
        self.branch2 = nn.Sequential(BasicConv3d(cin, b2a, 1),
                                     STConv3d(b2a, b2b, 3, (1, 1), 1))
        self.branch3 = nn.Sequential(MaxPool3d((3, 3, 3), (1, 1, 1), (1, 1, 1)),
                                     BasicConv3d(cin, b3b, 1))

    def forward(self, x, prec):
        outs = []
        for branch in (self.branch0, self.branch1, self.branch2, self.branch3):
            y = x
            for mod in branch:
                y = mod(y, prec)
            outs.append(y)
        return torch.cat(outs, dim=1)


class S3D(nn.Module):
    """S3D without gating; [B, 3, T, H, W] -> [B, 1024, T/8, H/32, W/32].
    Each member is registered twice (as the reference's state_dict has it),
    which decides the order in which `init_` reaches the convolutions."""

    def __init__(self):
        super().__init__()
        self.Conv_1a = STConv3d(3, 64, 7, (2, 2), 3)
        self.block1 = nn.Sequential(self.Conv_1a)
        self.MaxPool_2a = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.Conv_2b = BasicConv3d(64, 64, 1)
        self.Conv_2c = STConv3d(64, 192, 3, (1, 1), 1)
        self.block2 = nn.Sequential(self.MaxPool_2a, self.Conv_2b, self.Conv_2c)
        self.MaxPool_3a = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.Mixed_3b = SepInception(192, [64, 96, 128, 16, 32, 32])
        self.Mixed_3c = SepInception(256, [128, 128, 192, 32, 96, 64])
        self.block3 = nn.Sequential(self.MaxPool_3a, self.Mixed_3b,
                                    self.Mixed_3c)
        self.MaxPool_4a = MaxPool3d((3, 3, 3), (2, 2, 2), (1, 1, 1))
        self.Mixed_4b = SepInception(480, [192, 96, 208, 16, 48, 64])
        self.Mixed_4c = SepInception(512, [160, 112, 224, 24, 64, 64])
        self.Mixed_4d = SepInception(512, [128, 128, 256, 24, 64, 64])
        self.Mixed_4e = SepInception(512, [112, 144, 288, 32, 64, 64])
        self.Mixed_4f = SepInception(528, [256, 160, 320, 32, 128, 128])
        self.block4 = nn.Sequential(self.MaxPool_4a, self.Mixed_4b,
                                    self.Mixed_4c, self.Mixed_4d,
                                    self.Mixed_4e, self.Mixed_4f)
        self.MaxPool_5a = MaxPool3d((2, 2, 2), (2, 2, 2), (0, 0, 0))
        self.Mixed_5b = SepInception(832, [256, 160, 320, 32, 128, 128])
        self.Mixed_5c = SepInception(832, [384, 192, 384, 48, 128, 128])
        self.block5 = nn.Sequential(self.MaxPool_5a, self.Mixed_5b,
                                    self.Mixed_5c)

    def forward(self, x, prec=FP32):
        for block in (self.block1, self.block2, self.block3, self.block4,
                      self.block5):
            for mod in block:
                x = mod(x, prec)
        return x


Backbone = S3D
FEATURES = 1024
STEM = "0.Conv_1a"


def pool(h):
    return h.mean(dim=(2, 3, 4))


def init_(backbone: S3D, gen: torch.Generator) -> None:
    """Convolutions N(0, 0.01) from `gen` in module order; BatchNorm weight
    1, bias 0."""
    for mod in backbone.modules():
        if isinstance(mod, nn.Conv3d):
            nn.init.normal_(mod.weight, 0.0, 0.01, generator=gen)
        elif isinstance(mod, nn.BatchNorm3d):
            mod.reset_parameters()


def stem(backbone: S3D, x, prec=FP32):
    return backbone.Conv_1a(x, prec)
