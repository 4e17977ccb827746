"""ResNet-2d3d-50 (DPC, arXiv:1909.04656), as CoCLR's backbone/resnet_2d3d.py
builds r2d3d50: 2D bottlenecks in layers 1-2, 3D in layers 3-4, (3, 4, 6, 3)
blocks; [B, 3, T, H, W] -> [B, 2048, T/2, H/32, W/32], pooled by the mean
over T, H and W. Frozen copy of coclr_tpu_torch/backbones/resnet2d3d.py at
commit aac8d1afaaa1f842512867f379867b56b8e4edf4, without the port's kernels
or folded BatchNorm (reference/models.py says what the shared layers
compute). Convolutions are drawn kaiming normal with fan_out, BatchNorm
weight 1 and bias 0. The stem is conv1 and bn1, before its ReLU.
"""

from __future__ import annotations

import torch
from torch import nn

from gpubench.reference import models
from gpubench.reference.models import FP32, MaxPool3d


class Bottleneck(nn.Module):
    """ResNet-2d3d bottleneck: 2D ((1,1,1) conv1) or 3D ((3,1,1) conv1),
    then (1,3,3) conv2 with the spatial stride, then (1,1,1) conv3."""

    def __init__(self, cin, planes, is_3d, stride=1, final_relu=True):
        super().__init__()
        cout = planes * 4
        if is_3d:
            self.conv1 = nn.Conv3d(cin, planes, (3, 1, 1), padding=(1, 0, 0),
                                   bias=False)
        else:
            self.conv1 = nn.Conv3d(cin, planes, (1, 1, 1), bias=False)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, (1, 3, 3), (1, stride, stride),
                               (0, 1, 1), bias=False)
        self.bn2 = nn.BatchNorm3d(planes)
        self.conv3 = nn.Conv3d(planes, cout, (1, 1, 1), bias=False)
        self.bn3 = nn.BatchNorm3d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv3d(cin, cout, (1, 1, 1), (1, stride, stride),
                          bias=False),
                nn.BatchNorm3d(cout))
        self.final_relu = final_relu

    def forward(self, x, prec):
        conv, bn = models.conv, models.bn
        h = torch.relu(bn(self.bn1, conv(self.conv1, x, prec)))
        h = torch.relu(bn(self.bn2, conv(self.conv2, h, prec)))
        h = bn(self.bn3, conv(self.conv3, h, prec))
        if self.downsample is not None:
            x = bn(self.downsample[1], conv(self.downsample[0], x, prec))
        out = h + x
        return torch.relu(out) if self.final_relu else out


class ResNet2d3d(nn.Module):
    """r50: 2D bottlenecks in layers 1-2, 3D in layers 3-4, (3, 4, 6, 3)
    blocks; [B, 3, T, H, W] -> [B, 2048, T/2, H/32, W/32]."""

    def __init__(self, blocks_3d=(False, False, True, True),
                 layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv3d(3, 64, (5, 7, 7), (2, 2, 2), (2, 3, 3),
                               bias=False)
        self.bn1 = nn.BatchNorm3d(64)
        self.pool = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        cin = 64
        for li, (planes, is_3d, n) in enumerate(zip((64, 128, 256, 512),
                                                    blocks_3d, layers)):
            blocks = []
            for bi in range(n):
                blocks.append(Bottleneck(
                    cin, planes, is_3d, 2 if li > 0 and bi == 0 else 1,
                    final_relu=not (li == 3 and bi == n - 1)))
                cin = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x, prec=FP32):
        x = torch.relu(models.bn(self.bn1, models.conv(self.conv1, x, prec)))
        x = self.pool(x, prec)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = block(x, prec)
        return torch.relu(x)


Backbone = ResNet2d3d
FEATURES = 2048
STEM = "0.bn1"


def pool(h):
    return h.mean(dim=(2, 3, 4))


def init_(backbone: ResNet2d3d, gen: torch.Generator) -> None:
    """Convolutions kaiming normal (fan_out, ReLU) from `gen` in module
    order; BatchNorm weight 1, bias 0."""
    for mod in backbone.modules():
        if isinstance(mod, nn.Conv3d):
            nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                    nonlinearity="relu", generator=gen)
        elif isinstance(mod, nn.BatchNorm3d):
            mod.reset_parameters()


def stem(backbone: ResNet2d3d, x, prec=FP32):
    return models.bn(backbone.bn1, models.conv(backbone.conv1, x, prec))
