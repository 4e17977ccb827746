"""Backbone registry (coclr_tpu/backbones/__init__.py; the reference's
select_backbone.py)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from coclr_tpu_torch.backbones.resnet2d3d import ResNet2d3d, r2d3d50, r3d50
from coclr_tpu_torch.backbones.s3d import S3D, BasicConv3d

__all__ = ["select_backbone", "S3D", "ResNet2d3d", "r2d3d50", "r3d50",
           "TinyBackbone"]


class TinyBackbone(nn.Module):
    """Two-conv backbone with BatchNorm: the conv/BN/stats paths of the big
    backbones at CPU-test speed."""

    def __init__(self, input_channel: int = 3, dtype=torch.bfloat16, sp=None):
        super().__init__()
        self.dtype = dtype
        self.sp = sp
        self.c1 = BasicConv3d(input_channel, 16, (1, 3, 3), (1, 2, 2), (0, 1, 1),
                              dtype=dtype)
        self.c2 = BasicConv3d(16, 32, (3, 3, 3), (2, 2, 2), (1, 1, 1), dtype=dtype)

    def forward(self, x):
        return self.c2(self.c1(x.to(self.dtype), self.sp), self.sp)


def select_backbone(network: str, first_channel: int = 3,
                    dtype=torch.bfloat16, sp=None) -> Tuple[nn.Module, dict]:
    """Return (module, {'feature_size': int}) like the reference registry:
    s3d and s3dg (1024 features), r50 and r3d50 (ResNet-2d3d, 2048) and
    tiny (32). `sp`: the sequence-parallel spec (ops/seqpar.py), which
    every backbone takes, spatial included."""
    param = {"feature_size": 1024}
    if network == "s3d":
        model = S3D(input_channel=first_channel, gating=False, dtype=dtype,
                    sp=sp)
    elif network == "s3dg":
        model = S3D(input_channel=first_channel, gating=True, dtype=dtype,
                    sp=sp)
    elif network == "r50":
        param["feature_size"] = 2048
        model = r2d3d50(input_channel=first_channel, dtype=dtype, sp=sp)
    elif network == "r3d50":
        param["feature_size"] = 2048
        model = r3d50(input_channel=first_channel, dtype=dtype, sp=sp)
    elif network == "tiny":
        param["feature_size"] = 32
        model = TinyBackbone(input_channel=first_channel, dtype=dtype, sp=sp)
    else:
        raise ValueError(f"unknown backbone: {network!r}")
    return model, param
