"""Backbone + projection head, ported from coclr_tpu/models/encoder.py.

The reference's encoder_q / encoder_k Sequential (model/pretrain.py):
backbone -> AdaptiveAvgPool3d(1) -> Conv3d(fs, fs, 1) -> ReLU ->
Conv3d(fs, dim, 1). The indices 0 to 4 are kept so the state_dict keys are
the reference's (`0.<backbone>`, `2.weight`, `4.weight`); the forward takes
the mean over T, H, W in float32 and runs the two 1x1x1 convs as float32
matmuls on the pooled [B, fs] features, as the JAX package's Dense layers do.

Under sequence parallelism (`sp`, ops/seqpar.py) the backbone runs on this
member's T and H chunk and the pooled feature is the mean of the members'
means (sp_pmean): every member holds the same feature, so the head and the
MoCo state stay replicated across the members.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from coclr_tpu_torch.backbones import ResNet2d3d, select_backbone
from coclr_tpu_torch.ops.seqpar import sp_pmean


class ProjectionEncoder(nn.Sequential):
    """backbone -> global mean -> fc1 -> ReLU -> fc2 (dim). Input
    [B, C, T, H, W]; returns UNNORMALIZED [B, dim] float32."""

    def __init__(self, network: str = "s3d", dim: int = 128,
                 dtype=torch.bfloat16, sp=None):
        backbone, param = select_backbone(network, dtype=dtype, sp=sp)
        fs = param["feature_size"]
        super().__init__(backbone, nn.AdaptiveAvgPool3d((1, 1, 1)),
                         nn.Conv3d(fs, fs, 1), nn.ReLU(), nn.Conv3d(fs, dim, 1))
        self.sp = sp

    def features(self, x):
        """Pooled backbone features [B, feature_size], float32."""
        return sp_pmean(self[0](x).to(torch.float32).mean(dim=(2, 3, 4)),
                        self.sp)

    def forward(self, x):
        h = F.relu(F.linear(self.features(x), self[2].weight.flatten(1),
                            self[2].bias))
        return F.linear(h, self[4].weight.flatten(1), self[4].bias)


def init_params_(encoder: ProjectionEncoder, gen: torch.Generator) -> None:
    """Draw every parameter from `gen`, with the reference's initializers:
    the backbone's (init_backbone_), and torch's default U(+-1/sqrt(fan_in))
    for the head convs."""
    with torch.no_grad():
        init_backbone_(encoder[0], gen)
        _torch_default_init(encoder[2], gen)
        _torch_default_init(encoder[4], gen)


def init_backbone_(backbone: nn.Module, gen: torch.Generator) -> None:
    """The reference's backbone initializers, drawn from `gen`: convs
    Normal(0, 0.01) (S3D, tiny) or, for ResNet-2d3d, kaiming normal with
    fan_out (std sqrt(2 / (out channels x kernel volume))); BN weight 1 /
    bias 0; S3D-G's gating Linear layers torch's default."""
    kaiming = isinstance(backbone, ResNet2d3d)
    with torch.no_grad():
        for mod in backbone.modules():
            if isinstance(mod, nn.Conv3d) and kaiming:
                nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                        nonlinearity="relu", generator=gen)
            elif isinstance(mod, nn.Conv3d):
                nn.init.normal_(mod.weight, 0.0, 0.01, generator=gen)
            elif isinstance(mod, nn.Linear):
                _torch_default_init(mod, gen)
            elif isinstance(mod, nn.BatchNorm3d):
                mod.reset_parameters()


def _torch_default_init(mod, gen):
    fan_in = mod.weight[0].numel()
    nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=gen)
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(mod.bias, -bound, bound, generator=gen)
