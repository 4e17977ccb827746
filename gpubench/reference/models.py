"""Plain PyTorch reference of the pretraining encoders: S3D and
ResNet-2d3d-50 backbones, the projection head, and their initial weights
drawn from the seed.

Frozen copy of the architectures of coclr_tpu_torch/backbones/s3d.py,
coclr_tpu_torch/backbones/resnet2d3d.py and coclr_tpu_torch/models/encoder.py
at commit aac8d1afaaa1f842512867f379867b56b8e4edf4 (the reference's
backbone/s3dg.py and backbone/resnet_2d3d.py), rewritten without the port's
kernels, folded BatchNorm or sequence parallelism: float32 convolutions,
torch's own batch norm and 3-D max pool. Modules are registered in the
port's order, so `init_` draws every weight from the seed's generator in
the same sequence as the port does. Imports nothing of the port.

`Precision` puts the control in place: with `fp8` set, every convolution and
matmul of the encoders reads its operands rounded to float8 e4m3 (per-tensor
scale) and its incoming gradient rounded to float8 e5m2, the usual fp8
training recipe, one step below the bfloat16 the configurations state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def round_fp8(x, dtype=torch.float8_e4m3fn, top=E4M3_MAX):
    """x rounded to `dtype` under a per-tensor scale that maps its largest
    magnitude to the format's largest finite value; returned in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Forward: operand in e4m3. Backward: incoming gradient in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """What the encoders compute in: float32 (the reference) or, with
    `fp8`, the control's rounded operands."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def op(self, x):
        return _Fp8.apply(x) if self.fp8 else x


FP32 = Precision()


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def conv(mod: nn.Conv3d, x, prec: Precision):
    return F.conv3d(prec.op(x), prec.op(mod.weight), mod.bias, mod.stride,
                    mod.padding)


def bn(mod: nn.BatchNorm3d, x):
    """Train-mode batch norm: biased batch statistics normalise, the
    running statistics take the unbiased variance (torch's semantics)."""
    return F.batch_norm(x, mod.running_mean, mod.running_var, mod.weight,
                        mod.bias, mod.training, mod.momentum, mod.eps)


class BasicConv3d(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, _triple(kernel), _triple(stride),
                              _triple(padding), bias=False)
        self.bn = nn.BatchNorm3d(cout)

    def forward(self, x, prec):
        return torch.relu(bn(self.bn, conv(self.conv, x, prec)))


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
        x = torch.relu(bn(self.bn1, conv(self.conv1, x, prec)))
        return torch.relu(bn(self.bn2, conv(self.conv2, x, prec)))


class MaxPool3d(nn.Module):
    """One 3-D max pool (implicit -inf padding). `record`, where set, is a
    list that collects (input shape, window, strides, padding) per call: how
    gpubench/counts.py finds the pool kernel's launch shapes."""

    record = None

    def __init__(self, window, strides, padding):
        super().__init__()
        self.window, self.strides, self.padding = window, strides, padding

    def forward(self, x, prec):
        if MaxPool3d.record is not None:
            MaxPool3d.record.append((tuple(x.shape), self.window, self.strides,
                                     self.padding))
        return F.max_pool3d(x, self.window, self.strides, self.padding)


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
        x = torch.relu(bn(self.bn1, conv(self.conv1, x, prec)))
        x = self.pool(x, prec)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = block(x, prec)
        return torch.relu(x)


BACKBONES = {"s3d": (S3D, 1024), "r50": (ResNet2d3d, 2048)}


class Encoder(nn.Module):
    """backbone -> mean over T, H, W -> fc1 -> ReLU -> fc2; the two fcs are
    1x1x1 convolutions with bias (the reference's key grammar), applied as
    matmuls on the pooled features. Returns unnormalised [B, dim]."""

    def __init__(self, net: str, dim: int):
        super().__init__()
        cls, fs = BACKBONES[net]
        self.backbone = cls()
        self.fc1 = nn.Conv3d(fs, fs, 1)
        self.fc2 = nn.Conv3d(fs, dim, 1)
        self.kaiming = net == "r50"

    def forward(self, x, prec=FP32):
        h = self.backbone(x, prec).mean(dim=(2, 3, 4))
        h = torch.relu(F.linear(prec.op(h), prec.op(self.fc1.weight.flatten(1)),
                                self.fc1.bias))
        return F.linear(prec.op(h), prec.op(self.fc2.weight.flatten(1)),
                        self.fc2.bias)


def _default_init(mod, gen):
    """torch's default initialiser of a conv with bias, from `gen`."""
    fan_in = mod.weight[0].numel()
    nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=gen)
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(mod.bias, -bound, bound, generator=gen)


@torch.no_grad()
def init_(enc: Encoder, gen: torch.Generator) -> None:
    """The reference's initialisers, drawn from `gen` in module order:
    convolutions N(0, 0.01) (S3D) or kaiming normal with fan_out (r50),
    BatchNorm weight 1 and bias 0, then the head's default initialiser."""
    for mod in enc.backbone.modules():
        if isinstance(mod, nn.Conv3d):
            if enc.kaiming:
                nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                        nonlinearity="relu", generator=gen)
            else:
                nn.init.normal_(mod.weight, 0.0, 0.01, generator=gen)
        elif isinstance(mod, nn.BatchNorm3d):
            mod.reset_parameters()
    _default_init(enc.fc1, gen)
    _default_init(enc.fc2, gen)


def l2_normalize(x, eps: float = 1e-12):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


HEAD = {"2": "fc1", "4": "fc2"}


def ref_name(key: str) -> str:
    """An encoder key of the reference's grammar (`0.<backbone key>`,
    `2.weight`, `4.bias`, ...) as this module's Encoder names it."""
    first, _, rest = key.partition(".")
    return ("backbone." if first == "0" else HEAD[first] + ".") + rest


STEM = {"s3d": "0.Conv_1a", "r50": "0.bn1"}


def stem(enc: Encoder, net: str, x, prec=FP32):
    """The first block's output, where STEM names it in the port's
    encoder: S3D's Conv_1a (both convolutions, BatchNorms and ReLUs),
    ResNet-2d3d's stem convolution and BatchNorm (before its ReLU)."""
    b = enc.backbone
    if net == "s3d":
        return b.Conv_1a(x, prec)
    return bn(b.bn1, conv(b.conv1, x, prec))
