"""Plain PyTorch reference of the pretraining encoders: a backbone, found
by the configuration's `net` as nets/<net>.py (`load_net`), the projection
head, and their initial weights drawn from the seed; and the layers that
the backbones share.

Frozen copy of coclr_tpu_torch/models/encoder.py at commit
aac8d1afaaa1f842512867f379867b56b8e4edf4, rewritten without the port's
kernels, folded BatchNorm or sequence parallelism: float32 convolutions,
torch's own batch norm and 3-D max pool. Each backbone registers its
modules in the port's order, so `init_` draws every weight from the seed's
generator in the same sequence as the port does. Imports nothing of the
port.

`Precision` puts the control in place: with `fp8` set, every convolution and
matmul of the encoders reads its operands rounded to float8 e4m3 (per-tensor
scale) and its incoming gradient rounded to float8 e5m2, the usual fp8
training recipe, one step below the bfloat16 the configurations state.
"""

from __future__ import annotations

import functools
import importlib.util
import math
import os

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


EXPORTS = ("Backbone", "FEATURES", "pool", "init_", "STEM", "stem")
NETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nets")


def load_net(name: str):
    """nets/<name>.py, the reference of the backbone that a configuration's
    `net` names, loaded by file path. It exports `Backbone` (built with no
    arguments; forward(x, prec)), `FEATURES` (the pooled feature size),
    `pool(h)` (the backbone's output to [B, FEATURES]), `init_(backbone,
    gen)` (its weights drawn from `gen` in the port's module order), `STEM`
    (the port's encoder key of its first block) and `stem(backbone, x,
    prec)` (that block's output)."""
    return _load(os.path.join(NETS, name + ".py"), name)


@functools.lru_cache(maxsize=None)
def _load(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reference network {name!r}: write {path}, "
                                f"exporting {', '.join(EXPORTS)}")
    spec = importlib.util.spec_from_file_location("gpubench_net_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [n for n in EXPORTS if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"{path} does not export {', '.join(missing)}")
    return mod


class Encoder(nn.Module):
    """backbone -> its pool to [B, features] -> fc1 -> ReLU -> fc2; the two
    fcs are 1x1x1 convolutions with bias (the reference's key grammar),
    applied as matmuls on the pooled features. Returns unnormalised
    [B, dim]."""

    def __init__(self, net: str, dim: int):
        super().__init__()
        spec = load_net(net)
        self.net = net
        self.backbone = spec.Backbone()
        self.fc1 = nn.Conv3d(spec.FEATURES, spec.FEATURES, 1)
        self.fc2 = nn.Conv3d(spec.FEATURES, dim, 1)

    def forward(self, x, prec=FP32):
        h = load_net(self.net).pool(self.backbone(x, prec))
        h = torch.relu(F.linear(prec.op(h), prec.op(self.fc1.weight.flatten(1)),
                                self.fc1.bias))
        return F.linear(prec.op(h), prec.op(self.fc2.weight.flatten(1)),
                        self.fc2.bias)


def default_init(mod, gen):
    """torch's default initialiser of a layer with bias (a convolution or
    nn.Linear), from `gen`."""
    fan_in = mod.weight[0].numel()
    nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=gen)
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(mod.bias, -bound, bound, generator=gen)


@torch.no_grad()
def init_(enc: Encoder, gen: torch.Generator) -> None:
    """The reference's initialisers, drawn from `gen` in the port's module
    order: the backbone's own (its nets/ module's `init_`), then the head's
    default initialiser."""
    load_net(enc.net).init_(enc.backbone, gen)
    default_init(enc.fc1, gen)
    default_init(enc.fc2, gen)


def l2_normalize(x, eps: float = 1e-12):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


HEAD = {"2": "fc1", "4": "fc2"}


def ref_name(key: str) -> str:
    """An encoder key of the reference's grammar (`0.<backbone key>`,
    `2.weight`, `4.bias`, ...) as this module's Encoder names it."""
    first, _, rest = key.partition(".")
    return ("backbone." if first == "0" else HEAD[first] + ".") + rest


def stem(enc: Encoder, x, prec=FP32):
    """The output of the backbone's first block, the one that its nets/
    module's STEM names in the port's encoder."""
    return load_net(enc.net).stem(enc.backbone, x, prec)
