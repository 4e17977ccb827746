"""Linear / finetune classifier, ported from coclr_tpu/models/classifier.py
(the reference's model/classifier.py): backbone, a float32 mean over T, H
and W, optional L2 norm, optional final BatchNorm1d, dropout and the final
Linear layer. Returns (logits, pooled feature). The head is initialised
N(0, 0.01) with a zero bias; final_bn starts at weight 1, bias 0.

Parameter names are the reference's (`backbone.*`, `final_bn.*`,
`final_fc.*`), so the state dict reads back into the JAX package through
coclr_tpu/utils/torch_interop.py::flax_from_torch_classifier.

With `freeze_backbone` (the linear probe), the backbone takes no gradient
and stays in eval mode whatever `train()` is asked for, while final_bn
trains (the reference's model.eval() + final_bn.train()); its forward runs
without autograd, so no backward runs through it.

Under sequence parallelism (`sp`, ops/seqpar.py) the backbone runs on this
member's T and H chunk and the pooled feature is the mean of the members'
means (sp_pmean), as in models/encoder.py: every member holds the same
feature, so the head (L2 norm, final_bn, dropout, final_fc) needs no sync.
A frozen backbone still runs its halos and sp_pmeans, without autograd.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from coclr_tpu_torch.backbones import select_backbone
from coclr_tpu_torch.backbones.norm import FoldedBatchNorm1d
from coclr_tpu_torch.models.encoder import init_backbone_
from coclr_tpu_torch.ops.seqpar import sp_pmean


def dropout(h, rate: float, gen: Optional[torch.Generator]):
    """Inverted dropout with the keep mask drawn from `gen`: each element
    is kept with probability 1 - rate and scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return h
    keep = torch.rand(h.shape, generator=gen, device=h.device) >= rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


class LinearClassifier(nn.Module):
    def __init__(self, num_class: int = 101, network: str = "s3d",
                 dropout: float = 0.5, use_dropout: bool = True,
                 use_l2_norm: bool = False, use_final_bn: bool = False,
                 freeze_backbone: bool = False, dtype=torch.bfloat16,
                 gen: Optional[torch.Generator] = None, sp=None):
        super().__init__()
        if gen is None:
            gen = torch.Generator().manual_seed(0)
        self.sp = sp
        self.backbone, param = select_backbone(network, dtype=dtype, sp=sp)
        fs = param["feature_size"]
        self.dropout = dropout if use_dropout else 0.0
        self.use_l2_norm = use_l2_norm
        self.freeze_backbone = freeze_backbone
        self.final_bn = FoldedBatchNorm1d(fs) if use_final_bn else None
        self.final_fc = nn.Linear(fs, num_class)
        init_backbone_(self.backbone, gen)
        with torch.no_grad():
            nn.init.normal_(self.final_fc.weight, 0.0, 0.01, generator=gen)
            nn.init.zeros_(self.final_fc.bias)
        if freeze_backbone:
            self.backbone.requires_grad_(False)
            self.backbone.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_backbone:
            self.backbone.eval()
        return self

    def forward(self, x, drop_gen: Optional[torch.Generator] = None):
        """x: [B, C, T, H, W]; returns (logits [B, num_class] float32,
        feature [B, feature_size] float32). Dropout applies in training
        mode, with its mask drawn from `drop_gen`."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_backbone):
            feat = sp_pmean(self.backbone(x).to(torch.float32)
                            .mean(dim=(2, 3, 4)), self.sp)
        if self.use_l2_norm:
            feat = feat / torch.clamp_min(
                torch.linalg.vector_norm(feat, dim=-1, keepdim=True), 1e-12)
        h = feat
        if self.final_bn is not None:
            h = self.final_bn(h)
        if self.training:
            h = dropout(h, self.dropout, drop_gen)
        return F.linear(h, self.final_fc.weight, self.final_fc.bias), feat
