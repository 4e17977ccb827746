"""Plain PyTorch reference of the MoCo pretraining step (InfoNCE and
CoCLR), in float32 with TF32 off, or in the control's fp8 (models.py
Precision).

Written from the reference's model/pretrain.py, main_nce.py and
main_coclr.py: the key encoder's EMA of the query encoder's parameters,
the key encode (train-mode BatchNorm, no gradient; in one process the key
shuffle is a no-op), for CoCLR the frozen sampler's encode of the other
modality (eval mode) and its positives mask (same source video, joined by
the sampler's top-k in the second queue once the queue is full), logits
[l_pos, l_neg] / t, the loss, Adam (L2 weight decay on the gradient), and
the ring enqueue; for CoCLR also the gated steps that fill the queue
before the optimizer may step (`fill_step`). The initial state is drawn
from the seed in the order of coclr_tpu_torch/models/moco.py MoCo (frozen
copy of the order, commit aac8d1afaaa1f842512867f379867b56b8e4edf4).
`coclr_mask` and `contrastive_loss` are also what the check applies to the
program's own keys and queues at a step. Imports nothing of the port.
"""

from __future__ import annotations

import copy

import torch

from gpubench.reference.models import FP32, Encoder, init_, l2_normalize

NEG_INF = -1e30


def drop_self_draw(seed: int) -> bool:
    """CoCLR's one draw a step of random() < 0.9, from the step's seed."""
    gen = torch.Generator().manual_seed(seed ^ 0x5EED)
    return bool(torch.rand((), generator=gen) < 0.9)


def coclr_mask(kf, vname, queue_second, queue_vname, queue_label, topk):
    """CoCLR's positives [b, 1 + K] (float32): the key itself, the queue
    rows of the same source video and, once no queue_label is -1, the
    sampler's top-k neighbours of `kf` in `queue_second`."""
    mask = vname[:, None] == queue_vname[None, :]
    if topk:
        sim = (kf @ queue_second.t()).masked_fill(mask, NEG_INF)
        mined = torch.zeros_like(mask).scatter_(
            1, sim.topk(topk, dim=1).indices, True)
        if bool(torch.all(queue_label != -1)):
            mask = mask | mined
    return torch.cat([torch.ones_like(mask[:, :1]), mask], 1).float()


def contrastive_loss(q, k, queue, t, mask=None, drop_self=True):
    """InfoNCE over [l_pos, l_neg] / t (no `mask`), or CoCLR's -log of the
    softmax mass on the positives of `mask`, the key itself left out
    (with `drop_self`) where a row has other positives."""
    logits = torch.cat([(q * k).sum(1, keepdim=True), q @ queue.t()], 1) / t
    if mask is None:
        return (torch.logsumexp(logits, 1) - logits[:, 0]).mean()
    used = mask.clone()
    if drop_self:
        used[:, 0] = torch.where(mask.sum(1) != 1, 0.0, mask[:, 0])
    logp = torch.log_softmax(logits, 1)
    return -torch.logsumexp(torch.where(used > 0, logp, NEG_INF), 1).mean()


class RefMoCo:
    """Query and key encoders, the queue(s) and Adam's state."""

    def __init__(self, net: str, dim: int, K: int, seed: int, variant: str,
                 device):
        gen = torch.Generator().manual_seed(seed)
        self.variant = variant
        self.enc_q = Encoder(net, dim)
        init_(self.enc_q, gen)
        self.enc_k = copy.deepcopy(self.enc_q)
        self.queue = l2_normalize(torch.randn(K, dim, generator=gen))
        self.ptr = 0
        if variant == "coclr":
            self.queue_label = torch.full((K,), -1, dtype=torch.long)
            self.queue_vname = torch.full((K,), -1, dtype=torch.long)
            self.queue_second = l2_normalize(torch.randn(K, dim, generator=gen))
            self.sampler = Encoder(net, dim)
            init_(self.sampler, gen)
            self.sampler.eval()
        for name in ("enc_q", "enc_k", "sampler"):
            if hasattr(self, name):
                setattr(self, name, getattr(self, name).to(device))
        for name in ("queue", "queue_label", "queue_vname", "queue_second"):
            if hasattr(self, name):
                setattr(self, name, getattr(self, name).to(device))
        self.enc_k.requires_grad_(False)
        self.adam = {}
        self.t = 0

    @torch.no_grad()
    def _adam(self, params, grads, lr, wd, betas=(0.9, 0.999), eps=1e-8):
        self.t += 1
        b1, b2 = betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g in zip(params, grads):
            g = g + wd * p
            m, v = self.adam.setdefault(id(p), (torch.zeros_like(p),
                                                torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, (v.sqrt() / c2 ** 0.5).add_(eps), value=-lr / c1)

    def step(self, views: dict, lr: float, cfg: dict, prec=FP32,
             drop_self: bool = True, update: bool = True):
        """One step on augmented float32 clips `views`: x1, x2 [B, 3, T, H,
        W] (and f2, vname for CoCLR). Returns (loss, the gradient as the
        optimizer takes it, with the decay term, by parameter name; the
        enqueued keys)."""
        named = list(self.enc_q.named_parameters())
        params = [p for _, p in named]
        with torch.no_grad():
            self._ema(cfg["moco_m"])
            k = l2_normalize(self.enc_k(views["x2"], prec))
            mask = None
            if self.variant == "coclr":
                kf = l2_normalize(self.sampler(views["f2"], prec))
                mask = coclr_mask(kf, views["vname"], self.queue_second,
                                  self.queue_vname, self.queue_label,
                                  cfg["topk"])
        q = l2_normalize(self.enc_q(views["x1"], prec))
        loss = contrastive_loss(q, k, self.queue, cfg["moco_t"], mask,
                                drop_self)
        grads = torch.autograd.grad(loss, params)
        taken = {n: g + cfg["wd"] * p.detach() for (n, p), g in zip(named, grads)}
        if update:
            self._adam(params, grads, lr, cfg["wd"])
        self._enqueue(k, kf if self.variant == "coclr" else None,
                      views.get("vname"))
        return float(loss.detach()), taken, k

    @torch.no_grad()
    def fill_step(self, views: dict, cfg: dict, prec=FP32):
        """A gated CoCLR step, as the queue fills: the key encoder's EMA,
        the keys and the sampler's keys enqueued; the optimizer does not
        step, so nothing else of the state moves."""
        self._ema(cfg["moco_m"])
        k = l2_normalize(self.enc_k(views["x2"], prec))
        kf = l2_normalize(self.sampler(views["f2"], prec))
        self._enqueue(k, kf, views["vname"])

    @torch.no_grad()
    def _ema(self, m: float):
        for pk, pq in zip(self.enc_k.parameters(), self.enc_q.parameters()):
            pk.mul_(m).add_(pq, alpha=1 - m)

    @torch.no_grad()
    def _enqueue(self, k, kf=None, vname=None):
        b = k.shape[0]
        rows = slice(self.ptr, self.ptr + b)
        self.queue[rows] = k
        if self.variant == "coclr":
            self.queue_second[rows] = kf
            self.queue_vname[rows] = vname
            self.queue_label[rows] = 1
        self.ptr = (self.ptr + b) % self.queue.shape[0]
