"""Checkpoint IO in the reference's `.pth.tar` format (main_nce.py and
eval/main_classifier.py: {'epoch', 'state_dict', 'best_acc', 'optimizer',
'iteration'}), for the pretraining models and the classifier alike, with the
rotation semantics of coclr_tpu/utils/checkpoint.py (the reference's
utils/utils.py save_checkpoint): saving epoch N removes epoch N - gap unless
keep_all, and at most 5 `model_best_*` files are kept.

The state_dict is in the reference key layout: the port's [K, dim] queues
(`queue`, and CoCLR's `queue_second`) are written [dim, K]; loading
transposes them back. `queue_label` and `queue_vname` are int64, as the
reference keeps them.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict

import torch

_EXT = ".pth.tar"
_QUEUES = ("queue", "queue_second")


def reference_state_dict(model) -> Dict[str, torch.Tensor]:
    """The model's state_dict on the CPU, queues as [dim, K]."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for key in _QUEUES:
        if key in sd:
            sd[key] = sd[key].t().contiguous()
    return sd


def load_reference_state_dict(model, sd: Dict[str, torch.Tensor],
                              strict: bool = True):
    """Inverse of reference_state_dict."""
    sd = dict(sd)
    for key in _QUEUES:
        if key in sd:
            sd[key] = sd[key].t().contiguous()
    return model.load_state_dict(sd, strict=strict)


def save_checkpoint(payload: Dict[str, Any], is_best: bool = False,
                    gap: int = 1, filename: str = "models/epoch0.pth.tar",
                    keep_all: bool = False) -> None:
    """payload: {'epoch', 'state_dict', 'best_acc', 'optimizer',
    'iteration'}; written with torch.save."""
    filename = os.path.abspath(filename)
    d = os.path.dirname(filename)
    os.makedirs(d, exist_ok=True)
    tmp = filename + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, filename)

    epoch = payload.get("epoch", 0)
    m = re.match(r"(.*epoch)(\d+)(\..*)$", filename)
    if not keep_all and m:
        old = "%s%d%s" % (m.group(1), epoch - gap, m.group(3))
        if old != filename and os.path.exists(old):
            os.remove(old)

    if is_best:
        past_best = sorted(
            glob.glob(os.path.join(d, "model_best_*" + _EXT)),
            key=lambda x: int("".join(filter(str.isdigit, os.path.basename(x)))))
        if len(past_best) >= 5:
            os.remove(past_best[0])
        torch.save(payload, os.path.join(d, "model_best_epoch%d%s" % (epoch, _EXT)))


def load_checkpoint(filename: str, map_location="cpu") -> Dict[str, Any]:
    """Inverse of save_checkpoint (tensors, numbers and dicts only)."""
    return torch.load(filename, map_location=map_location, weights_only=True)


def make_payload(model, optimizer, epoch: int, best_acc: float,
                 iteration: int) -> Dict[str, Any]:
    """The checkpoint of a model and its optimizer, reference layout."""
    return {"epoch": epoch, "state_dict": reference_state_dict(model),
            "best_acc": best_acc, "optimizer": optimizer.state_dict(),
            "iteration": iteration}


def resume_from(path: str, model, optimizer):
    """Load a make_payload checkpoint into model (strict) and optimizer;
    returns (start epoch, iteration, best_acc) to carry on from."""
    ckpt = load_checkpoint(path)
    load_reference_state_dict(model, ckpt["state_dict"])
    optimizer.load_state_dict(ckpt["optimizer"])
    print(f"=> resumed '{path}' (epoch {ckpt['epoch']})")
    return (ckpt["epoch"] + 1, ckpt.get("iteration", 1),
            ckpt.get("best_acc", 0.0))
