"""Checkpoint initialisation paths for pretraining, ported from
coclr_tpu/train/init_surgery.py.

  --pretrain (main_nce): weights only. encoder_q of the file goes into
      encoder_q and encoder_k; the fresh queue and queue_ptr are kept.
  CoCLR's two-checkpoint init (main_coclr.py):
      first file's encoder_q  -> encoder_q and encoder_k
      second file's encoder_q -> the frozen sampler
      queues are never imported, so queue_label stays -1 and the
      queue-fill gate holds.

The port reads `.pth.tar` files only, in the reference layout: the one the
port writes (utils/checkpoint.py) and the one that
coclr_tpu/utils/torch_interop.py::save_torch_checkpoint writes. A
flax-msgpack `.ckpt` file of the JAX package is converted to `.pth.tar`
first with the repository's tools/convert_checkpoint.py.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from coclr_tpu_torch.models.moco import MoCo
from coclr_tpu_torch.utils.checkpoint import load_checkpoint

_PREFIX = "encoder_q."


def load_encoder_q(path: str) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict of encoder_q (prefix stripped) from a `.pth.tar`
    file, or None if the file is missing."""
    if not os.path.isfile(path):
        return None
    sd = load_checkpoint(path)["state_dict"]
    return {k[len(_PREFIX):]: v for k, v in sd.items() if k.startswith(_PREFIX)}


def _load_q_and_k(model: MoCo, sd: Dict[str, torch.Tensor]) -> None:
    model.encoder_q.load_state_dict(sd, strict=True)
    model.encoder_k.load_state_dict(sd, strict=True)


def init_pretrain_weights(model: MoCo, path: str) -> MoCo:
    """--pretrain for main_nce: encoder_q of `path` into encoder_q and
    encoder_k; the queues keep their fresh values."""
    sd = load_encoder_q(path)
    if sd is None:
        print(f"=> no checkpoint found at '{path}', use random init")
        return model
    print(f"=> loaded pretrained encoder_q from '{path}' into q and k")
    _load_q_and_k(model, sd)
    return model


def coclr_surgery(model: MoCo, pretrain_paths: Tuple[str, str]) -> MoCo:
    """Two-checkpoint CoCLR init (main_coclr.py)."""
    first, second = pretrain_paths
    sd = load_encoder_q(second)
    if sd is not None:
        print(f"=> Use Oracle checkpoint '{second}' (-> sampler)")
        model.sampler.load_state_dict(sd, strict=True)
    else:
        print(f"=> NO Oracle checkpoint found at '{second}', use random init")

    sd = load_encoder_q(first)
    if sd is not None:
        print(f"=> Use Training checkpoint '{first}' (-> encoder_q, encoder_k)")
        _load_q_and_k(model, sd)
    else:
        print(f"=> NO Training checkpoint found at '{first}', use random init")
    return model
