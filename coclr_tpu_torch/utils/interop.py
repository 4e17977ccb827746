"""Carry the JAX package's weights into the port.

`state_dict_from_jax` turns coclr_tpu parameters and batch statistics
(nested dicts of numpy arrays, as `jax.device_get(state.params_q)` gives
them) into a state dict that the port's modules load with
`load_state_dict(strict=True)`. The mapping re-implements
coclr_tpu/utils/torch_interop.py (torch_from_flax_*):

  conv kernel [kt, kh, kw, I, O]  -> weight [O, I, kt, kh, kw]
  Dense kernel [I, O]             -> weight [O, I] (gating Linear), or
                                     [O, I, 1, 1, 1] (the head's 1x1x1 convs)
  scale / bias                    -> weight / bias
  batch_stats mean / var          -> running_mean / running_var
  flax module path branchN_j      -> branchN.j (branch0 -> branch0.0)
                  layerN_i        -> layerN.i (ResNet-2d3d)
                  downsample_conv -> downsample.0, downsample_bn -> downsample.1

S3D members are emitted twice, under their own name and under the
reference's duplicate `blockN.i` registration. The queues stay [K, dim], the
port's layout; CoCLR's sampler is emitted as `sampler.*`.
`classifier_state_dict_from_jax` does the same for the eval suite's
LinearClassifier.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

S3D_BLOCK_ALIASES = {
    "Conv_1a": ("block1", 0),
    "Conv_2b": ("block2", 1),
    "Conv_2c": ("block2", 2),
    "Mixed_3b": ("block3", 1),
    "Mixed_3c": ("block3", 2),
    "Mixed_4b": ("block4", 1),
    "Mixed_4c": ("block4", 2),
    "Mixed_4d": ("block4", 3),
    "Mixed_4e": ("block4", 4),
    "Mixed_4f": ("block4", 5),
    "Mixed_5b": ("block5", 1),
    "Mixed_5c": ("block5", 2),
}


def flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    """Nested dicts -> {path tuple: leaf}."""
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict):
            out.update(flatten(val, path))
        else:
            out[path] = val
    return out


DOWNSAMPLE = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _module_path(path) -> str:
    parts = []
    for p in path:
        m = re.fullmatch(r"(branch\d|layer\d)_(\d+)", p)
        if p == "branch0":
            parts += ["branch0", "0"]
        elif m:
            parts += [m.group(1), m.group(2)]
        elif p in DOWNSAMPLE:
            parts.append(DOWNSAMPLE[p])
        else:
            parts.append(p)
    return ".".join(parts)


def backbone_state_dict_from_jax(params, stats) -> Dict[str, torch.Tensor]:
    """Backbone params / batch_stats -> backbone state dict (with the S3D
    blockN aliases)."""
    sd: Dict[str, torch.Tensor] = {}

    def emit(key, val):
        t = torch.from_numpy(np.array(val))
        sd[key] = t
        head, _, rest = key.partition(".")
        if head in S3D_BLOCK_ALIASES:
            blk, idx = S3D_BLOCK_ALIASES[head]
            sd["%s.%d.%s" % (blk, idx, rest)] = t

    for path, val in flatten(params).items():
        val = np.asarray(val, dtype=np.float32)
        base, leaf = _module_path(path[:-1]), path[-1]
        if leaf == "kernel":
            val = val.transpose(4, 3, 0, 1, 2) if val.ndim == 5 else val.T
            emit(base + ".weight", val)
        elif leaf == "scale":
            emit(base + ".weight", val)
        elif leaf == "bias":
            emit(base + ".bias", val)
        else:
            raise ValueError("unexpected parameter %s" % "/".join(path))
    for path, val in flatten(stats).items():
        val = np.asarray(val, dtype=np.float32)
        base, leaf = _module_path(path[:-1]), path[-1]
        if leaf == "mean":
            emit(base + ".running_mean", val)
        elif leaf == "var":
            emit(base + ".running_var", val)
            emit(base + ".num_batches_tracked", np.asarray(0, dtype=np.int64))
        else:
            raise ValueError("unexpected statistic %s" % "/".join(path))
    return sd


def encoder_state_dict_from_jax(params, stats) -> Dict[str, torch.Tensor]:
    """ProjectionEncoder params / batch_stats -> ProjectionEncoder state dict
    ({'0.<backbone>', '2.*', '4.*'})."""
    bb = backbone_state_dict_from_jax(params["backbone"],
                                      stats.get("backbone", {}))
    sd = {"0." + k: v for k, v in bb.items()}
    for name, idx in (("fc1", "2"), ("fc2", "4")):
        kernel = np.asarray(params[name]["kernel"], dtype=np.float32)  # [I, O]
        sd[idx + ".weight"] = torch.from_numpy(
            np.array(kernel.T[:, :, None, None, None]))
        sd[idx + ".bias"] = torch.from_numpy(
            np.array(params[name]["bias"], dtype=np.float32))
    return sd


def state_dict_from_jax(params_q, stats_q, params_k=None, stats_k=None,
                        queue=None, queue_ptr: Optional[int] = None, *,
                        queue_label=None, params_s=None, stats_s=None,
                        queue_second=None, queue_vname=None
                        ) -> Dict[str, torch.Tensor]:
    """A MoCo state of the JAX package -> the port's MoCo state dict.

    params_k / stats_k default to the query encoder's (the JAX package
    starts encoder_k as a copy); queue and queue_second are [K, dim];
    queue_label (UberNCE, CoCLR) and, for CoCLR, the sampler's params_s /
    stats_s, queue_second and queue_vname complete a state that the port's
    MoCo of that variant loads with strict=True."""
    sd = {"encoder_q." + k: v
          for k, v in encoder_state_dict_from_jax(params_q, stats_q).items()}
    if params_k is None:
        params_k, stats_k = params_q, stats_q
    sd.update({"encoder_k." + k: v
               for k, v in encoder_state_dict_from_jax(params_k, stats_k).items()})
    if params_s is not None:
        sd.update({"sampler." + k: v for k, v in
                   encoder_state_dict_from_jax(params_s, stats_s).items()})
    for key, val in (("queue", queue), ("queue_second", queue_second)):
        if val is not None:
            sd[key] = torch.from_numpy(np.array(val, dtype=np.float32))
    for key, val in (("queue_label", queue_label), ("queue_vname", queue_vname)):
        if val is not None:
            sd[key] = torch.from_numpy(np.array(val, dtype=np.int64))
    if queue_ptr is not None:
        sd["queue_ptr"] = torch.tensor([int(queue_ptr)], dtype=torch.long)
    return sd


def classifier_state_dict_from_jax(params, stats) -> Dict[str, torch.Tensor]:
    """A LinearClassifier of the JAX package (params / batch_stats) -> the
    port's LinearClassifier state dict ({'backbone.*', 'final_bn.*' where
    the head has one, 'final_fc.*'}), the reference classifier's keys."""
    sd = {"backbone." + k: v for k, v in backbone_state_dict_from_jax(
        params["backbone"], stats.get("backbone", {})).items()}
    if "final_bn" in params:
        bn = backbone_state_dict_from_jax({"final_bn": params["final_bn"]},
                                          {"final_bn": stats["final_bn"]})
        sd.update(bn)
    fc = params["final_fc"]
    sd["final_fc.weight"] = torch.from_numpy(
        np.array(np.asarray(fc["kernel"], dtype=np.float32).T))
    sd["final_fc.bias"] = torch.from_numpy(
        np.array(fc["bias"], dtype=np.float32))
    return sd
