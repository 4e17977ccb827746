"""The work of a step, counted from its shapes: the model's floating-point
operations, and the bytes of the two hand-written kernels' launches.

- FLOPs: torch.utils.flop_counter.FlopCounterMode over the plain reference
  model (reference/models.py, with the backbone of reference/nets/<net>.py)
  on the meta device, at the cell's shapes: the
  query encoder's forward and backward, the key encoder's forward (and for
  CoCLR the sampler's), and the logits over the queue. Counted once, as the
  algorithm needs them; a recomputation would not be counted.
- Bytes, each input byte read once and each output byte written once,
  whatever implements the op (copies of chip_smoke.py's counts, commit
  aac8d1afaaa1f842512867f379867b56b8e4edf4):
  * jitter: uint8 frames [F, 3, S, S] in, bfloat16 out, six 4-byte
    per-frame parameters;
  * pool backward: every max pool of the query encoder (each
    models.MaxPool3d; a backbone with none launches nothing) as separable
    1-D pools in T, H, W order (kernels/pool.py max_pool_3d), each reading x
    [P, N, Q], out and g [P, M, Q] and writing dx [P, N, Q].
- Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense).
"""

from __future__ import annotations

import math

import torch

from gpubench.reference import models

BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def step_flops(net: str, batch: int, seq_len: int, img: int, dim: int,
               K: int, variant: str) -> int:
    """Floating-point operations of one pretraining step."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        enc = models.Encoder(net, dim)
        x = torch.empty(batch, 3, seq_len, img, img)
        queue = torch.empty(K, dim)
        with FlopCounterMode(display=False) as counter:
            with torch.no_grad():
                k = enc(x)
                if variant == "coclr":
                    enc(x)  # the sampler: the same encoder's shapes
            q = enc(x)
            logits = torch.cat([(q * k).sum(1, keepdim=True), q @ queue.t()], 1)
            logits.logsumexp(1).mean().backward()
    return int(counter.get_total_flops())


def pool_launches(net: str, batch: int, seq_len: int, img: int):
    """(P, N, M, Q) of every pool-backward launch of one query-encoder
    backward, in launch order reversed (forward order)."""
    calls = []
    models.MaxPool3d.record = calls
    try:
        with torch.device("meta"), torch.no_grad():
            models.Encoder(net, 8).backbone(
                torch.empty(batch, 3, seq_len, img, img))
    finally:
        models.MaxPool3d.record = None
    out = []
    for shape, window, strides, padding in calls:
        shape = list(shape)
        for dim, k, s, lo in zip((2, 3, 4), window, strides, padding):
            if k == 1 and s == 1 and lo == 0:
                continue
            n = shape[dim]
            m = (n + 2 * lo - k) // s + 1
            out.append((math.prod(shape[:dim]), n, m,
                        math.prod(shape[dim + 1:])))
            shape[dim] = m
    return out


def pool_bwd_bytes(launches, itemsize: int = 2) -> int:
    return sum(itemsize * 2 * p * q * (n + m) for p, n, m, q in launches)


def jitter_bytes(frames: int, img: int, itemsize: int = 2) -> int:
    """One launch over `frames` frames of img x img: uint8 in, the compute
    dtype out, fb, fc, fs, fh, gray and order (4 bytes each) per frame."""
    return frames * 3 * img * img * (1 + itemsize) + frames * 6 * 4
