"""Plain reference of the backward of a 1-D max pool, the work of the
port's pool-backward kernel at one of its launches: x [P, N, Q] padded
with -inf by `lo` on each side, windows of `k` taps at stride `s` along N,
out and g [P, M, Q]. Each window's gradient goes to its first tap equal to
the window's max (a window with no such tap passes none), taps added in
increasing offset in float32, the sum rounded to x's dtype once. Written
from that definition (the JAX package's reduce_window gradient, as
coclr_tpu/ops/pallas_pool.py states it); imports nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pool1d_bwd(x, out, g, k: int, s: int, lo: int):
    p, n, q = x.shape
    m = out.shape[1]
    xp = F.pad(x.float(), [0, 0, lo, lo], value=float("-inf"))
    taps = torch.stack([xp[:, d:d + s * (m - 1) + 1:s] for d in range(k)], -1)
    hit = taps == out.float().unsqueeze(-1)
    first = torch.where(hit.any(-1), hit.int().argmax(-1), -1)
    dx = torch.zeros((p, n + 2 * lo, q), dtype=torch.float32, device=x.device)
    gf = g.float()
    for d in range(k):
        dx[:, d:d + s * (m - 1) + 1:s] += torch.where(first == d, gf, 0.0)
    return dx[:, lo:lo + n].to(x.dtype)
