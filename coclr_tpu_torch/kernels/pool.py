"""Kernel 2: the backward of a 1-D max pool (csrc/pool1d_bwd.cu), and the
separable max pool built on it.

`pool1d_bwd` keeps the [P, N, Q] contract of the TPU kernel it replaces
(coclr_tpu/ops/pallas_pool.py::pool1d_bwd). On a CUDA tensor it launches the
CUDA kernel; on a CPU tensor it runs `pool1d_bwd_plain`, the same function in
plain PyTorch. `max_pool_1d` is the autograd function around it: a plain max
over one axis with -inf padding forward (the JAX forward is a reduce_window,
not a Pallas kernel), the kernel backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from coclr_tpu_torch.kernels.build import CudaKernel, register
from coclr_tpu_torch.ops.seqpar import halo, sp_axes

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = register(CudaKernel(
    "pool1d_bwd", "coclr_pool1d_bwd",
    [_P] * 4 + [ctypes.c_longlong] + [_I] * 10 + [_P]))

# Shared memory one block of the kernel stages (x, out, g and the int8 taps
# of its tile): small enough for six blocks on an SM of 228 KB.
SLAB_BYTES = 36 * 1024


class Plan(NamedTuple):
    pt: int    # planes per block
    qt: int    # columns per block (q: whole planes)
    vec: bool  # every run of every tile starts 16-byte aligned


@functools.lru_cache(maxsize=256)
def plan(p: int, n: int, m: int, q: int, itemsize: int) -> Plan:
    """The tile of one block of the kernel for x [p, n, q] and out/g
    [p, m, q]: as many whole [n, q] planes as fit SLAB_BYTES (so that the
    tile's x, out and g are three contiguous runs), rounded so that every
    run starts on 16 bytes (for q == 1 also to 16 bytes of planes, which
    the kernel stages transposed); or, where one plane does not fit, qt
    columns of one plane."""
    vec = 16 // itemsize
    col_bytes = itemsize * (n + 2 * m) + m  # one column of one plane
    room = SLAB_BYTES - 48                  # three regions padded to 16 B
    if q * col_bytes <= room:
        pt = min(p, room // (q * col_bytes))
        step = math.lcm(vec // math.gcd(n * q, vec), vec // math.gcd(m * q, vec))
        if q == 1:  # the kernel transposes 16-byte multiples of planes
            step = math.lcm(step, vec)
        if pt >= step:
            pt -= pt % step
        aligned = pt == p or ((pt * n * q) % vec == 0
                              and (pt * m * q) % vec == 0)
        return Plan(pt, q, aligned)
    qt = room // col_bytes
    if qt < 1:
        raise ValueError("pool1d_bwd: a pooled axis of %d does not fit the "
                         "kernel's tile" % n)
    if qt >= vec:
        qt -= qt % vec
    return Plan(1, qt, q % vec == 0 and qt % vec == 0)


def pool1d_fwd(x, dim: int, k: int, s: int, lo: int):
    """Max over windows of k along `dim`, stride s, lo -inf pads each side."""
    if lo:
        pad = [0, 0] * (x.dim() - 1 - dim) + [lo, lo]
        x = F.pad(x, pad, value=float("-inf"))
    return x.unfold(dim, k, s).amax(dim=-1)


def pool1d_bwd_plain(x, out, g, k: int, s: int, lo: int):
    """Plain PyTorch version of the kernel: each window's g goes to its first
    tap equal to the window max (nowhere if none is); taps are added in
    increasing offset."""
    p, n, q = x.shape
    m = out.shape[1]
    xp = F.pad(x.float(), [0, 0, lo, lo], value=float("-inf"))
    taps = xp.unfold(1, k, s)[:, :m]                       # [P, M, Q, k]
    hit = taps == out.float().unsqueeze(-1)
    first = torch.where(hit.any(dim=-1), hit.to(torch.uint8).argmax(dim=-1), -1)
    gf = g.float()
    dxp = torch.zeros((p, n + 2 * lo, q), dtype=torch.float32, device=x.device)
    for d in range(k):
        dxp[:, d:d + s * (m - 1) + 1:s] += torch.where(first == d, gf, 0.0)
    return dxp[:, lo:lo + n].to(x.dtype)


def pool1d_bwd(x, out, g, k: int, s: int, lo: int):
    """x: [P, N, Q]; out, g: [P, M, Q]. Returns the gradient wrt x, [P, N, Q]
    in x's dtype."""
    if x.dim() != 3:
        raise ValueError("expected x [P, N, Q], got %s" % (tuple(x.shape),))
    p, n, q = x.shape
    m = (n + 2 * lo - k) // s + 1
    if out.shape != (p, m, q) or g.shape != (p, m, q):
        raise ValueError("out and g must be [%d, %d, %d]" % (p, m, q))
    if not (out.dtype == g.dtype == x.dtype):
        raise TypeError("x, out and g must share a dtype")
    if not (0 <= lo < k and s >= 1):
        raise ValueError("need 0 <= lo < k and s >= 1")
    if not (x.device == out.device == g.device):
        raise ValueError("x, out and g must be on one device")
    if x.device.type == "cpu":
        return pool1d_bwd_plain(x, out, g, k, s, lo)
    if x.device.type != "cuda":
        raise ValueError("pool1d_bwd runs on cuda or cpu, not %s" % x.device)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("the CUDA kernel takes bfloat16 or float32, not %s"
                        % x.dtype)
    if q >= 2 ** 31:
        raise ValueError("pool1d_bwd: Q = %d does not fit 32 bits" % q)
    x, out, g = x.contiguous(), out.contiguous(), g.contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    pl = plan(p, n, m, q, x.element_size())
    ptrs = [t.data_ptr() for t in (x, out, g, dx)]
    vec = pl.vec and all(a % 16 == 0 for a in ptrs)
    args = (*ptrs, p, n, m, q, k, s, lo, pl.pt, pl.qt, int(vec),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        KERNEL.launch(*args)
    else:
        with torch.cuda.device(x.device):
            KERNEL.launch(*args)
    return dx


class _MaxPool1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, k, s, lo):
        x = x.contiguous()
        out = pool1d_fwd(x, dim, k, s, lo)
        ctx.save_for_backward(x, out)
        ctx.cfg = (dim, k, s, lo)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        dim, k, s, lo = ctx.cfg
        shape = x.shape
        p = math.prod(shape[:dim])
        q = math.prod(shape[dim + 1:])
        m = out.shape[dim]
        dx = pool1d_bwd(x.reshape(p, shape[dim], q), out.reshape(p, m, q),
                        g.contiguous().reshape(p, m, q), k, s, lo)
        return dx.reshape(shape), None, None, None, None


def max_pool_1d(x, dim: int, k: int, s: int, lo: int):
    """1-D max pool along `dim` whose backward is the pool1d_bwd kernel."""
    return _MaxPool1d.apply(x, dim, k, s, lo)


def max_pool_3d(x, window, strides, padding, sp=None):
    """Max pool over the (T, H, W) axes of [B, C, T, H, W] as up to three
    separable 1-D pools, in T, H, W order. The forward equals one 3-D pool;
    the backward routes ties first-per-axis (coclr_tpu/backbones/s3d.py
    max_pool_3d), not in cuDNN's 3-D window order. `padding` is symmetric
    per axis.

    Under sequence parallelism (`sp`, an ops/seqpar.py spec) a pool along a
    sharded T or H axis runs unpadded (lo = 0) on the halo-extended local
    block; the zeros at the global edges equal the -inf pad in value on
    these post-ReLU inputs, and a gradient routed to such a zero is dropped
    by the halo's backward, as one routed to a real zero is by the ReLU."""
    groups = {2: sp_axes(sp).t, 3: sp_axes(sp).h}
    for dim, k, s, lo in zip((2, 3, 4), window, strides, padding):
        if k == 1 and s == 1 and lo == 0:
            continue
        group = groups.get(dim)
        if group is not None and (k > 1 or lo):
            if x.shape[dim] % s:
                raise ValueError(f"the local chunk {x.shape[dim]} (dim {dim})"
                                 f" does not divide by the pool stride {s} "
                                 "under sequence parallelism")
            x = halo(x, lo, lo, group, dim)
            lo = 0
        x = max_pool_1d(x, dim, k, s, lo)
    return x
