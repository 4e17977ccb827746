"""Kernel 1: fused ColorJitter + RandomGray + Normalize (csrc/jitter.cu).

`fused_jitter_normalize` keeps the signature and layout of the TPU kernel
it replaces (coclr_tpu/ops/pallas_aug.py::fused_jitter_normalize): uint8
frames [F, 3, S1, S2] in, [F, 3, S1, S2] out. The frames may be a strided
view: the kernel reads channel-planar frames and channels-last frames (the
[F, S1, S2, 3] -> [F, 3, S1, S2] permute view) in place. On a CUDA tensor
it launches the CUDA kernel; on a CPU tensor it runs
`jitter_normalize_plain`, the same function in plain PyTorch, which the
tests and the on-card comparison use.
"""

from __future__ import annotations

import ctypes

import torch

from coclr_tpu_torch.kernels.build import CudaKernel, register

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FIXED_ORDER_CODE = 228  # packed [0, 1, 2, 3]: brightness, contrast, saturation, hue

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
KERNEL = register(CudaKernel(
    "jitter", "coclr_jitter_normalize",
    [_P] * 8 + [_I, _I, ctypes.c_longlong, _I, _I] + [_F] * 6 + [_P]))


def _luma(r, g, b):
    return 0.299 * r + 0.587 * g + 0.114 * b


def _mod1(a):
    return torch.remainder(a, 1.0)


def hue_rotate_plain(r, g, b, fh):
    """HSV hue rotation by fh turns on float32 planes, with the where-chain
    tie order of pallas_aug._hue_rotate."""
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12),
                    torch.zeros_like(maxc))
    safe = torch.clamp_min(delta, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = _mod1(h / 6.0)
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    h = _mod1(h + fh)
    v = maxc
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def pick(opts):
        out = opts[5]
        for idx in range(4, -1, -1):
            out = torch.where(i == idx, opts[idx], out)
        return out

    r2 = pick([v, q, p, p, t, v])
    g2 = pick([t, v, v, q, p, p])
    b2 = pick([p, p, t, v, v, q])
    return r2.clamp(0.0, 1.0), g2.clamp(0.0, 1.0), b2.clamp(0.0, 1.0)


def jitter_normalize_plain(x_planar_u8, fb, fc, fs, fh, gray_sel, orders,
                           out_dtype=torch.bfloat16, mean=IMAGENET_MEAN,
                           std=IMAGENET_STD):
    """Plain PyTorch version of the kernel, float32 inside. Each of the four
    op positions computes all four candidate ops on every frame and selects
    each frame's own (the positional-select form of ops/augment.py)."""
    x = x_planar_u8.to(torch.float32) * (1.0 / 255.0)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    col = lambda v: v.to(torch.float32)[:, None, None]
    fb, fc, fs, fh = col(fb), col(fc), col(fs), col(fh)
    orders = orders.to(torch.int32)
    for pos in range(4):
        code = ((orders >> (2 * pos)) & 3)[:, None, None]
        bright = [(c * fb).clamp(0.0, 1.0) for c in (r, g, b)]
        lmean = _luma(r, g, b).mean(dim=(1, 2))[:, None, None] * (1.0 - fc)
        contrast = [(c * fc + lmean).clamp(0.0, 1.0) for c in (r, g, b)]
        lum = _luma(r, g, b) * (1.0 - fs)
        sat = [(c * fs + lum).clamp(0.0, 1.0) for c in (r, g, b)]
        rot = hue_rotate_plain(r, g, b, fh)
        keep = fh == 0.0
        hue = [torch.where(keep, c, cr) for c, cr in zip((r, g, b), rot)]
        r, g, b = [torch.where(code == 0, bright[j],
                               torch.where(code == 1, contrast[j],
                                           torch.where(code == 2, sat[j], hue[j])))
                   for j in range(3)]
    sel = gray_sel.to(torch.int64)[:, None, None]
    gray = torch.where(sel == 0, r, torch.where(sel == 1, g, b))
    r, g, b = [torch.where(sel >= 0, gray, c) for c in (r, g, b)]
    out = torch.stack([(c - m) / sd for c, m, sd in zip((r, g, b), mean, std)],
                      dim=1)
    return out.to(out_dtype)


def frame_layout(x):
    """(frame stride, channels_last) for the kernel when each frame of
    x [F, 3, S1, S2] is one contiguous channel-planar or channels-last run,
    else None."""
    f, _, s1, s2 = x.shape
    hw = s1 * s2
    sizes, strides = x.shape[1:], x.stride()[1:]
    same = lambda want: all(n == 1 or st == w
                            for n, st, w in zip(sizes, strides, want))
    fstride = x.stride(0) if f > 1 else 3 * hw
    if fstride < 3 * hw:
        return None
    if same((hw, s2, 1)):
        return fstride, False
    if same((1, 3 * s2, 3)):
        return fstride, True
    return None


def fused_jitter_normalize(x_planar_u8, fb, fc, fs, fh, gray_sel, orders=None,
                           out_dtype=torch.bfloat16, mean=IMAGENET_MEAN,
                           std=IMAGENET_STD):
    """x_planar_u8: [F, 3, S1, S2] uint8, contiguous or a view whose frames
    are channel-planar or channels-last runs. fb/fc/fs/fh: [F] float32 per-frame
    jitter factors (1/1/1/0 = identity). gray_sel: [F] int32, -1 keeps
    colour, else the channel copied to all three. orders: [F] int32 packed
    per-frame op orders (None = fixed brightness, contrast, saturation, hue).
    Returns [F, 3, S1, S2] `out_dtype`, jittered, gray'd and normalized."""
    if x_planar_u8.dim() != 4 or x_planar_u8.shape[1] != 3:
        raise ValueError("expected [F, 3, S1, S2] frames, got %s"
                         % (tuple(x_planar_u8.shape),))
    if x_planar_u8.dtype != torch.uint8:
        raise TypeError("frames must be uint8, got %s" % x_planar_u8.dtype)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("out_dtype must be bfloat16 or float32")
    f = x_planar_u8.shape[0]
    dev = x_planar_u8.device
    if orders is None:
        orders = torch.full((f,), FIXED_ORDER_CODE, dtype=torch.int32, device=dev)
    params = [fb, fc, fs, fh, gray_sel, orders]
    for p in params:
        if p.shape != (f,) or p.device != dev:
            raise ValueError("per-frame parameters must be [%d] on %s" % (f, dev))
    if dev.type == "cpu":
        return jitter_normalize_plain(x_planar_u8, fb, fc, fs, fh, gray_sel,
                                      orders, out_dtype, mean, std)
    if dev.type != "cuda":
        raise ValueError("fused_jitter_normalize runs on cuda or cpu, not %s" % dev)
    x = x_planar_u8
    layout = frame_layout(x)
    if layout is None:
        x = x.contiguous()
        layout = frame_layout(x)
    fstride, channels_last = layout
    fb, fc, fs, fh = [p.to(torch.float32).contiguous() for p in (fb, fc, fs, fh)]
    gray_sel = gray_sel.to(torch.int32).contiguous()
    orders = orders.to(torch.int32).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    hw = x.shape[2] * x.shape[3]
    if f == 0 or hw == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(x.data_ptr(), out.data_ptr(), fb.data_ptr(), fc.data_ptr(),
                      fs.data_ptr(), fh.data_ptr(), gray_sel.data_ptr(),
                      orders.data_ptr(), f, hw, fstride, int(channels_last),
                      int(out_dtype == torch.bfloat16),
                      *[float(m) for m in mean], *[float(s) for s in std], stream)
    return out
