"""Plain PyTorch reference of the pretraining augmentation, in float32.

The random draws are those the port makes for a step, worked out again from
the run's seed: a `torch.Generator` on the clips' device, seeded with
`step_seed(seed, iteration)`, and the draws in the order and shapes of
coclr_tpu_torch/ops/augment.py draw_aug_params and the seed arithmetic of
coclr_tpu_torch/train/pretrain.py step_seed (frozen copies, commit
aac8d1afaaa1f842512867f379867b56b8e4edf4). What is done with them is
written here from the reference's definitions (utils/augmentation.py of
CoCLR; torchvision's ColorJitter, RandomGray, GaussianBlur, HFlip,
Normalize), not from the port's kernel:

  per clip unit, with its own op order: brightness, contrast (to the
  frame's mean luma), saturation (to each pixel's luma), hue (HSV
  rotation), each clamped to [0, 1]; then RandomGray (every channel set to
  one channel drawn per frame); Normalize with ImageNet's mean and std;
  then a separable Gaussian blur of 13 taps renormalised at the borders,
  and a horizontal flip, which the port applies before its W blur.

Imports nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BLUR_RADIUS = 6


def step_seed(seed: int, iteration: int) -> int:
    """The seed of a one-process run's draws at `iteration`."""
    return (seed * 1_000_003 + iteration) % (1 << 32)


def draw(gen: torch.Generator, aug_base, frames: int,
         strength=(0.4, 0.4, 0.4, 0.1)):
    """The step's draws for the [B, n] clip units of `aug_base` of `frames`
    frames each. Returns per clip unit factors fb, fc, fs (1 = identity),
    hue shift fh (0 = identity), the op order `perm` [m, 4], do_gray,
    do_blur, sigma, do_flip; and per frame the gray channel `ch`."""
    dev = aug_base.device
    m = aug_base.numel()
    base = aug_base.reshape(m).to(torch.bool)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(m, generator=gen, device=dev)

    sb, sc, ss, sh = strength
    do_jit = base & (uniform(0.0, 1.0) < 0.8)
    one, zero = torch.ones(m, device=dev), torch.zeros(m, device=dev)
    fb = torch.where(do_jit, uniform(max(0.0, 1 - sb), 1 + sb), one)
    fc = torch.where(do_jit, uniform(max(0.0, 1 - sc), 1 + sc), one)
    fs = torch.where(do_jit, uniform(max(0.0, 1 - ss), 1 + ss), one)
    fh = torch.where(do_jit, uniform(-sh, sh), zero)
    perm = torch.argsort(torch.rand((m, 4), generator=gen, device=dev), dim=1)
    do_gray = base & (uniform(0.0, 1.0) < 0.2)
    ch = torch.randint(0, 3, (m * frames,), generator=gen, device=dev)
    do_blur = base & (uniform(0.0, 1.0) < 0.5)
    sigma = uniform(0.1, 2.0)
    do_flip = uniform(0.0, 1.0) < 0.5
    return dict(fb=fb, fc=fc, fs=fs, fh=fh, perm=perm, do_gray=do_gray, ch=ch,
                do_blur=do_blur, sigma=sigma, do_flip=do_flip)


def _luma(x):
    return 0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2]


def _hue(x, fh):
    """Rotate the hue of x [F, 3, H, W] in [0, 1] by fh [F] turns (HSV)."""
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    maxc = torch.max(x, dim=1).values
    minc = torch.min(x, dim=1).values
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), 0.0)
    d = delta.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / d, (maxc - g) / d, (maxc - b) / d
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    h = torch.remainder(h + fh[:, None, None], 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.long() % 6
    v = maxc
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    table = torch.stack([torch.stack(c, 0) for c in (
        (v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))], 0)
    out = torch.gather(table, 1, i[None, None].expand(3, 1, *i.shape))[:, 0]
    return out.permute(1, 0, 2, 3).clamp(0.0, 1.0)


def color(x_u8, fb, fc, fs, fh, perm, gray_ch):
    """ColorJitter in each frame's clip-unit order, RandomGray, Normalize.
    x_u8: [F, H, W, 3] uint8; per-frame fb, fc, fs, fh [F], perm [F, 4],
    gray_ch [F] (-1 keeps colour). Returns [F, 3, H, W] float32."""
    x = x_u8.permute(0, 3, 1, 2).float() / 255.0
    col = lambda v: v[:, None, None, None]
    for pos in range(4):
        op = perm[:, pos]
        out = x
        sel = op == 0
        if sel.any():
            out = torch.where(col(sel), (x * col(fb)).clamp(0, 1), out)
        sel = op == 1
        if sel.any():
            mean = _luma(x).mean(dim=(1, 2))
            y = (x * col(fc) + col(mean * (1 - fc))).clamp(0, 1)
            out = torch.where(col(sel), y, out)
        sel = op == 2
        if sel.any():
            y = (x * col(fs) + (_luma(x) * (1 - fs)[:, None, None])[:, None])
            out = torch.where(col(sel), y.clamp(0, 1), out)
        sel = (op == 3) & (fh != 0)
        if sel.any():
            out = torch.where(col(sel), _hue(x, fh), out)
        x = out
    keep = gray_ch < 0
    gray = torch.gather(x, 1, gray_ch.clamp_min(0)[:, None, None, None]
                        .expand(-1, 1, *x.shape[2:]))
    x = torch.where(col(keep), x, gray.expand_as(x))
    mean = torch.tensor(MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def blur_axis(x, sigma, dim):
    """Gaussian blur of x along `dim` with 2 * BLUR_RADIUS + 1 taps of
    exp(-d^2 / 2 sigma^2), renormalised where the window leaves the image:
    the zero-padded blur of x over the zero-padded blur of ones."""
    d = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, device=x.device,
                     dtype=torch.float32)
    taps = torch.exp(-0.5 * (d / max(float(sigma), 1e-6)) ** 2)
    moved = x.movedim(dim, -1)
    flat = moved.reshape(-1, 1, moved.shape[-1])
    num = F.conv1d(flat, taps.view(1, 1, -1), padding=BLUR_RADIUS)
    den = F.conv1d(torch.ones_like(flat[:1]), taps.view(1, 1, -1),
                   padding=BLUR_RADIUS)
    return (num / den).reshape(moved.shape).movedim(-1, dim)


def augment(seq_u8, aug_base, gen, chunk: int = 8):
    """The step's augmentation of seq_u8 [B, n, L, H, W, 3] uint8 (the
    frames of each clip unit; RGB and flow concatenated along L for CoCLR)
    with the draws of `gen`. Returns [B, n, L, H, W, 3] float32, in the
    layout of the port's output."""
    b, n, L, H, W, _ = seq_u8.shape
    p = draw(gen, aug_base, L)
    m = b * n
    units = seq_u8.reshape(m, L, H, W, 3)
    out = torch.empty((m, L, H, W, 3), dtype=torch.float32,
                      device=seq_u8.device)
    gray = torch.where(p["do_gray"].repeat_interleave(L), p["ch"], -1)
    for lo in range(0, m, chunk):
        hi = min(m, lo + chunk)
        rep = lambda v: v[lo:hi].repeat_interleave(L, dim=0)
        x = color(units[lo:hi].reshape(-1, H, W, 3), rep(p["fb"]),
                  rep(p["fc"]), rep(p["fs"]), rep(p["fh"]), rep(p["perm"]),
                  gray[lo * L:hi * L]).reshape(hi - lo, L, 3, H, W)
        for j in range(hi - lo):
            u = lo + j
            y = x[j]
            if p["do_flip"][u]:
                y = y.flip(-1)
            if p["do_blur"][u]:
                y = blur_axis(blur_axis(y, p["sigma"][u], 2), p["sigma"][u], 3)
            out[u] = y.permute(0, 2, 3, 1)
    return out.reshape(b, n, L, H, W, 3)
