"""On-device augmentation of the pretrain clips (the device half of the
reference's utils/augmentation.py), ported from coclr_tpu/ops/augment.py.

The host sends cropped uint8 clips and per-clip `aug_base` flags
(coclr_tpu_torch/data/hostaug.py). Per clip unit:

  base: ColorJitter(0.4, 0.4, 0.4, 0.1) @ p=0.8 in a random op order,
        RandomGray @ p=0.2 (channel chosen per frame),
        GaussianBlur(sigma U[0.1, 2]) @ p=0.5, HFlip @ p=0.5
  null: HFlip @ p=0.5 only

Every random op is split in two: `draw_aug_params` makes all draws with a
`torch.Generator`, `apply_aug` applies them. The tests feed the same draws,
made with jax.random as coclr_tpu draws them, to both packages.

Jitter, gray and normalize run as one CUDA kernel (kernels/jitter.py);
blur and flip are two batched matmuls with the banded `_blur_matrix`, the
flip a row reversal of the W-axis matrix. Normalize commutes with them
because the blur rows sum to 1 and the flip is a permutation.

The eval suite's jitter (classifier training, retrieval extraction and the
N-crop test) is a per-clip RandomApply(p) ColorJitter with no gray, split
the same way: `draw_eval_jitter_params` draws, `apply_eval_jitter` runs the
kernel with gray off on every frame.
"""

from __future__ import annotations

from typing import Dict

import torch

from coclr_tpu_torch.kernels.jitter import (IMAGENET_MEAN, IMAGENET_STD,
                                            fused_jitter_normalize)

BLUR_TAPS = 13  # covers 3 * sigma_max = 6 pixels each side at sigma = 2


def pack_orders(perms):
    """[m, 4] per-clip op permutations -> [m] int32 codes (2 bits per
    position, position 0 in the low bits). [0, 1, 2, 3] packs to 228."""
    perms = perms.to(torch.int32)
    return (perms[:, 0] | (perms[:, 1] << 2) | (perms[:, 2] << 4)
            | (perms[:, 3] << 6))


def draw_aug_params(gen: torch.Generator, aug_base, L: int,
                    strength=(0.4, 0.4, 0.4, 0.1)) -> Dict[str, torch.Tensor]:
    """All random draws of the pretrain augmentation, on aug_base's device.

    aug_base: [B, n] flags. Returns per clip ([m] = [B * n]): the jitter
    factors fb, fc, fs (1 = identity) and hue shift fh (0 = identity), the
    packed op order `orders`, `do_gray`, `do_blur`, `sigma`, `do_flip`; and
    per frame ([m * L]) the gray channel `ch`."""
    dev = aug_base.device
    m = aug_base.numel()
    base = aug_base.reshape(m).to(torch.bool)
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(
        m, generator=gen, device=dev)
    sb, sc, ss, sh = strength
    do_jit = base & (uniform(0.0, 1.0) < 0.8)
    one = torch.ones(m, device=dev)
    fb = torch.where(do_jit, uniform(max(0.0, 1.0 - sb), 1.0 + sb), one)
    fc = torch.where(do_jit, uniform(max(0.0, 1.0 - sc), 1.0 + sc), one)
    fs = torch.where(do_jit, uniform(max(0.0, 1.0 - ss), 1.0 + ss), one)
    fh = torch.where(do_jit, uniform(-sh, sh), torch.zeros(m, device=dev))
    perms = torch.argsort(torch.rand((m, 4), generator=gen, device=dev), dim=1)
    return {
        "fb": fb, "fc": fc, "fs": fs, "fh": fh,
        "orders": pack_orders(perms),
        "do_gray": base & (uniform(0.0, 1.0) < 0.2),
        "ch": torch.randint(0, 3, (m * L,), generator=gen, device=dev),
        "do_blur": base & (uniform(0.0, 1.0) < 0.5),
        "sigma": uniform(0.1, 2.0),
        "do_flip": uniform(0.0, 1.0) < 0.5,
    }


def _blur_matrix(size: int, sigma, apply, dtype):
    """Banded [m, size, size] Gaussian smoothing matrices, one per clip
    (identity where not applied). Rows renormalize at the borders."""
    i = torch.arange(size, dtype=torch.float32, device=sigma.device)
    d = i[:, None] - i[None, :]
    k = torch.exp(-0.5 * (d / sigma.clamp_min(1e-6)[:, None, None]) ** 2)
    k = torch.where(d.abs() <= BLUR_TAPS // 2, k, 0.0)
    k = k / k.sum(dim=2, keepdim=True)
    ident = torch.eye(size, dtype=torch.float32, device=sigma.device)
    return torch.where(apply[:, None, None], k, ident).to(dtype)


def apply_aug(seq_u8, params: Dict[str, torch.Tensor], dtype=torch.bfloat16,
              normalize_out: bool = True):
    """seq_u8: [B, n, L, S1, S2, 3] uint8 and `draw_aug_params` draws ->
    [B, n, L, S1, S2, 3] `dtype`, in [0, 1] or ImageNet-normalized. The
    result is a view in that layout over memory ordered [B, n, L, 3, S1, S2]
    (the kernel's planar layout), so a caller that wants channels-first
    clips gets them with one copy."""
    b, n, L, s1, s2, c = seq_u8.shape
    m = b * n
    rep = lambda v: v.repeat_interleave(L)
    gray_sel = torch.where(rep(params["do_gray"]), params["ch"], -1)
    # a channels-last view: the kernel reads it in place
    xp = seq_u8.reshape(m * L, s1, s2, c).permute(0, 3, 1, 2)
    x = fused_jitter_normalize(
        xp, rep(params["fb"]), rep(params["fc"]), rep(params["fs"]),
        rep(params["fh"]), gray_sel.to(torch.int32), rep(params["orders"]),
        out_dtype=dtype,
        mean=IMAGENET_MEAN if normalize_out else (0.0, 0.0, 0.0),
        std=IMAGENET_STD if normalize_out else (1.0, 1.0, 1.0))
    x = x.reshape(m, L, c, s1, s2)
    wh = _blur_matrix(s1, params["sigma"], params["do_blur"], dtype)
    ww = _blur_matrix(s2, params["sigma"], params["do_blur"], dtype)
    ww = torch.where(params["do_flip"][:, None, None], ww.flip(1), ww)
    x = torch.einsum("mhk,mlckw->mlchw", wh, x)
    x = torch.einsum("mwk,mlchk->mlchw", ww, x)
    return x.reshape(b, n, L, c, s1, s2).permute(0, 1, 2, 4, 5, 3)


def draw_eval_jitter_params(gen: torch.Generator, m: int, p: float = 0.3,
                            strength=(0.2, 0.2, 0.2, 0.1)
                            ) -> Dict[str, torch.Tensor]:
    """Per-clip RandomApply(p) ColorJitter draws for m clips, on gen's
    device (coclr_tpu/ops/augment.py eval_color_jitter_params, and the
    per-clip draw of coclr_tpu/evalsuite/ncrop.py, which has the same
    distribution): factors fb, fc, fs (1 = identity) and hue shift fh
    (0 = identity) where the clip's jitter applies, and a packed op order."""
    dev = gen.device
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(
        m, generator=gen, device=dev)
    sb, sc, ss, sh = strength
    do = uniform(0.0, 1.0) < p
    one = torch.ones(m, device=dev)
    perms = torch.argsort(torch.rand((m, 4), generator=gen, device=dev), dim=1)
    return {
        "fb": torch.where(do, uniform(max(0.0, 1.0 - sb), 1.0 + sb), one),
        "fc": torch.where(do, uniform(max(0.0, 1.0 - sc), 1.0 + sc), one),
        "fs": torch.where(do, uniform(max(0.0, 1.0 - ss), 1.0 + ss), one),
        "fh": torch.where(do, uniform(-sh, sh), torch.zeros(m, device=dev)),
        "orders": pack_orders(perms),
    }


def apply_eval_jitter(x_u8, params: Dict[str, torch.Tensor],
                      dtype=torch.bfloat16, mean=IMAGENET_MEAN,
                      std=IMAGENET_STD):
    """x_u8: [B, T, S1, S2, 3] uint8 clips and `draw_eval_jitter_params`
    draws for B clips -> [B, T, S1, S2, 3] `dtype`, jittered and normalized
    by one launch of the jitter kernel with gray off on every frame. The
    clips are read in place (channels-last view); the result is a view in
    that layout over memory ordered [B, T, 3, S1, S2]."""
    b, t, s1, s2, c = x_u8.shape
    rep = lambda v: v.repeat_interleave(t)
    gray_off = torch.full((b * t,), -1, dtype=torch.int32, device=x_u8.device)
    y = fused_jitter_normalize(
        x_u8.reshape(b * t, s1, s2, c).permute(0, 3, 1, 2),
        rep(params["fb"]), rep(params["fc"]), rep(params["fs"]),
        rep(params["fh"]), gray_off, rep(params["orders"]), out_dtype=dtype,
        mean=mean, std=std)
    return y.reshape(b, t, c, s1, s2).permute(0, 1, 3, 4, 2)


def normalize(x, mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.bfloat16):
    """(x - mean) / std over the trailing channel axis, in float32, cast to
    `dtype` (T.Normalize; coclr_tpu/ops/augment.py normalize)."""
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x.to(torch.float32) - mean) / std).to(dtype)


def augment_batch(batch, params: Dict[str, torch.Tensor], dtype=torch.bfloat16):
    """Apply `draw_aug_params` draws to a pretrain batch and normalize.

    Single stream: batch['seq']. Two streams: batch['seq_rgb'] and
    batch['seq_flow'] are concatenated along the frame axis into
    [B, 2, 2T, S, S, 3], the reference's doubled seq_len (main_coclr.py), so
    the jitter factors, op order, blur and flip of a clip unit are shared by
    its RGB and flow frames and the gray channel is drawn per frame over 2T
    frames; one jitter launch covers all of them, and the result is split
    again. The flow frames are colour-jittered too, as in the reference.
    Returns the batch without 'aug_base'."""
    out = {k: v for k, v in batch.items() if k != "aug_base"}
    if "seq" in batch:
        out["seq"] = apply_aug(batch["seq"], params, dtype=dtype)
        return out
    t = batch["seq_rgb"].shape[2]
    both = apply_aug(torch.cat([batch["seq_rgb"], batch["seq_flow"]], dim=2),
                     params, dtype=dtype)
    out["seq_rgb"], out["seq_flow"] = both[:, :, :t], both[:, :, t:]
    return out


def chunk_frames(params: Dict[str, torch.Tensor], frames: int, f_idx):
    """Draws made for clip units of `frames` frames, restricted to the local
    frames whose global indices are `f_idx` ([L] on the draws' device): the
    per-frame gray channel is sliced, every other draw is per clip."""
    out = dict(params)
    out["ch"] = params["ch"].view(-1, frames)[:, f_idx].reshape(-1)
    return out


def make_pretrain_preprocess(cfg):
    """preprocess_fn(batch, gen, sp_ctx=None) for the pretrain step: draws
    with `gen`, then augments and normalizes the clips in cfg.dtype
    (augment_batch).

    `sp_ctx = (t_global, offset)`: temporal sequence parallelism, the batch
    holds frames [offset, offset + T_loc) of clips of t_global frames. The
    draws are made for the whole clips, so `gen`'s stream is the unsharded
    one and the members of a data shard, seeded alike, draw alike; the
    per-frame gray channel is then taken at the global index of each local
    frame (chunk_frames). With RGB + flow the local frames [0, T_loc) are
    global frames offset + i of the doubled stream and [T_loc, 2 T_loc)
    are global frames t_global + offset + i: their chunks are not
    contiguous in it (coclr_tpu/ops/augment.py make_pretrain_preprocess)."""
    dtype = cfg.dtype

    def fn(batch, gen: torch.Generator, sp_ctx=None):
        # the draws cover a clip unit: T frames, or 2T for RGB + flow
        two = "seq" not in batch
        t = (batch["seq"] if not two else batch["seq_rgb"]).shape[2]
        if sp_ctx is None:
            return augment_batch(batch, draw_aug_params(
                gen, batch["aug_base"], 2 * t if two else t), dtype)
        t_glob, off = sp_ctx
        idx = off + torch.arange(t, device=batch["aug_base"].device)
        if two:
            idx = torch.cat([idx, t_glob + idx])
        frames = 2 * t_glob if two else t_glob
        params = draw_aug_params(gen, batch["aug_base"], frames)
        return augment_batch(batch, chunk_frames(params, frames, idx), dtype)

    return fn
