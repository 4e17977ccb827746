#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (coclr_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with one card, the CUDA toolkit
(nvcc) and PyTorch built for CUDA. Phases, each of which ends the run with a
non-zero exit on failure:

1. build both CUDA kernels from coclr_tpu_torch/csrc (one nvcc per source,
   in parallel); print the card's name and power limit;
2. kernel 1 (jitter + gray + normalize) against its plain PyTorch version at
   F = 2048 frames of 128 x 128 (the InfoNCE / UberNCE launch), F = 4096
   (the CoCLR launch: RGB and flow frames together) and 2048 of 112 x 112,
   with draws that trigger every op, all 24 op orders, hue and gray, from
   channel-planar frames and from the channels-last view the main path
   passes; the one-pixel path (9 x 9) and frames too large for shared
   memory (288 x 288); and the null path exactly; timed on both layouts;
   edge frames (grey ramps, where delta = 0; black, where maxc = 0;
   white; saturated channels and their pairs; stripes of all) through the
   eval jitter (apply_eval_jitter, gray off) and the pretrain augmentation
   (apply_aug, gray on half the clips), at the same cap;
   then at the classifier train preprocess's launch (F = 1024, gray off, a
   channels-last view of the clips after the uint8 flip), timed;
3. kernel 2 (pool1d_bwd) against its plain version at every launch shape of
   one full-width S3D step and at edge shapes that take every tiling of the
   kernel, in bfloat16 and float32 (post-ReLU zero ties, integer-valued g:
   exact), timed beside the backward of F.max_pool3d and of F.max_pool2d on
   the same inputs; then the same at the two launches of one full-width
   ResNet-2d3d step (its stem pool's H and W axes), exact in both dtypes;
4. InfoNCE: run_pretrain at full width (S3D, seq_len 32, img_dim 128,
   batch 32, moco-k 2048, moco-dim 128, bfloat16) for 12 steps on a
   synthetic two-stream UCF LMDB, with the launch counts of both kernels,
   and the epoch checkpoint read back (on one card the step runs as a
   CUDA graph after its warm-ups: the wrappers count the launches of the
   steps that call them, and each 12-step loop of run_pretrain here on one
   card traces its last TRACED steps with --profile_steps, whose device
   trace must show as many launches a step, replays included);
   then the step on a device-resident
   batch, and a torch.profiler window over 3 such steps, read by the
   package's trace reader (coclr_tpu_torch/utils/profiling.py): each
   kernel's device time and launches in the step, the device's busy share,
   the 10 device ops and the 8 host ops that take most (each later
   profiler window is read the same way);
5. UberNCE: run_pretrain(model='ubernce') at the same width for 6 steps;
   launches per step, and the batch labels in the queue rows written;
6. CoCLR loop: run_pretrain(model='coclr', ucf101-2stream-2clip) at full
   width (topk 5) for 12 steps, initialised from phase 4's checkpoint and a
   second, untrained one as the sampler. With K = 2048 and B = 32 the
   queue-fill gate stays closed: encoder_q's parameters and the sampler
   (parameters and BatchNorm buffers) stay bit-identical to their files,
   queue_label is 1 in the rows written and -1 after; launches per step;
   the epoch checkpoint read back strictly;
7. the eval suite from phase 4's checkpoint, at the reference eval
   recipe's width (S3D, seq_len 32, img_dim 128, batch 32, bfloat16, a
   101-way UCF101 head), through main_classifier's flags:
   - finetune (--train_what ft): 12 loop steps and validation, launches per
     step, the checkpoint read back strictly; the step on a device-resident
     batch, timed and profiled;
   - linear probe (--train_what last): 6 loop steps and validation; the
     backbone stays the checkpoint's bit for bit; the device-resident step;
   - --test --retrieval of the RGB and the flow stream over the train and
     test splits (--max_windows 1), recall@k, extraction clips/s;
   - --test --ten_crop with the probe's checkpoint, and a flow center-crop;
   - feature_linear_probe on the RGB cache, merge_2stream_prob in mode c
     (RGB ten-crop + flow center-crop) and mode s (the two caches);
8. CoCLR step with a full queue on a device-resident batch (sibling masks,
   top-k mining, the self-drop, Adam), timed, and the profiler window;
9. resnet: ResNet-2d3d at the same full width (--net r50, and r3d50):
   the r50 InfoNCE loop for 6 steps with the epoch checkpoint read back
   strictly; the device-resident r50 step (median of 5, profiled: busy
   share, top device ops, each kernel's time in the step, peak memory);
   the device-resident r3d50 step; the r50 CoCLR step with a full queue
   (an r50 sampler); the r50 finetune (3 loop steps, validation, the
   device-resident step); one RGB retrieval pass (2048-wide features).
   Each path launches jitter once and pool1d_bwd twice a step;
10. profile: run_pretrain (S3D InfoNCE, full width) with profile_steps 3:
   the gzipped trace under <exp>/trace read back (device time a step, busy
   share, top 10 ops; jitter once and pool1d_bwd 37 times a step); the
   profile tool (coclr_tpu_torch.tools.profile_step) for infonce, finetune
   and infonce --net r50 at 3 steps, each JSON line printed, its device
   time within 15 % of phase 4's, 7's and 9's window over the same
   program and both kernels in its categories; the port's
   validate_structure on the synthetic RGB and flow LMDBs;
11. ddp: data parallelism through the entry points, in spawned processes
   started as torchrun starts them (RANK, WORLD_SIZE, LOCAL_RANK,
   MASTER_ADDR, MASTER_PORT), each loading the kernels built in phase 1:
   - run_pretrain InfoNCE at full width for 6 steps as the one rank of an
     NCCL group; launches per step, the checkpoint read back strictly;
   - two ranks sharing cuda:0 over gloo (--dist-backend gloo; NCCL refuses
     two ranks on one card): InfoNCE for one epoch (6 steps of 32 clips a
     rank, global 64), InfoNCE steps with the gather and the alltoall key
     shuffle and a CoCLR step with a full queue on device-resident
     batches, and main_classifier --train_what ft for 3 steps and
     validation. After each, encoder_q (the classifier) is bit-identical
     on both ranks (a gathered sha256), queue_ptr is steps x 64 mod 2048,
     the CoCLR rows hold rank 0's names and sampler keys before rank 1's,
     only rank 0 wrote checkpoints (read back strictly), and each rank
     launched jitter once and pool 37 times a step. Per-rank loop and
     device-resident step times, peak memory and the time of one
     shuffle-BN gather and of one alltoall exchange (two processes sharing
     one card over gloo: the distributed logic, not a multi-GPU
     throughput);
12. seqpar: sequence parallelism (--sp_size / --sph_size) through the
   entry points, in two spawned ranks sharing cuda:0 over gloo, each
   loading the kernels built in phase 1 (seqpar_rank):
   (a) main_nce --sp_size 2, InfoNCE at full width (32 clips a data
       shard, each rank a T chunk of 16) for 4 loop steps: both ranks end
       with the same encoder_q and queue, only rank 0 writes the
       checkpoint (read back strictly), each rank launches jitter once
       (F = 1024) and pool1d_bwd 37 times a step;
   (b) the float32 eval-mode S3D encoder (TF32 off) at sp 2 and at sph 2
       within 1e-4 of the same forward unsharded on the 128-d output;
   (c) device-resident steps: S3D InfoNCE at sph 2, r50 InfoNCE at sp 2,
       S3D CoCLR with a full queue at sp 2; per-rank step time and peak
       memory beside the same program unsharded (phases 4, 9 and 8), and
       the time of the largest temporal halo and of one sp_pmean;
   (d) main_classifier --train_what ft --sp_size 2 from phase 4's
       checkpoint, 3 loop steps and validation: both ranks end with the
       same classifier, only rank 0 writes the checkpoint (read back
       strictly), each rank launches jitter once (F = 512) and pool1d_bwd
       37 times a step, and validation counts each clip once;
   (e) the linear probe (--train_what last --sp_size 2), 3 loop steps:
       the backbone stays the checkpoint's bit for bit, no pool launch,
       one jitter launch a step;
   (f) device-resident finetune steps: S3D at sph 2 (H chunk 64), at
       sp 2, at sp 2 x sph 2 (four spawned ranks, seqpar4_rank) and at
       img_dim 224 with sph 2 beside the same step unsharded in this
       process, r50 at sp 2: per-rank step time and peak memory beside
       the unsharded finetune's; the float32 eval-mode classifier at sp 2
       and sph 2 within 1e-4 of the unsharded logits;
   then, in this process, kernel 2 exact (bfloat16 and float32) against
   its plain version at every launch shape of (a), (c) and (f) that no
   earlier path takes, timed (the classifier's sp 2 and sph 2 shapes are
   checked to be pretraining's), and kernel 1 at the sp launch (F =
   1024, gray on) and at the classifier's (F = 512, gray off). The ranks
   time-slice one card: their times are not scaling numbers;
13. drive: the CoCLR recipe through the port's CLIs (python -m
   coclr_tpu_torch.tools.drive_coclr_cycle, in a subprocess) at full S3D
   width (seq_len 32, img_dim 128, batch 32) with moco-k 128, one epoch a
   phase on a learnable synthetic UCF of 224 train and 32 test videos (7
   steps; the queue fills after 4, so CoCLR's steps 5-7 train with the gate
   open): the two InfoNCE inits, FlowMining, RGBMining --reverse and four
   retrievals (--max_windows 1), each CLI a process of its own. Every
   phase exits 0 with progress lines, both CoCLR logs carry Self-acc@1,
   FlowMining's sampler is the flow init's encoder_q bit for bit and its
   encoder_q moved off the RGB init's, RGBMining's sampler is FlowMining's
   encoder_q and its encoder_q moved off the flow init's, all four R@1 lie
   in [0, 1] (encoder_q moves only in a gate-open step: a gated step runs
   the backward and skips the optimizer step), each retrieval's features
   are finite (their health from the drive report is printed: std after
   centering, effective rank, hub share), and each process launched
   the kernels its steps need (COCLR_KERNEL_COUNTS: jitter once a training
   step and pool1d_bwd 37 times, gated or not, bar the replays of the
   step's CUDA graph that the epoch line counts; in retrieval jitter once
   per 32 clips and no pool); its wall time and each process's;
14. one JSON line {"kernels": [...]} with each kernel's launches (per path
   and per step), error against its plain version and times against its
   bound;
15. last line: {"ok": true, "device": {...}}.

Without CUDA, or without the coclr_tpu_torch package beside it, it exits
non-zero and prints no result. Scratch data goes to build/chip_smoke and is
removed at the end.
"""

import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores

# float32 operations per pixel in csrc/jitter.cu, counted from the source
JITTER_OPS = {"load": 3, "brightness": 9, "contrast": 12, "saturation": 18,
              "hue": 58, "gray": 3, "normalize": 6, "mean": 6}

T, S, B, K, DIM = 32, 128, 32, 2048, 128
TRACED = 2  # the last steps of a counted loop that its device trace holds

# (P, N, Q, k, s, lo) beside the main path's shapes, one for each tiling of
# the pool kernel (kernels/pool.py plan): whole planes with 16-byte staging
# at Q = 1, 2k, 4, 8k and odd N; whole planes staged element by element;
# planes above the tile budget, tiled along Q with and without 16-byte
# staging (img_dim 224's MaxPool_2a H pool is 112 x 112); windows other
# than S3D's three, which the kernel reads at run time
POOL_EDGE_SHAPES = [(300, 13, 1, 3, 1, 1), (77, 17, 4, 2, 2, 0),
                    (50, 11, 6, 3, 2, 1), (30, 15, 40, 3, 2, 1),
                    (21, 9, 7, 2, 2, 0), (5, 63, 63, 3, 2, 1),
                    (3, 112, 112, 3, 2, 1), (2, 120, 121, 3, 1, 1),
                    (2, 100, 100, 2, 2, 0), (40, 10, 8, 4, 2, 1),
                    (64, 9, 1, 2, 1, 0)]


def cuda_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_build():
    from coclr_tpu_torch.kernels import build

    t0 = time.time()
    build.build_all()
    print(f"[build] both kernels built in {time.time() - t0:.2f} s "
          f"({', '.join(k.library for k in build.KERNELS.values())})", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def jitter_inputs(frames, size, dev, gen):
    import torch

    u = lambda lo, hi: lo + (hi - lo) * torch.rand(frames, device=dev,
                                                   generator=gen)
    x = torch.randint(0, 256, (frames, 3, size, size), dtype=torch.uint8,
                      device=dev, generator=gen)
    fb, fc, fs, fh = u(0.6, 1.4), u(0.6, 1.4), u(0.6, 1.4), u(-0.1, 0.1)
    fh[::8] = 0.0  # the hue op's exact identity on an eighth of the frames
    gray = torch.randint(-1, 3, (frames,), device=dev, generator=gen,
                         dtype=torch.int32)
    perms = torch.tensor(list(itertools.permutations(range(4))), device=dev)
    perms = perms[torch.arange(frames, device=dev) % 24]
    orders = (perms[:, 0] | perms[:, 1] << 2 | perms[:, 2] << 4
              | perms[:, 3] << 6).to(torch.int32)
    return x, fb, fc, fs, fh, gray, orders


def channels_last(x):
    """The same [F, 3, S1, S2] frames as a view of channels-last memory."""
    return x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def jitter_ops(frames, size, fc, fh, gray, orders):
    """float32 operations the kernel does on these inputs (JITTER_OPS)."""
    o = JITTER_OPS
    per = (o["load"] + o["brightness"] + o["contrast"] + o["saturation"]
           + o["normalize"])
    total = 0
    for c, h, g, code in zip(fc.tolist(), fh.tolist(), gray.tolist(),
                             orders.tolist()):
        ops = per + (o["hue"] if h != 0.0 else 0) + (o["gray"] if g >= 0 else 0)
        if c != 1.0:  # pass 1: the chain before the contrast op, then the mean
            before = 0
            for pos in range(4):
                op = (code >> (2 * pos)) & 3
                if op == 1:
                    break
                before += [o["brightness"], 0, o["saturation"],
                           o["hue"] if h != 0.0 else 0][op]
            ops += o["load"] + before + o["mean"]
        total += ops
    return total * size * size


def jitter_case(frames, size, dev, gen, timed, tag="jitter"):
    """Kernel 1 at F = `frames` of `size` x `size` against its plain version
    (gray on for three frames in four), from planar and channels-last
    frames; with `timed`, its times and bound. Returns the numbers."""
    import torch
    from coclr_tpu_torch.kernels.jitter import (fused_jitter_normalize,
                                                jitter_normalize_plain)

    args = jitter_inputs(frames, size, dev, gen)
    cl = (channels_last(args[0]),) + args[1:]
    got = fused_jitter_normalize(*args).float()
    want = jitter_normalize_plain(*args).float()
    torch.cuda.synchronize()
    # 1 bf16 ULP of the reference value: 2^(floor(log2|v|) - 7)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    diff = (got - want).abs()
    over = float((diff > ulp).float().mean())
    max_err = float(diff.max())
    same = torch.equal(fused_jitter_normalize(*cl).float(), got)
    print(f"[{tag}] F={frames} S={size}: {over:.2e} of outputs more than "
          f"1 bf16 ULP off (cap 1e-3, hue-branch ties), max abs err "
          f"{max_err:.4g}; channels-last input gives the planar result "
          f"bit for bit: {same}", flush=True)
    check(over <= 1e-3, "jitter kernel disagrees with its plain version")
    check(same, "jitter kernel differs between input layouts")
    r = {"max_abs_err": max_err, "over_ulp": over}
    if timed:
        x, fb, fc, fs, fh, gray, orders = args
        r.update(ms_planar=cuda_ms(lambda: fused_jitter_normalize(*args)),
                 ms=cuda_ms(lambda: fused_jitter_normalize(*cl)),
                 plain_ms=cuda_ms(lambda: jitter_normalize_plain(*args),
                                  reps=3, warmup=1))
        nbytes = x.numel() * (1 + 2) + frames * 6 * 4
        ops = jitter_ops(frames, size, fc, fh, gray, orders)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        r.update(bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes=nbytes, ops=ops)
        print(f"[{tag}] F={frames}: kernel {r['ms']:.4f} ms from "
              f"channels-last frames (the main path's), "
              f"{r['ms_planar']:.4f} ms from planar frames; plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {nbytes} B, {ops} f32 ops)", flush=True)
        del x, fb, fc, fs, fh, gray, orders
    del args, cl, got, want, ulp, diff
    torch.cuda.empty_cache()
    return r


# colours whose hue is undefined or at a branch's edge: black (maxc = 0),
# white, and the saturated channels and their pairs
EDGE_COLOURS = ((0, 0, 0), (255, 255, 255), (255, 0, 0), (0, 255, 0),
                (0, 0, 255), (255, 255, 0), (0, 255, 255), (255, 0, 255))


def edge_frames(frames, size, dev):
    """uint8 [frames, size, size, 3]: frames of one edge colour, grey ramps
    (R = G = B at every level, so delta = 0), and frames of all of them in
    stripes, in turn."""
    import torch

    ramp = (torch.arange(size * size, device=dev) % 256).to(torch.uint8)
    ramp = ramp.reshape(size, size, 1).expand(size, size, 3)
    colours = torch.tensor(EDGE_COLOURS, dtype=torch.uint8, device=dev)
    stripes = colours[torch.arange(size, device=dev) % len(EDGE_COLOURS)]
    stripes = stripes[:, None].expand(size, size, 3).clone()
    stripes[::3] = ramp[::3]
    kinds = [c.expand(size, size, 3) for c in colours] + [ramp, stripes]
    return torch.stack([kinds[i % len(kinds)] for i in range(frames)])


def ulp_share(got, want):
    """The share of outputs more than one bfloat16 ULP of the plain value
    off, and the max abs error."""
    import torch

    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    diff = (got - want).abs()
    return float((diff > ulp).float().mean()), float(diff.max())


def jitter_edges(dev, gen):
    """Kernel 1 on edge frames (grey, black, white, saturated channels)
    against its plain version, through the two callers of the port: the
    eval jitter (`apply_eval_jitter`, gray off, every clip jittered) and
    the pretrain augmentation (`apply_aug`, gray on for every other clip;
    its blur and flip off, so that its output is the kernel's)."""
    import torch
    from coclr_tpu_torch.evalsuite.retrieval import EXTRACT_JITTER
    from coclr_tpu_torch.kernels.jitter import jitter_normalize_plain
    from coclr_tpu_torch.ops.augment import (apply_aug, apply_eval_jitter,
                                             draw_aug_params,
                                             draw_eval_jitter_params)

    b, t = B, 8
    frames = edge_frames(b * t, S, dev)
    planar = lambda y: y.reshape(b * t, S, S, 3).permute(0, 3, 1, 2)
    rep = lambda v, n: v.repeat_interleave(n)
    p = draw_eval_jitter_params(gen, b, p=1.0,
                                strength=EXTRACT_JITTER["strength"])
    got = apply_eval_jitter(frames.reshape(b, t, S, S, 3), p)
    want = jitter_normalize_plain(
        planar(frames), rep(p["fb"], t), rep(p["fc"], t), rep(p["fs"], t),
        rep(p["fh"], t), torch.full((b * t,), -1, dtype=torch.int32,
                                    device=dev), rep(p["orders"], t))
    over_eval, err_eval = ulp_share(planar(got).float(), want.float())

    n, L = 2, t // 2
    m = b * n
    a = draw_aug_params(gen, torch.ones(b, n, device=dev), L)
    a["fb"] = torch.where(a["fh"] == 0, 1.3, a["fb"])  # every clip jittered
    a["fh"] = torch.where(a["fh"] == 0, 0.05, a["fh"])
    a["do_gray"] = torch.arange(m, device=dev) % 2 == 0
    a["do_blur"] = torch.zeros(m, dtype=torch.bool, device=dev)
    a["do_flip"] = torch.zeros(m, dtype=torch.bool, device=dev)
    got = apply_aug(frames.reshape(b, n, L, S, S, 3), a)
    gray = torch.where(rep(a["do_gray"], L), a["ch"], -1).to(torch.int32)
    want = jitter_normalize_plain(
        planar(frames), rep(a["fb"], L), rep(a["fc"], L), rep(a["fs"], L),
        rep(a["fh"], L), gray, rep(a["orders"], L))
    over_aug, err_aug = ulp_share(planar(got).float(), want.float())
    print(f"[jitter-edges] {b * t} frames of {S} x {S} (grey ramps, black, "
          f"white, saturated channels, stripes of all): eval jitter "
          f"{over_eval:.2e} of outputs more than 1 bf16 ULP off, max abs err "
          f"{err_eval:.4g}; pretrain augmentation (gray on half the clips) "
          f"{over_aug:.2e}, max abs err {err_aug:.4g} (cap 1e-3)", flush=True)
    check(over_eval <= 1e-3, "jitter kernel disagrees with its plain version "
                             "on edge frames in the eval jitter")
    check(over_aug <= 1e-3, "jitter kernel disagrees with its plain version "
                            "on edge frames in the pretrain augmentation")
    return {"max_abs_err": max(err_eval, err_aug)}


def phase_jitter(dev):
    import torch
    from coclr_tpu_torch.kernels.jitter import fused_jitter_normalize

    gen = torch.Generator(dev).manual_seed(0)
    result = {}
    # F = 2048 is the InfoNCE launch and F = 4096 CoCLR's; 9 x 9 takes the
    # one-pixel path and 288 x 288 (243 KB a frame) reads device memory
    # instead of staging
    for frames, size in ((2048, 128), (4096, 128), (2048, 112), (64, 9),
                         (16, 288)):
        r = jitter_case(frames, size, dev, gen, timed=size == 128)
        if size == 128:
            result[frames] = r

    # the null path (factors 1, fh 0, gray -1, identity normalize): exact
    for size in (128, 9, 288):
        x = torch.randint(0, 256, (8, 3, size, size), dtype=torch.uint8,
                          device=dev, generator=gen)
        one = torch.ones(8, device=dev)
        params = (one, one, one, one * 0, -one.to(torch.int32),
                  torch.full((8,), 228, dtype=torch.int32, device=dev))
        for frames in (x, channels_last(x)):
            got = fused_jitter_normalize(frames, *params, out_dtype=torch.float32,
                                         mean=(0, 0, 0), std=(1, 1, 1))
            check(torch.equal(got, x.float() * (1.0 / 255.0)),
                  f"jitter kernel's null path is not exact at {size} x {size}")
    print("[jitter] null path exact (128, 9 and 288 square; planar and "
          "channels-last)", flush=True)
    result["edges"] = jitter_edges(dev, gen)
    return result


def pool_launch_shapes(dev, net="s3d"):
    """(P, N, Q, k, s, lo) -> launches, for one full-width forward + backward
    of the query encoder's backbone `net`."""
    import torch
    from coclr_tpu_torch.backbones import select_backbone

    net = select_backbone(net, dtype=torch.bfloat16)[0].to(dev).train()
    x = torch.randn(B, 3, T, S, S, device=dev)
    with PoolShapes() as rec:
        net(x).float().sum().backward()
        torch.cuda.synchronize()
    del net, x
    torch.cuda.empty_cache()
    return rec.shapes


def pool_inputs(p, n, q, k, s, lo, dtype, dev, gen):
    """Post-ReLU x (many exact zero ties), its pooled max and an
    integer-valued g: the kernel's sums are exact."""
    import torch
    from coclr_tpu_torch.kernels import pool

    x = torch.relu(torch.randn(p, n, q, device=dev, generator=gen) - 0.5
                   ).to(dtype)
    out = pool.pool1d_fwd(x, 1, k, s, lo)
    g = torch.randint(-4, 5, out.shape, device=dev, generator=gen).to(dtype)
    return x, out, g


def measure_pool(shapes, dev, gen, tag, exact_f32=False):
    """The kernel at each launch shape in `shapes` ({(P, N, Q, k, s, lo):
    launches per step}) in bfloat16, bit for bit against its plain version
    (and in float32 too with `exact_f32`), timed beside the plain version
    and the backward of F.max_pool3d and of F.max_pool2d on the same inputs,
    with its bound; returns the sums over one step and the rows."""
    import torch
    import torch.nn.functional as F
    from coclr_tpu_torch.kernels import pool

    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "pool3d_ms": 0.0,
           "pool2d_ms": 0.0, "max_abs_err": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
           "rows": []}
    pool2d_ok = True
    for (p, n, q, k, s, lo), count in sorted(shapes.items()):
        if exact_f32:
            x, out, g = pool_inputs(p, n, q, k, s, lo, torch.float32, dev, gen)
            check(torch.equal(pool.pool1d_bwd(x, out, g, k, s, lo),
                              pool.pool1d_bwd_plain(x, out, g, k, s, lo)),
                  f"[{tag}] pool1d_bwd kernel differs from its plain version "
                  f"at {(p, n, q, k, s, lo)} in float32")
            del x, out, g
            torch.cuda.empty_cache()
        x, out, g = pool_inputs(p, n, q, k, s, lo, torch.bfloat16, dev, gen)
        got = pool.pool1d_bwd(x, out, g, k, s, lo)
        want = pool.pool1d_bwd_plain(x, out, g, k, s, lo)
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want),
              f"[{tag}] pool1d_bwd kernel differs from its plain version at "
              f"{(p, n, q, k, s, lo)} (max abs err {err})")
        del got, want
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        m = out.shape[1]
        nbytes = (2 * p * n * q + 2 * p * m * q) * x.element_size()
        ms = cuda_ms(lambda: pool.pool1d_bwd(x, out, g, k, s, lo))
        plain = cuda_ms(lambda: pool.pool1d_bwd_plain(x, out, g, k, s, lo),
                        reps=3, warmup=1)
        x5 = x.view(1, p, n, q, 1).requires_grad_(True)
        out5 = F.max_pool3d(x5, (k, 1, 1), (s, 1, 1), (lo, 0, 0))
        lib3 = cuda_ms(lambda: torch.autograd.grad(out5, x5, g.view(out5.shape),
                                                   retain_graph=True))
        del x5, out5
        # the same function as a 2-D pool over the zero-copy [P, 1, N, Q]
        # view (first-max tie routing too); kept only if it runs everywhere
        lib2 = float("nan")
        if pool2d_ok:
            try:
                x4 = x.view(p, 1, n, q).requires_grad_(True)
                out4 = F.max_pool2d(x4, (k, 1), (s, 1), (lo, 0))
                lib2 = cuda_ms(lambda: torch.autograd.grad(
                    out4, x4, g.view(out4.shape), retain_graph=True))
                del x4, out4
            except RuntimeError as e:
                pool2d_ok = False
                print(f"[{tag}] F.max_pool2d backward fails at "
                      f"{(p, n, q, k, s, lo)}, dropped as a yardstick: {e}",
                      flush=True)
        # a compare per window tap, an add per covering window (float32)
        ops = p * m * q * k + p * n * q * -(-k // s)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        for key, val in (("ms", ms), ("plain_ms", plain), ("pool3d_ms", lib3),
                         ("pool2d_ms", lib2), ("bound_ms", max(t_bytes, t_ops)),
                         ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
            tot[key] += count * val
        tot["rows"].append(dict(shape=(p, n, q, k, s, lo), launches=count,
                                ms=ms, plain_ms=plain, pool3d_ms=lib3,
                                pool2d_ms=lib2, bound_ms=max(t_bytes, t_ops),
                                bytes=nbytes))
        print(f"[{tag}] P={p} N={n} Q={q} k={k} s={s} lo={lo} x{count}: exact"
              f"{' (bfloat16 and float32)' if exact_f32 else ''}; kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, max_pool3d backward "
              f"{lib3:.4f} ms, max_pool2d backward {lib2:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms ({nbytes} B; "
              f"{max(t_bytes, t_ops) / ms:.0%} of it)", flush=True)
        del x, out, g
        torch.cuda.empty_cache()
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    libs = {"F.max_pool3d backward": tot["pool3d_ms"]}
    if pool2d_ok:
        libs["F.max_pool2d backward"] = tot["pool2d_ms"]
    tot["library"] = min(libs, key=libs.get)
    tot["library_ms"] = libs[tot["library"]]
    print(f"[{tag}] per step: kernel {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.4f} ms, max_pool3d backward "
          f"{tot['pool3d_ms']:.4f} ms, max_pool2d backward "
          f"{tot['pool2d_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
          f"({tot['bound_ms'] / tot['ms']:.0%} of it); library_ms is "
          f"{tot['library']}", flush=True)
    return tot


def phase_pool(dev):
    import torch
    from coclr_tpu_torch.kernels import pool

    shapes = pool_launch_shapes(dev)
    n_launch = sum(shapes.values())
    print(f"[pool] {n_launch} pool1d_bwd launches per S3D backward over "
          f"{len(shapes)} shapes", flush=True)
    check(n_launch == 37, "expected 37 pool backward launches per step")
    gen = torch.Generator(dev).manual_seed(1)

    # every tiling of the kernel (kernels/pool.py plan), in both dtypes
    for p, n, q, k, s, lo in POOL_EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, out, g = pool_inputs(p, n, q, k, s, lo, dtype, dev, gen)
            check(torch.equal(pool.pool1d_bwd(x, out, g, k, s, lo),
                              pool.pool1d_bwd_plain(x, out, g, k, s, lo)),
                  f"pool1d_bwd kernel differs from its plain version at edge "
                  f"shape {(p, n, q, k, s, lo)} in {dtype}")
    print(f"[pool] {len(POOL_EDGE_SHAPES)} edge shapes exact in bfloat16 and "
          f"float32", flush=True)

    check({(3, 2, 1), (3, 1, 1), (2, 2, 0)} <= {key[3:] for key in shapes},
          "missing an S3D pool configuration")
    tot = measure_pool(shapes, dev, gen, "pool")

    # the ResNet-2d3d stem pool (r50 and r3d50 alike): its H and W launches
    r50 = pool_launch_shapes(dev, "r50")
    stem = B * 64 * (T // 2)  # the stem's [B, 64, T/2, S/2, S/2] output
    check(r50 == {(stem, S // 2, S // 2, 3, 2, 1): 1,
                  (stem * S // 4, S // 2, 1, 3, 2, 1): 1},
          f"unexpected r50 pool launches per step: {r50}")
    print(f"[pool-r50] {sum(r50.values())} pool1d_bwd launches per r50 "
          f"backward: {sorted(r50)}", flush=True)
    tot["r50"] = measure_pool(r50, dev, gen, "pool-r50", exact_f32=True)
    torch.cuda.empty_cache()
    return tot


def make_data(work):
    from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

    t0 = time.time()
    # 8 classes x 12 train groups x 4 clips = 384 train videos = 12 batches;
    # each has an RGB and a flow LMDB entry (the flow one a frame shorter)
    out = make_synthetic_ucf(os.path.join(work, "ucf"), n_classes=8,
                             n_groups=13, n_clips=4, n_frames=34,
                             size=(136, 180), flow=True)
    for tree in ("frame", "flow"):
        shutil.rmtree(os.path.join(work, "ucf", tree))
    meta_root = os.path.join(work, "meta_root")
    os.makedirs(meta_root)
    os.symlink(out["root"], os.path.join(meta_root, "ucf101"))
    data_root = os.path.join(work, "data")
    os.makedirs(os.path.join(data_root, "UCF101"))
    os.symlink(out["db_path"],
               os.path.join(data_root, "UCF101", "ucf101_frame.lmdb"))
    os.symlink(out["db_path_flow"],
               os.path.join(data_root, "UCF101", "ucf101_tvl1_frame.lmdb"))
    os.environ["COCLR_META_ROOT"] = meta_root
    print(f"[data] synthetic two-stream UCF LMDB built in "
          f"{time.time() - t0:.1f} s", flush=True)
    return data_root


def full_width(model, data_root, net="s3d", **kw):
    from coclr_tpu_torch.config import PretrainConfig

    return PretrainConfig(net=net, model=model, seq_len=T, img_dim=S,
                          batch_size=B, moco_k=K, moco_dim=DIM, epochs=1,
                          workers=8, print_freq=1, compute_dtype="bfloat16",
                          data_root=data_root, prefix="smoke", **kw)


def counted(fn, work):
    """fn() run from `work` with the kernels' counts set to 0 just before it
    and read just after; returns (its result, counts, seconds, peak device
    memory)."""
    import torch
    from coclr_tpu_torch.kernels import build

    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = {name: k.launches for name, k in build.KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(cwd)
    return out, counts, sec, peak


def run_counted(cfg, work, steps, trace=True, **kw):
    """run_pretrain through `counted`; returns (model, info, launches per
    step, counts, peak device memory). The launches per step are the
    wrappers' counts over the steps that called them: jitter (the eager
    preprocess) every step, the pool kernel every step but the replays of
    the step's CUDA graph (info["step_graph"]), which launch it from the
    device without its wrapper. With `trace` (a run as long as the epoch,
    which places the window) the run's last TRACED steps, unless cfg traces
    steps of its own, are traced with --profile_steps, and the device
    trace must show each kernel as many times a step as the wrappers
    launched it."""
    import dataclasses

    from coclr_tpu_torch.train.pretrain import run_pretrain
    from coclr_tpu_torch.utils.profiling import read_trace

    if trace and not cfg.profile_steps:
        cfg = dataclasses.replace(cfg, profile_steps=TRACED)
    (model, _, info), counts, _, peak = counted(
        lambda: run_pretrain(cfg, max_steps=steps, device="cuda", **kw), work)
    n = len(info["step_s"])
    check(n == steps, f"{n} steps ran, not {steps}")
    check(math.isfinite(info["loss"]), f"loss is not finite: {info['loss']}")
    modes = info["step_graph"]
    launching = n - modes.count("replay")
    per_step = {"jitter": counts["jitter"] / n,
                "pool1d_bwd": counts["pool1d_bwd"] / launching}
    info["loop_step_s"] = info["step_s"]
    if trace:
        k = cfg.profile_steps
        kernels = read_trace(os.path.join(work, info["trace"]), k)["kernels"]
        seen = {name: kernels.get(name + "_kernel", {}).get(
            "launches_per_step", 0) for name in per_step}
        check(seen == per_step,
              f"launches per step in the device trace of steps "
              f"{n - k}-{n - 1} ({modes[-k:]}): {seen}; the wrappers' "
              f"{per_step} over {launching} steps of {n} ({modes})")
        info["loop_step_s"] = info["step_s"][:-k]
    info["model_path"] = os.path.join(work, info["exp_path"], "model")
    return model, info, per_step, counts, peak


def loop_line(tag, info, peak, clips=2 * B):
    """Prints the loop's median step after 2 warm-up steps, leaving out
    the steps that run_counted traced."""
    step_ms = statistics.median(info.get("loop_step_s",
                                         info["step_s"])[2:]) * 1e3
    graph = ""
    if "step_graph" in info:
        graph = (f" ({info['step_graph'].count('replay')} replays of the "
                 f"step's CUDA graph)")
    print(f"[{tag}] {len(info['step_s'])} steps{graph}, mean loss "
          f"{info['loss']:.4f} (finite); median step {step_ms:.1f} ms after 2 "
          f"warm-up steps = {clips / step_ms * 1e3:.1f} clips/s; peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    return step_ms


def phase_slice(dev, work, data_root):
    import torch
    from coclr_tpu_torch.data import native
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  load_reference_state_dict)

    cfg = full_width("infonce", data_root)
    _, info, per_step, counts, peak = run_counted(cfg, work, 12)
    steps = len(info["step_s"])
    check(per_step == {"jitter": 1, "pool1d_bwd": 37},
          f"unexpected launches per step: {per_step}")
    loop_line("slice", info, peak)
    decode = ("native C++ data plane (LMDB + msgpack), cv2 JPEG decode"
              if native.available() else "pure-Python data plane")
    print(f"[slice] kernel launches in the run: {counts} "
          f"(per step {per_step}); decode: {decode}", flush=True)

    ckpt_path = os.path.join(info["model_path"], "epoch0.pth.tar")
    ckpt = load_checkpoint(ckpt_path)
    back = MoCo("s3d", DIM, K, torch.bfloat16).to(dev)
    load_reference_state_dict(back, ckpt["state_dict"])
    check(ckpt["state_dict"]["queue"].shape == (DIM, K)
          and int(back.queue_ptr) == (steps * B) % K,
          "checkpoint read back wrong")
    print(f"[slice] checkpoint {os.path.relpath(ckpt_path, work)} written and "
          f"read back strictly ({len(ckpt['state_dict'])} tensors)", flush=True)
    del back

    dev_ms, step_kernels, dev_peak, _ = infonce_device_step(dev, cfg, "slice")
    return {"counts": counts, "per_step": per_step, "ckpt": ckpt_path,
            "in_step": step_kernels, "dev_ms": dev_ms, "peak": dev_peak}


def infonce_device_step(dev, cfg, tag, profile=True):
    """The InfoNCE step of cfg.net on a device-resident batch (the step
    without the loader): launches of one step, the median of 5 timed steps,
    peak device memory, and a profiler window over 3 steps."""
    import torch
    from coclr_tpu_torch.kernels import build
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.ops.augment import make_pretrain_preprocess
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step

    model = MoCo(cfg.net, DIM, K, torch.bfloat16).to(dev).train()
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    pre = make_pretrain_preprocess(cfg)
    gen = torch.Generator(dev).manual_seed(0)
    batch = {"seq": torch.randint(0, 256, (B, 2, T, S, S, 3), dtype=torch.uint8,
                                  device=dev, generator=gen),
             "aug_base": torch.randint(0, 2, (B, 2), dtype=torch.uint8,
                                       device=dev, generator=gen)}
    step = lambda: pretrain_step(model, opt, pre(batch, gen), 1e-3, cfg)
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    step()
    counts = {name: k.launches for name, k in build.KERNELS.items()}
    dev_ms = time_steps(step, tag)
    peak = torch.cuda.max_memory_allocated()
    step_kernels = profile_steps(step, 3) if profile else None
    print(f"[{tag}] one device-resident {cfg.net} step: launches {counts}; "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)
    del model, opt, batch
    torch.cuda.empty_cache()
    return dev_ms, step_kernels, peak, counts


def time_steps(step, tag, n=7, warmup=2, clips=2 * B):
    """Median of n - warmup synchronized steps, each checked finite; `clips`
    is the clips one step encodes with gradients."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step()
        check(math.isfinite(float(metrics["loss"])), f"[{tag}] device step loss")
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times[warmup:]) * 1e3
    print(f"[{tag}] device-resident batch: median step {ms:.1f} ms = "
          f"{clips / ms * 1e3:.1f} clips/s (preprocess + step, synchronized)",
          flush=True)
    return ms


class RecordingLoader:
    """The port's Loader, keeping the labels of every batch it yields."""

    def __init__(self, loader):
        self.loader = loader
        self.labels = []

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.labels.append(batch["label"].copy())
            yield batch


def phase_ubernce(dev, work, data_root):
    import numpy as np
    from coclr_tpu_torch.data.loader import Loader
    from coclr_tpu_torch.train.pretrain import build_dataset

    cfg = full_width("ubernce", data_root)
    loader = RecordingLoader(Loader(build_dataset(cfg), batch_size=B,
                                    num_workers=cfg.workers, seed=cfg.seed))
    # 6 steps end before the --profile_steps window of the 12-batch epoch
    model, info, per_step, counts, peak = run_counted(cfg, work, 6,
                                                      trace=False,
                                                      loader=loader)
    check(per_step == {"jitter": 1, "pool1d_bwd": 37},
          f"unexpected UberNCE launches per step: {per_step}")
    labels = np.concatenate(loader.labels[:6])
    got = model.queue_label.cpu().numpy()
    check(np.array_equal(got[:6 * B], labels) and (got[6 * B:] == -1).all()
          and int(model.queue_ptr) == 6 * B,
          "UberNCE queue_label does not hold the batch labels")
    loop_line("ubernce", info, peak)
    print(f"[ubernce] launches {counts} (per step {per_step}); queue_label "
          f"holds the {6 * B} batch labels ({len(set(labels.tolist()))} "
          f"classes), -1 after", flush=True)
    return {"counts": counts, "per_step": per_step}


def phase_coclr(dev, work, data_root, first):
    import torch
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  load_reference_state_dict,
                                                  reference_state_dict,
                                                  save_checkpoint)

    second = os.path.join(work, "sampler.pth.tar")
    save_checkpoint({"epoch": 0, "state_dict": reference_state_dict(
        MoCo("s3d", DIM, K, torch.bfloat16, gen=torch.Generator().manual_seed(1)))},
        filename=second)
    cfg = full_width("coclr", data_root, dataset="ucf101-2stream-2clip",
                     pretrain=(first, second), topk=5)
    steps = 12
    model, info, per_step, counts, peak = run_counted(cfg, work, steps)
    check(per_step == {"jitter": 1, "pool1d_bwd": 37},
          f"unexpected CoCLR launches per gated step: {per_step}")
    step_ms = loop_line("coclr", info, peak)

    files = [load_checkpoint(p)["state_dict"] for p in (first, second)]
    got = {k: v.cpu() for k, v in model.state_dict().items()}
    names = {n for n, _ in model.named_parameters()}
    q_same = all(torch.equal(got[n], files[0][n]) for n in names
                 if n.startswith("encoder_q."))
    s_same = all(torch.equal(v, files[1]["encoder_q." + k[len("sampler."):]])
                 for k, v in got.items() if k.startswith("sampler."))
    rows = steps * B
    label = got["queue_label"]
    check(q_same, "encoder_q moved while the queue-fill gate was closed")
    check(s_same, "the sampler is not its checkpoint's encoder_q bit for bit")
    check(int(got["queue_ptr"]) == rows % K and (label[:rows] == 1).all()
          and (label[rows:] == -1).all(), "CoCLR queue_label / queue_ptr wrong")
    ckpt = load_checkpoint(os.path.join(info["model_path"], "epoch0.pth.tar"))
    back = MoCo("s3d", DIM, K, torch.bfloat16, variant="coclr")
    load_reference_state_dict(back, ckpt["state_dict"])
    check(torch.equal(back.queue_label, label), "CoCLR checkpoint read back wrong")
    print(f"[coclr] launches {counts} (per step {per_step}); gate closed for "
          f"all {steps} steps: encoder_q parameters equal the first "
          f"checkpoint's, the sampler (parameters and BN buffers) the "
          f"second's, bit for bit; queue_ptr {rows % K}, queue_label 1 in "
          f"{rows} rows and -1 after; epoch checkpoint read back strictly "
          f"({len(ckpt['state_dict'])} tensors)", flush=True)
    del model, back
    torch.cuda.empty_cache()
    return {"counts": counts, "per_step": per_step, "step_ms": step_ms,
            "peak": peak}


def phase_coclr_device(dev, net="s3d", expect=None, tag="coclr-open"):
    """The CoCLR step of `net` (its sampler a `net` too) with a full queue on
    a device-resident batch: launches of one step, timed, profiled."""
    import torch
    from coclr_tpu_torch.kernels import build
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.ops.augment import make_pretrain_preprocess
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step

    expect = expect or {"jitter": 1, "pool1d_bwd": 37}
    cfg = full_width("coclr", "", net=net, dataset="ucf101-2stream-2clip",
                     topk=5)
    model = MoCo(net, DIM, K, torch.bfloat16, variant="coclr").to(dev).train()
    gen = torch.Generator(dev).manual_seed(2)
    u8 = lambda: torch.randint(0, 256, (B, 2, T, S, S, 3), dtype=torch.uint8,
                               device=dev, generator=gen)
    batch = {"seq_rgb": u8(), "seq_flow": u8(),
             "aug_base": torch.randint(0, 2, (B, 2), dtype=torch.uint8,
                                       device=dev, generator=gen),
             "vname": torch.randint(0, 100, (B,), dtype=torch.int32,
                                    device=dev, generator=gen)}
    # a full queue whose names share the batch's: siblings and top-k mining
    model.queue_label.fill_(1)
    model.queue_vname.copy_(torch.randint(0, 100, (K,), device=dev,
                                          generator=gen))
    siblings = int((batch["vname"][:, None] == model.queue_vname[None]).sum())
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    pre = make_pretrain_preprocess(cfg)
    before = [p.detach().clone() for p in model.encoder_q.parameters()]
    step = lambda: pretrain_step(model, opt, pre(batch, gen), 1e-3, cfg,
                                 drop_self=True, update=True)
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    metrics = step()
    counts = {name: k.launches for name, k in build.KERNELS.items()}
    check(counts == expect,
          f"[{tag}] unexpected CoCLR launches with the gate open: {counts}")
    check(math.isfinite(float(metrics["loss"]))
          and float(metrics["queue_is_full"]) == 1.0,
          f"[{tag}] CoCLR full-queue step")
    moved = sum(not torch.equal(a, b) for a, b in
                zip(before, model.encoder_q.parameters()))
    check(moved > 0, f"[{tag}] encoder_q did not change with the gate open")
    print(f"[{tag}] one {net} step: launches {counts}, loss "
          f"{float(metrics['loss']):.4f}, {moved} of {len(before)} encoder_q "
          f"tensors changed; {siblings} sibling pairs between batch and queue",
          flush=True)
    dev_ms = time_steps(step, tag)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] peak device memory {peak / 2**30:.2f} GiB", flush=True)
    step_kernels = profile_steps(step, 3)
    del model, opt, batch
    torch.cuda.empty_cache()
    return {"counts": counts, "dev_ms": dev_ms, "in_step": step_kernels,
            "peak": peak}


def phase_resnet(dev, work, data_root):
    """ResNet-2d3d at full width (seq_len 32, img_dim 128, batch 32, moco-k
    2048, moco-dim 128, bfloat16), each path launching jitter once and
    the stem pool's backward twice a step: the r50 InfoNCE loop (6 steps,
    the epoch checkpoint read back strictly), the r50 and r3d50
    device-resident InfoNCE steps (timed; r50 profiled), the r50 CoCLR step
    with a full queue (an r50 sampler), the r50 finetune (3 loop steps,
    validation, the device-resident step) and one RGB retrieval pass
    (2048-wide features). Returns the paths' results."""
    import torch
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  load_reference_state_dict)

    expect = {"jitter": 1, "pool1d_bwd": 2}
    paths = {}
    cfg = full_width("infonce", data_root, net="r50")
    # 6 steps end before the --profile_steps window of the 12-batch epoch;
    # phase_profile traces r50's replays through the profile tool
    _, info, per_step, counts, peak = run_counted(cfg, work, 6, trace=False)
    check(per_step == expect, f"[r50] unexpected launches per step: {per_step}")
    step_ms = loop_line("r50", info, peak)
    ckpt_path = os.path.join(info["model_path"], "epoch0.pth.tar")
    ckpt = load_checkpoint(ckpt_path)
    back = MoCo("r50", DIM, K, torch.bfloat16)
    load_reference_state_dict(back, ckpt["state_dict"])
    check(int(back.queue_ptr) == 6 * B % K
          and ckpt["state_dict"]["encoder_q.2.weight"].shape[:2] == (2048, 2048),
          "[r50] checkpoint read back wrong")
    print(f"[r50] launches {counts} (per step {per_step}); checkpoint "
          f"{os.path.relpath(ckpt_path, work)} read back strictly "
          f"({len(ckpt['state_dict'])} tensors)", flush=True)
    del back, ckpt
    dev_ms, in_step, dev_peak, one = infonce_device_step(dev, cfg, "r50")
    check(one == expect, f"[r50] unexpected launches in one step: {one}")
    paths["r50_infonce"] = dict(counts=counts, per_step=per_step,
                                step_ms=step_ms, loop_peak=peak, dev_ms=dev_ms,
                                in_step=in_step, peak=dev_peak, ckpt=ckpt_path)

    r3d = full_width("infonce", data_root, net="r3d50")
    dev_ms, _, dev_peak, one = infonce_device_step(dev, r3d, "r3d50",
                                                   profile=False)
    check(one == expect, f"[r3d50] unexpected launches in one step: {one}")
    paths["r3d50_infonce"] = dict(counts=one, dev_ms=dev_ms, peak=dev_peak)

    paths["r50_coclr_open"] = phase_coclr_device(dev, "r50", expect,
                                                 "r50-coclr-open")
    paths["r50_finetune"] = phase_finetune(dev, work, data_root, ckpt_path,
                                           net="r50", steps=3, pool_launches=2,
                                           tag="r50-finetune")
    paths["r50_retrieval"] = phase_retrieval(
        work, data_root, ckpt_path, "ucf101", "feature_r50", net="r50",
        width=2048)
    return paths


NUM_CLASS = 101  # UCF101's head, at the eval recipe's full width


def eval_argv(data_root, *extra):
    """main_classifier flags at the reference eval recipe's width."""
    return ["--net", "s3d", "--dataset", "ucf101", "--seq_len", str(T),
            "--img_dim", str(S), "--batch_size", str(B), "--compute_dtype",
            "bfloat16", "--workers", "8", "--data_root", data_root,
            "--prefix", "smoke", "--print_freq", "1", *extra]


def run_classifier(work, data_root, train_what, steps, pretrain, *extra):
    """main_classifier's config (eval_argv and `extra` flags) and
    run_classifier_train for `steps` steps (and validation), counted;
    returns (model, info, counts per step, counts, peak)."""
    from coclr_tpu_torch import main_classifier
    from coclr_tpu_torch.evalsuite.driver import run_classifier_train

    cfg = main_classifier.cfg_from_args(main_classifier.parse_args(eval_argv(
        data_root, "--train_what", train_what, "--epochs", "1", "--pretrain",
        pretrain, *extra)))
    (model, _, info), counts, _, peak = counted(
        lambda: run_classifier_train(cfg, max_steps=steps, device="cuda"), work)
    n = len(info["step_s"])
    check(n == steps, f"{n} classifier steps ran, not {steps}")
    check(math.isfinite(info["loss"]) and math.isfinite(info["val"]["loss"]),
          f"classifier loss is not finite: {info['loss']}, {info['val']}")
    info["ckpt"] = os.path.join(work, info["exp_path"], "model", "epoch0.pth.tar")
    check(os.path.isfile(info["ckpt"]), "no classifier checkpoint written")
    return model, cfg, info, {k: c / n for k, c in counts.items()}, counts, peak


def classifier_device_step(dev, cfg, pretrain, tag, expect):
    """The classifier step on a device-resident batch: launches of one step,
    its time and a profiler window."""
    import torch
    from coclr_tpu_torch.evalsuite import driver, steps
    from coclr_tpu_torch.kernels import build

    model = driver.load_pretrained_backbone(driver.build_model(cfg), pretrain)
    model.to(dev)
    opt = steps.make_classifier_optimizer(cfg, model)
    gen = torch.Generator(dev).manual_seed(3)
    seq = torch.randint(0, 256, (B, T, S, S, 3), dtype=torch.uint8, device=dev,
                        generator=gen)
    label = torch.randint(0, NUM_CLASS, (B,), device=dev, generator=gen)
    step = lambda: steps.train_step(
        model, opt, steps.preprocess_train(seq, gen, cfg.dtype), label, 1e-3,
        drop_gen=gen)
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    step()
    counts = {name: k.launches for name, k in build.KERNELS.items()}
    check(counts == expect, f"[{tag}] unexpected launches in one step: {counts}")
    dev_ms = time_steps(step, tag, clips=B)
    peak = torch.cuda.max_memory_allocated()
    in_step = profile_steps(step, 3, expect=[k for k, v in expect.items() if v])
    print(f"[{tag}] one device-resident step: launches {counts}; peak device "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    del model, opt, seq
    torch.cuda.empty_cache()
    return {"dev_ms": dev_ms, "in_step": in_step, "peak": peak}


def phase_finetune(dev, work, data_root, pretrain, net="s3d", steps=12,
                   pool_launches=37, tag="finetune"):
    """`--train_what ft` of `net` from the InfoNCE checkpoint: `steps` loop
    steps and validation, then the device-resident step."""
    from coclr_tpu_torch.evalsuite import driver
    from coclr_tpu_torch.utils.checkpoint import load_checkpoint

    expect = {"jitter": 1, "pool1d_bwd": pool_launches}
    model, cfg, info, per_step, counts, peak = run_classifier(
        work, data_root, "ft", steps, pretrain, "--net", net)
    check(per_step == expect,
          f"[{tag}] unexpected finetune launches per step: {per_step}")
    step_ms = loop_line(tag, info, peak, clips=B)
    back = driver.build_model(cfg)
    back.load_state_dict(load_checkpoint(info["ckpt"])["state_dict"])
    print(f"[{tag}] launches {counts} (per step {per_step}); validation "
          f"loss {info['val']['loss']:.4f}, top-1 {info['val']['top1']:.4f}; "
          f"checkpoint read back strictly", flush=True)
    del model, back
    dev = classifier_device_step(dev, cfg, pretrain, tag, expect)
    return dict(dev, counts=counts, per_step=per_step, step_ms=step_ms,
                loop_peak=peak)


def phase_probe(dev, work, data_root, pretrain):
    """`--train_what last`: 6 loop steps and validation; no backward runs
    through the backbone, which stays its checkpoint's bit for bit."""
    import torch
    from coclr_tpu_torch.utils.checkpoint import load_checkpoint

    model, cfg, info, per_step, counts, peak = run_classifier(
        work, data_root, "last", 6, pretrain)
    check(per_step == {"jitter": 1, "pool1d_bwd": 0},
          f"unexpected linear-probe launches per step: {per_step}")
    step_ms = loop_line("probe", info, peak, clips=B)
    file = {k[len("encoder_q.0."):]: v for k, v in
            load_checkpoint(pretrain)["state_dict"].items()
            if k.startswith("encoder_q.0.")}
    got = model.backbone.state_dict()
    check(got.keys() == file.keys()
          and all(torch.equal(v.cpu(), file[k]) for k, v in got.items()),
          "the linear probe's backbone is not its checkpoint's bit for bit")
    check(not torch.equal(model.final_bn.running_var.cpu(),
                          torch.ones(model.final_bn.num_features)),
          "final_bn did not train")
    print(f"[probe] launches {counts} (per step {per_step}); the backbone "
          f"({len(got)} tensors, BN buffers included) equals the checkpoint's "
          f"encoder_q.0 bit for bit; validation loss {info['val']['loss']:.4f}",
          flush=True)
    del model
    dev = classifier_device_step(dev, cfg, pretrain, "probe",
                                 {"jitter": 1, "pool1d_bwd": 0})
    return dict(dev, counts=counts, per_step=per_step, step_ms=step_ms,
                loop_peak=peak, ckpt=info["ckpt"])


def phase_retrieval(work, data_root, pretrain, dataset, dirname, net="s3d",
                    width=1024):
    """`--test <pretrain> --retrieval` of `net` over the train and test
    splits, one window a video (--max_windows 1), counted and timed; the
    cached features are `width` wide."""
    from coclr_tpu_torch import main_classifier
    from coclr_tpu_torch.evalsuite.retrieval import CLIP_BATCH, load_feature_cache

    argv = eval_argv(data_root, "--dataset", dataset, "--test", pretrain,
                     "--retrieval", "--max_windows", "1", "--dirname", dirname,
                     "--net", net)
    recall, counts, sec, peak = counted(lambda: main_classifier.main(argv),
                                        work)
    cache = os.path.join(os.path.dirname(pretrain), dirname)
    caches = {split: load_feature_cache(cache, dataset, split)
              for split in ("train", "test")}
    n = {split: len(c[1]) for split, c in caches.items()}
    check(all(c[0].shape == (n[split], width) for split, c in caches.items()),
          f"retrieval features are not {width} wide")
    batches = sum(-(-v // CLIP_BATCH) for v in n.values())
    check(counts == {"jitter": batches, "pool1d_bwd": 0},
          f"unexpected retrieval launches {counts} for {n} videos")
    check(set(recall) == {1, 5, 10, 20, 50}
          and all(0.0 <= r <= 1.0 for r in recall.values()), "recall")
    clips = sum(n.values())
    print(f"[retrieval {dataset} {net}] {clips} clips ({n}) in {sec:.2f} s = "
          f"{clips / sec:.1f} clips/s (decode, jitter, {net} forward, "
          f"{width}-wide cache write, recall); launches {counts}; peak device "
          f"memory "
          f"{peak / 2**30:.2f} GiB; recall@k "
          f"{ {k: round(v, 4) for k, v in recall.items()} }", flush=True)
    return {"counts": counts, "clips_per_s": clips / sec, "cache": cache,
            "recall": recall}


def phase_ncrop(work, data_root, ckpt, dataset, mode):
    """`--test <classifier> --ten_crop` (or --center_crop) over the test
    split, one window a video, counted."""
    from coclr_tpu_torch import main_classifier

    argv = eval_argv(data_root, "--dataset", dataset, "--train_what", "last",
                     "--test", ckpt, f"--{mode}_crop", "--max_windows", "1")
    res, counts, sec, _ = counted(lambda: main_classifier.main(argv), work)
    configs = {"ten": 10, "center": 1}[mode]
    check(counts["pool1d_bwd"] == 0 and counts["jitter"] == configs,
          f"unexpected N-crop launches {counts}")
    check(set(res) == ({"center", "five", "ten"} if mode == "ten" else {mode}),
          f"N-crop results {res}")
    path = f"{ckpt}-prob-{mode}.json"
    check(os.path.isfile(path), f"no {path}")
    print(f"[ncrop {dataset}] {mode}-crop test in {sec:.2f} s: launches "
          f"{counts}; (top-1, top-5) {res}", flush=True)
    return {"counts": counts, "json": path}


def phase_fusion(work, pretrain, rgb_json, flow_json, rgb_cache, flow_cache):
    """The feature-cache probe, then both merge modes."""
    from coclr_tpu_torch import feature_linear_probe, merge_2stream_prob

    (best, epoch), counts, sec, _ = counted(lambda: feature_linear_probe.main(
        ["--test", pretrain, "--dirname", os.path.basename(rgb_cache),
         "--epochs", "10", "--eval_freq", "1", "--lr", "0.1", "--final_bn"]),
        work)
    lp = os.path.join(rgb_cache, os.path.basename(pretrain)
                      + "-lp-ucf101-prob.json")
    check(os.path.isfile(lp) and 0.0 <= best <= 1.0, "feature probe")
    class_ind = os.path.join(os.environ["COCLR_META_ROOT"], "ucf101",
                             "ClassInd.txt")
    accs = merge_2stream_prob.main(["--mode", "c", "--prob1", rgb_json,
                                    "--prob2", flow_json, "--class_ind",
                                    class_ind])
    sim = merge_2stream_prob.main(["--mode", "s", "--prob1", rgb_cache,
                                   "--prob2", flow_cache])
    check(all(0.0 <= a <= 1.0 for a in accs) and set(sim) == {1, 5, 10, 20, 50},
          "merge")
    print(f"[fusion] feature probe best top-1 {best:.4f} at epoch {epoch} "
          f"({sec:.2f} s, on the card); merge c (RGB ten-crop + flow "
          f"center-crop) {accs}; merge s recall@k "
          f"{ {k: round(v, 4) for k, v in sim.items()} }", flush=True)


def phase_jitter_eval(dev, t=T, tag="jitter-eval"):
    """Kernel 1 at the classifier train preprocess's launch: F = 32 x t
    frames of 128 x 128 (t = 32; 16 for a T chunk at --sp_size 2), gray
    off, a channels-last view of the clips after the uint8 flip, with the
    eval draws (p 0.3) and with every clip's jitter on."""
    import torch
    from coclr_tpu_torch.evalsuite import steps
    from coclr_tpu_torch.kernels.jitter import (fused_jitter_normalize,
                                                jitter_normalize_plain)

    gen = torch.Generator(dev).manual_seed(5)
    seq = torch.randint(0, 256, (B, t, S, S, 3), dtype=torch.uint8, device=dev,
                        generator=gen)
    result = {}
    for p in (1.0, steps.TRAIN_JITTER["p"]):
        d = steps.draw_train_preprocess(gen, B)
        d.update(steps.draw_eval_jitter_params(
            gen, B, p=p, strength=steps.TRAIN_JITTER["strength"]))
        flipped = torch.where(d["do_flip"][:, None, None, None, None],
                              seq.flip(3), seq)
        rep = lambda v: v.repeat_interleave(t)
        frames = flipped.reshape(B * t, S, S, 3).permute(0, 3, 1, 2)
        gray = torch.full((B * t,), -1, dtype=torch.int32, device=dev)
        args = (frames, rep(d["fb"]), rep(d["fc"]), rep(d["fs"]), rep(d["fh"]),
                gray, rep(d["orders"]))
        got = fused_jitter_normalize(*args).float()
        want = jitter_normalize_plain(*args).float()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
        diff = (got - want).abs()
        over = float((diff > ulp).float().mean())
        on = int((d["fb"] != 1.0).sum())
        check(over <= 1e-3, "jitter kernel disagrees with its plain version at "
                            "the eval shape")
        check(torch.equal(steps.apply_train_preprocess(seq, d).reshape(
            B * t, S, S, 3).permute(0, 3, 1, 2).float(), got),
              "apply_train_preprocess is not the kernel on the flipped clips")
        print(f"[{tag}] F={B * t} S={S}, gray off, p={p} ({on} of {B} "
              f"clips jittered): {over:.2e} of outputs more than 1 bf16 ULP off "
              f"(cap 1e-3), max abs err {float(diff.max()):.4g}", flush=True)
        result = {"max_abs_err": max(result.get("max_abs_err", 0.0),
                                     float(diff.max()))}
    # timed with the main path's draws (the last ones, p 0.3)
    nbytes = frames.numel() * (1 + 2) + B * t * 6 * 4
    ops = jitter_ops(B * t, S, args[2], args[4], gray, args[6])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    result.update(ms=cuda_ms(lambda: fused_jitter_normalize(*args)),
                  plain_ms=cuda_ms(lambda: jitter_normalize_plain(*args),
                                   reps=3, warmup=1),
                  bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations",
                  bytes=nbytes, ops=ops)
    print(f"[{tag}] kernel {result['ms']:.4f} ms, plain "
          f"{result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms "
          f"({result['bound_by']}: {nbytes} B, {ops} f32 ops)", flush=True)
    torch.cuda.empty_cache()
    return result


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_on_all_ranks(tensors, world):
    """True when the bytes of `tensors` are equal on every rank (a sha256
    on each rank, gathered over the host group)."""
    import hashlib

    import torch
    import torch.distributed as tdist

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    digests = [None] * world.size
    tdist.all_gather_object(digests, h.hexdigest(), group=world.host_group)
    return len(set(digests)) == 1


def ddp_rank(rank, world_size, backend, port, out, data_root, pretrained):
    """One rank of the ddp phase, in a process of its own on cuda:0, started
    the way torchrun starts it (RANK, WORLD_SIZE, LOCAL_RANK 0, MASTER_ADDR,
    MASTER_PORT): InfoNCE through run_pretrain at full width for one epoch
    of 6 steps; with 2 ranks also the shuffle-BN gather and the alltoall
    shard exchange timed, the device-resident InfoNCE step with each
    shuffle timed, a CoCLR step with a full queue and main_classifier
    --train_what ft for 3 steps and validation. Writes its
    results to out/rank<rank>-of-<world_size>.json; a failed check raises."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch
    import torch.distributed as tdist
    from coclr_tpu_torch import main_classifier
    from coclr_tpu_torch.evalsuite.driver import run_classifier_train
    from coclr_tpu_torch.kernels import build
    from coclr_tpu_torch.models.moco import (MoCo, draw_shuffle,
                                             draw_shuffle_alltoall, l2_normalize)
    from coclr_tpu_torch.ops.augment import make_pretrain_preprocess
    from coclr_tpu_torch.parallel import dist
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step
    from coclr_tpu_torch.train.pretrain import run_pretrain

    dev = torch.device("cuda", 0)
    tag = f"{world_size}-rank {backend}, rank {rank}"
    work = os.path.join(out, f"w{world_size}-rank{rank}")
    os.makedirs(work)
    res = {"rank": rank}

    cfg = full_width("infonce", data_root, dist_backend=backend)
    model, info, per_step, counts, peak = run_counted(cfg, work, 6,
                                                      trace=False)
    world = dist.maybe_initialize(dev, backend)
    check(world is not None and world.size == world_size
          and tdist.get_backend() == backend,
          f"[ddp {tag}] the process group is not {world_size} x {backend}")
    check(per_step == {"jitter": 1, "pool1d_bwd": 37},
          f"[ddp {tag}] unexpected launches per step: {per_step}")
    rows = 6 * B * world_size
    check(int(model.queue_ptr) == rows % K, f"[ddp {tag}] queue_ptr")
    check(same_on_all_ranks(list(model.encoder_q.parameters()) + [model.queue],
                            world),
          f"[ddp {tag}] encoder_q or the queue differs between ranks")
    res["infonce"] = dict(counts=counts, per_step=per_step, peak=peak,
                          step_ms=statistics.median(info["step_s"][2:]) * 1e3,
                          ckpt=os.path.join(info["model_path"],
                                            "epoch0.pth.tar"))
    print(f"[ddp {tag}] InfoNCE loop: {len(info['step_s'])} steps of "
          f"{B} clips a rank ({B * world_size} global), launches {counts}, "
          f"median step {res['infonce']['step_ms']:.1f} ms after 2 warm-up, "
          f"peak device memory {peak / 2**30:.2f} GiB; encoder_q and the "
          f"queue equal on every rank, queue_ptr {rows % K}", force=True,
          flush=True)
    del model
    torch.cuda.empty_cache()

    if world_size > 1:
        # one shuffle-BN gather: this rank's key clips [B, 3, T, S, S] bf16
        x = torch.randn(B, 3, T, S, S, device=dev).to(torch.bfloat16)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.gather_rows(x, world.group)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res["gather_ms"] = statistics.median(times[1:]) * 1e3
        res["gather_bytes"] = x.numel() * x.element_size()
        # one alltoall shard exchange of the same clips (--bn_shuffle
        # alltoall): each rank keeps 1 / n of its rows and sends the rest
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_to_all_rows(x, world.group)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res["alltoall_ms"] = statistics.median(times[1:]) * 1e3
        del x

        # InfoNCE (gather and alltoall shuffles) and CoCLR (full queue)
        # steps on device-resident batches
        gen = torch.Generator(dev).manual_seed(10 + rank)
        perms = {"gather": draw_shuffle(torch.Generator().manual_seed(0),
                                        B * world.size),
                 "alltoall": draw_shuffle_alltoall(
                     torch.Generator().manual_seed(rank), B)}
        u8 = lambda: torch.randint(0, 256, (B, 2, T, S, S, 3), dtype=torch.uint8,
                                   device=dev, generator=gen)
        aug = lambda: torch.randint(0, 2, (B, 2), dtype=torch.uint8, device=dev,
                                    generator=gen)
        for variant, shuffle in (("infonce", "gather"), ("infonce", "alltoall"),
                                 ("coclr", "gather")):
            name = variant if shuffle == "gather" else f"{variant}_{shuffle}"
            perm = perms[shuffle]
            cfg = full_width(variant, "", dataset="ucf101-2stream-2clip",
                             topk=5, bn_shuffle=shuffle)
            model = MoCo("s3d", DIM, K, torch.bfloat16,
                         variant=variant).to(dev).train()
            batch = {"seq": u8(), "aug_base": aug()}
            if variant == "coclr":
                names = torch.Generator(dev).manual_seed(2)
                model.queue_label.fill_(1)
                model.queue_vname.copy_(torch.randint(0, 100, (K,), device=dev,
                                                      generator=names))
                batch = {"seq_rgb": u8(), "seq_flow": u8(), "aug_base": aug(),
                         "vname": torch.randint(0, 100, (B,), dtype=torch.int32,
                                                device=dev, generator=gen)}
            opt = make_optimizer(cfg, model.encoder_q.parameters())
            ddp = dist.wrap(model.encoder_q, world)
            pre = make_pretrain_preprocess(cfg)

            def step():
                return pretrain_step(model, opt, pre(batch, gen), 1e-3, cfg,
                                     ddp=ddp, perm=perm)

            torch.cuda.reset_peak_memory_stats()
            build.reset_counts()
            if variant == "coclr":
                augmented = pre(batch, gen)
                with torch.no_grad():
                    kf = l2_normalize(model.sampler(
                        augmented["seq_flow"][:, 1].permute(0, 4, 1, 2, 3)
                        .contiguous()).float())
                metrics = pretrain_step(model, opt, augmented, 1e-3, cfg,
                                        ddp=ddp, perm=perm)
            else:
                metrics = step()
            one = {k: kern.launches for k, kern in build.KERNELS.items()}
            check(one == {"jitter": 1, "pool1d_bwd": 37},
                  f"[ddp {tag}] {name} step launches {one}")
            check(math.isfinite(float(metrics["loss"])),
                  f"[ddp {tag}] {name} step loss")
            check(same_on_all_ranks(list(model.encoder_q.parameters())
                                    + [model.queue], world),
                  f"[ddp {tag}] encoder_q or the queue differs between ranks "
                  f"after the {name} step")
            if shuffle == "alltoall":
                res[name] = dict(counts=one)
            if variant == "coclr":
                check(float(metrics["queue_is_full"]) == 1.0,
                      f"[ddp {tag}] the CoCLR gate is not open")
                vnames = dist.gather_rows(batch["vname"], world.group)
                keys = dist.gather_rows(kf, world.group)
                rows = B * world.size
                check(torch.equal(model.queue_vname[:rows].int(), vnames)
                      and int(model.queue_ptr) == rows,
                      f"[ddp {tag}] queue_vname rows are not in rank order")
                err = float((model.queue_second[:rows] - keys).abs().max())
                check(err <= 2e-2, f"[ddp {tag}] queue_second rows are not the "
                                   f"sampler keys in rank order ({err})")
                res["coclr_open"] = dict(counts=one, key_err=err)
            ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(step()["loss"])
                ms.append((time.perf_counter() - t0) * 1e3)
            res[f"{name}_dev_ms"] = statistics.median(ms[1:])
            res[f"{name}_dev_peak"] = torch.cuda.max_memory_allocated()
            print(f"[ddp {tag}] {variant} step ({shuffle} shuffle) on a "
                  f"device-resident batch: launches {one}, loss "
                  f"{float(metrics['loss']):.4f}, median "
                  f"{res[f'{name}_dev_ms']:.1f} ms, peak "
                  f"{res[f'{name}_dev_peak'] / 2**30:.2f} GiB; encoder_q and "
                  f"the queue equal on every rank", force=True, flush=True)
            del model, opt, ddp, batch
            torch.cuda.empty_cache()

        # main_classifier --train_what ft: 3 steps and validation
        ccfg = main_classifier.cfg_from_args(main_classifier.parse_args(
            eval_argv(data_root, "--train_what", "ft", "--epochs", "1",
                      "--pretrain", pretrained, "--dist-backend", backend)))
        (cmodel, _, cinfo), ccounts, _, cpeak = counted(
            lambda: run_classifier_train(ccfg, max_steps=3, device="cuda"),
            work)
        n = len(cinfo["step_s"])
        cper = {k: c / n for k, c in ccounts.items()}
        check(n == 3 and cper == {"jitter": 1, "pool1d_bwd": 37},
              f"[ddp {tag}] finetune: {n} steps, launches {ccounts}")
        check(math.isfinite(cinfo["loss"]) and math.isfinite(cinfo["val"]["loss"]),
              f"[ddp {tag}] finetune loss")
        check(same_on_all_ranks(list(cmodel.parameters()), world),
              f"[ddp {tag}] the classifier differs between ranks")
        res["finetune"] = dict(counts=ccounts, per_step=cper, peak=cpeak,
                               val=cinfo["val"],
                               step_ms=statistics.median(cinfo["step_s"][1:]) * 1e3)
        print(f"[ddp {tag}] finetune: 3 steps of {B} clips a rank, launches "
              f"{ccounts}, validation {cinfo['val']}, peak "
              f"{cpeak / 2**30:.2f} GiB; the classifier equal on every rank",
              force=True, flush=True)
    with open(os.path.join(out, f"rank{rank}-of-{world_size}.json"), "w") as f:
        json.dump(res, f)
    tdist.barrier(group=world.host_group)
    tdist.destroy_process_group()


def phase_ddp(work, data_root, pretrained, card):
    """Data parallelism through the entry points, in spawned processes that
    load the kernels built in phase 1: (a) run_pretrain InfoNCE as the one
    rank of an NCCL group (torchrun --nproc_per_node 1); (b) two ranks that
    share cuda:0 over gloo (--dist-backend gloo; NCCL refuses two ranks on
    one card): InfoNCE for one epoch (global batch 64), a CoCLR step with
    a full queue, and the finetune with validation. Only rank 0 writes
    checkpoints. Two processes sharing one card measure the distributed
    logic, not multi-GPU throughput."""
    import torch
    import torch.multiprocessing as tmp
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  load_reference_state_dict)

    out = os.path.join(work, "ddp")
    os.makedirs(out)
    torch.cuda.empty_cache()
    paths = {}
    for world_size, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.time()
        tmp.spawn(ddp_rank, args=(world_size, backend, free_port(), out,
                                  data_root, pretrained), nprocs=world_size)
        ranks = []
        for r in range(world_size):
            with open(os.path.join(out, f"rank{r}-of-{world_size}.json")) as f:
                ranks.append(json.load(f))
        wrote = [sorted(glob_ckpts(os.path.join(out, f"w{world_size}-rank{r}")))
                 for r in range(world_size)]
        check(wrote[0] and not any(wrote[1:]),
              f"[ddp] checkpoints not written by rank 0 alone: {wrote}")
        back = MoCo("s3d", DIM, K, torch.bfloat16)
        ckpt = load_checkpoint(ranks[0]["infonce"]["ckpt"])
        load_reference_state_dict(back, ckpt["state_dict"])
        check(int(back.queue_ptr) == 6 * B * world_size % K,
              "[ddp] checkpoint read back wrong")
        name = f"ddp_{backend}_{world_size}rank"
        add = lambda key: {k: sum(r[key]["counts"][k] for r in ranks)
                           for k in ("jitter", "pool1d_bwd")}
        paths[name] = {"counts": add("infonce"),
                       "per_step": ranks[0]["infonce"]["per_step"]}
        print(f"[ddp] {world_size} x {backend} on {card}: "
              f"{time.time() - t0:.1f} s; "
              f"launches {paths[name]['counts']} (per rank and step "
              f"{paths[name]['per_step']}); checkpoints {wrote[0]} from rank 0 "
              f"only, read back strictly; per-rank InfoNCE loop step "
              f"{[round(r['infonce']['step_ms'], 1) for r in ranks]} ms, peak "
              f"{[round(r['infonce']['peak'] / 2**30, 2) for r in ranks]} GiB",
              flush=True)
        if world_size > 1:
            paths["ddp_gloo_2rank_coclr_open"] = {
                "counts": add("coclr_open"),
                "per_step": ranks[0]["coclr_open"]["counts"]}
            paths["ddp_gloo_2rank_finetune"] = {
                "counts": add("finetune"),
                "per_step": ranks[0]["finetune"]["per_step"]}
            paths["ddp_gloo_2rank_alltoall"] = {
                "counts": add("infonce_alltoall"),
                "per_step": ranks[0]["infonce_alltoall"]["counts"]}
            g = ranks[0]["gather_bytes"]
            print(f"[ddp] 2 ranks sharing one card ({card}) over gloo (not a "
                  f"multi-GPU throughput): one shuffle-BN gather of {g} B a rank "
                  f"{[round(r['gather_ms'], 2) for r in ranks]} ms, one "
                  f"alltoall exchange of the same clips (half of them sent) "
                  f"{[round(r['alltoall_ms'], 2) for r in ranks]} ms; "
                  f"device-resident steps per rank: InfoNCE "
                  f"{[round(r['infonce_dev_ms'], 1) for r in ranks]} ms "
                  f"(peak {[round(r['infonce_dev_peak'] / 2**30, 2) for r in ranks]}"
                  f" GiB), InfoNCE with the alltoall shuffle "
                  f"{[round(r['infonce_alltoall_dev_ms'], 1) for r in ranks]} "
                  f"ms, CoCLR full queue "
                  f"{[round(r['coclr_dev_ms'], 1) for r in ranks]} ms; "
                  f"finetune loop step "
                  f"{[round(r['finetune']['step_ms'], 1) for r in ranks]} ms",
                  flush=True)
            paths["ddp_gloo_2rank"]["ranks"] = ranks
    return paths


SP_RANKS = 2  # the seqpar phase's ranks, sharing cuda:0 over gloo
SP_LOOP = 4   # main_nce --sp_size 2's loop steps there


def conditioned_(backbone, seed=0):
    """Well-conditioned random backbone weights in place (He-scaled convs,
    perturbed BatchNorm affine and running statistics), so that an
    eval-mode output is O(1) and a float32 comparison of it means
    something."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in backbone.modules():
            if isinstance(mod, torch.nn.Conv3d):
                mod.weight.normal_(0.0, (2.0 / mod.weight[0].numel()) ** 0.5,
                                   generator=g)
            elif isinstance(mod, torch.nn.BatchNorm3d):
                mod.weight.uniform_(0.8, 1.2, generator=g)
                mod.bias.uniform_(-0.1, 0.1, generator=g)
                mod.running_mean.uniform_(-0.1, 0.1, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
    return backbone


class PoolShapes:
    """Inside the block, each pool1d_bwd call's (P, N, Q, k, s, lo) is
    counted in `shapes`."""

    def __init__(self):
        self.shapes = {}

    def __enter__(self):
        from coclr_tpu_torch.kernels import pool

        self.original = pool.pool1d_bwd

        def record(x, out, g, k, s, lo):
            key = tuple(x.shape) + (k, s, lo)
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return self.original(x, out, g, k, s, lo)

        pool.pool1d_bwd = record
        return self

    def __exit__(self, *exc):
        from coclr_tpu_torch.kernels import pool

        pool.pool1d_bwd = self.original
        return False


class JitterFrames:
    """Inside the block, the frame count F of each jitter kernel call made
    through ops/augment.py (every training path's) is kept in `frames`."""

    def __enter__(self):
        from coclr_tpu_torch.ops import augment

        self.frames = []
        self.original = augment.fused_jitter_normalize

        def record(x, *args, **kw):
            self.frames.append(int(x.shape[0]))
            return self.original(x, *args, **kw)

        augment.fused_jitter_normalize = record
        return self

    def __exit__(self, *exc):
        from coclr_tpu_torch.ops import augment

        augment.fused_jitter_normalize = self.original
        return False


def classifier_sp_step(dev, w, net, img, tag, pool_launches):
    """The finetune step (`net`, a 101-way head, bfloat16, Adam) on a
    device-resident batch of 32 clips of T x img x img, as the member of
    the World `w` runs it (None: unsharded, the card alone): its T chunk of
    the uint8 clips, the train preprocess at full H, then its H rows, DDP
    over every rank. One step's launches, jitter frames and pool shapes,
    the median of 3 timed steps, peak device memory and the loss; the
    classifier (parameters and buffers) equal on every rank."""
    import torch
    from coclr_tpu_torch import main_classifier
    from coclr_tpu_torch.evalsuite import driver, steps
    from coclr_tpu_torch.kernels import build
    from coclr_tpu_torch.parallel import dist
    from coclr_tpu_torch.train.pretrain import member_chunk

    cfg = main_classifier.cfg_from_args(main_classifier.parse_args(eval_argv(
        "", "--train_what", "ft", "--net", net, "--img_dim", str(img))))
    sp, sph = (w.sp, w.sph) if w else (1, 1)
    model = driver.build_model(cfg, sp=w.seqpar if w else None).to(dev)
    opt = steps.make_classifier_optimizer(cfg, model)
    ddp = dist.wrap(model, w) if w else None
    gen = torch.Generator(dev).manual_seed(10)  # alike on every member
    seq = torch.randint(0, 256, (B, T, img, img, 3), dtype=torch.uint8,
                        device=dev, generator=gen)
    label = torch.randint(0, NUM_CLASS, (B,), device=dev, generator=gen)
    seq = member_chunk({"seq": seq}, 1, w.sp_rank if w else 0,
                       sp)["seq"].contiguous()
    h_chunk = (w.sph_rank, sph) if w else (0, 1)

    def step():
        x = steps.preprocess_train(seq, gen, cfg.dtype, h_chunk)
        return steps.train_step(model, opt, x, label, 1e-3, drop_gen=gen,
                                ddp=ddp)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    with PoolShapes() as rec, JitterFrames() as jf:
        metrics = step()
    one = {k: kern.launches for k, kern in build.KERNELS.items()}
    check(one == {"jitter": 1, "pool1d_bwd": pool_launches},
          f"[{tag}] launches in one step {one}")
    check(jf.frames == [B * T // sp], f"[{tag}] jitter frames {jf.frames}")
    check(math.isfinite(float(metrics["loss"])), f"[{tag}] loss")
    if w is not None:
        check(same_on_all_ranks(list(model.parameters())
                                + list(model.buffers()), w),
              f"[{tag}] the classifier differs between the ranks")
    ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step()["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    res = dict(counts=one, frames=jf.frames[0], dev_ms=statistics.median(ms[1:]),
               peak=torch.cuda.max_memory_allocated(),
               loss=float(metrics["loss"]),
               shapes=[list(k) + [v] for k, v in rec.shapes.items()])
    print(f"[{tag}] {net} finetune at img_dim {img}, sp {sp} x sph {sph}, "
          f"device-resident step: launches {one} (jitter F = {res['frames']}), "
          f"loss {res['loss']:.4f}, median {res['dev_ms']:.1f} ms, peak "
          f"{res['peak'] / 2**30:.2f} GiB"
          + ("; the classifier equal on every rank" if w else ""),
          flush=True, **({"force": True} if w else {}))
    del model, opt, ddp, seq
    torch.cuda.empty_cache()
    return res


def classifier_sp_loops(dev, world, work, data_root, pretrained, tag):
    """main_classifier --sp_size 2 from `pretrained` on this rank: (d) the
    finetune, 3 loop steps and validation; (e) the linear probe, 3 loop
    steps and validation. Counted launches, jitter frames and pool shapes;
    both ranks end with the same classifier; the validation count is the
    number of validation clips; the probe's backbone stays the
    checkpoint's bit for bit."""
    import torch
    from coclr_tpu_torch import main_classifier
    from coclr_tpu_torch.evalsuite import driver
    from coclr_tpu_torch.evalsuite.driver import run_classifier_train
    from coclr_tpu_torch.utils.checkpoint import load_checkpoint

    out = {}
    for what, pool_launches in (("ft", 37), ("last", 0)):
        cfg = main_classifier.cfg_from_args(main_classifier.parse_args(
            eval_argv(data_root, "--train_what", what, "--epochs", "1",
                      "--pretrain", pretrained, "--dist-backend", "gloo",
                      "--sp_size", "2")))
        with PoolShapes() as rec, JitterFrames() as jf:
            (model, _, info), counts, _, peak = counted(
                lambda: run_classifier_train(cfg, max_steps=3, device="cuda"),
                work)
        n = len(info["step_s"])
        per_step = {k: c / n for k, c in counts.items()}
        check(n == 3 and per_step == {"jitter": 1, "pool1d_bwd": pool_launches},
              f"[{tag}] {what}: {n} steps, launches {counts}")
        check(jf.frames == [B * T // 2] * 3, f"[{tag}] {what}: jitter frames "
                                             f"{jf.frames}")
        check(math.isfinite(info["loss"]) and math.isfinite(info["val"]["loss"]),
              f"[{tag}] {what}: loss {info['loss']}, validation {info['val']}")
        clips = min(len(driver.build_eval_dataset(cfg, "val")), 3 * B)
        check(info["val"]["count"] == clips,
              f"[{tag}] {what}: validation counted {info['val']['count']} "
              f"clips, not {clips}")
        check(same_on_all_ranks(list(model.parameters())
                                + list(model.buffers()), world),
              f"[{tag}] {what}: the classifier differs between the ranks")
        if what == "last":
            file = {k[len("encoder_q.0."):]: v for k, v in
                    load_checkpoint(pretrained)["state_dict"].items()
                    if k.startswith("encoder_q.0.")}
            got = model.backbone.state_dict()
            check(got.keys() == file.keys()
                  and all(torch.equal(v.cpu(), file[k]) for k, v in got.items()),
                  f"[{tag}] the probe's backbone is not its checkpoint's")
        name = "cls_sp2" if what == "ft" else "probe_sp2"
        out[name] = dict(counts=counts, per_step=per_step, peak=peak,
                         val=info["val"], clips=clips,
                         step_ms=statistics.median(info["step_s"][1:]) * 1e3,
                         shapes=[list(k) + [v // n]
                                 for k, v in rec.shapes.items()],
                         ckpt=os.path.join(work, info["exp_path"], "model",
                                           "epoch0.pth.tar"))
        print(f"[{tag}] main_classifier --train_what {what} --sp_size 2: 3 "
              f"steps of {B} clips (T chunk {T // 2} of {T}), launches "
              f"{counts} (jitter F = {jf.frames[0]}), median step "
              f"{out[name]['step_ms']:.1f} ms after 1, peak "
              f"{peak / 2**30:.2f} GiB; validation {info['val']} over {clips} "
              f"clips; the classifier equal on both ranks"
              + ("; the backbone is the checkpoint's bit for bit"
                 if what == "last" else ""), force=True, flush=True)
        del model
        torch.cuda.empty_cache()
    return out


def classifier_forward_sp(dev, worlds, tag):
    """The float32 eval-mode S3D classifier (TF32 off; conditioned weights,
    a head of N(0, 1/32)) at each World of `worlds` against the same
    forward unsharded, on 4 clips: the largest difference of the logits."""
    import torch
    from coclr_tpu_torch.config import EvalConfig
    from coclr_tpu_torch.evalsuite import driver
    from coclr_tpu_torch.train.pretrain import member_chunk

    cfg = EvalConfig(net="s3d", train_what="ft", compute_dtype="float32",
                     seq_len=T, img_dim=S)
    model = driver.build_model(cfg)
    conditioned_(model.backbone, seed=6)
    with torch.no_grad():
        model.final_fc.weight.normal_(0.0, 1.0 / 32,
                                      generator=torch.Generator().manual_seed(7))
    model = model.to(dev).eval()
    x = torch.randn(4, 3, T, S, S, device=dev,
                    generator=torch.Generator(dev).manual_seed(8))
    with torch.no_grad():
        ref = model(x)[0]
    out = {}
    for name, w in worlds.items():
        sharded = driver.build_model(cfg, sp=w.seqpar)
        sharded.load_state_dict(model.state_dict())
        sharded = sharded.to(dev).eval()
        xs = member_chunk({"x": x}, 2, w.sp_rank, w.sp)["x"]
        xs = member_chunk({"x": xs}, 3, w.sph_rank, w.sph)["x"].contiguous()
        with torch.no_grad():
            y = sharded(xs)[0]
        err = float((y - ref).abs().max())
        out[name] = dict(err=err, scale=float(ref.abs().max()))
        check(err <= 1e-4, f"[{tag}] classifier logits at {name} differ from "
                           f"the unsharded ones by {err} (limit 1e-4)")
        del sharded, xs, y
    print(f"[{tag}] float32 eval-mode S3D classifier (TF32 off), 4 clips: max "
          f"abs difference to the unsharded 101 logits "
          + ", ".join(f"{v['err']:.3g} at {k}" for k, v in out.items())
          + f" (limit 1e-4; logits up to {out['sp2']['scale']:.3g})",
          force=True, flush=True)
    del model, x, ref
    torch.cuda.empty_cache()
    return out


def seqpar4_rank(rank, port, out):
    """One of four ranks sharing cuda:0 over gloo in a (data 1, sp 2, sph
    2) grid, started as torchrun starts it: the S3D finetune step on a
    device-resident batch (classifier_sp_step). Writes
    out/grid4-rank<rank>.json."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch.distributed as tdist
    from coclr_tpu_torch.parallel import dist
    from coclr_tpu_torch.utils import prepare_run

    dev = prepare_run("cuda")
    world = dist.maybe_initialize(dev, "gloo", 0, 2, 2)
    check(world.n_data == 1 and world.sp == 2 and world.sph == 2,
          "[seqpar 4-rank] not a (data 1, sp 2, sph 2) grid")
    res = classifier_sp_step(dev, world, "s3d", S, f"seqpar 4-rank {rank}", 37)
    with open(os.path.join(out, f"grid4-rank{rank}.json"), "w") as f:
        json.dump(res, f)
    tdist.barrier(group=world.host_group)
    tdist.destroy_process_group()


def seqpar_rank(rank, port, out, data_root, pretrained):
    """One of the seqpar phase's two ranks, in a process of its own on
    cuda:0, started as torchrun starts it:
    (a) main_nce --sp_size 2 (InfoNCE, full width, 32 clips a data shard):
        4 loop steps through run_pretrain, the launches and pool shapes of
        the run, encoder_q and the queue equal on both ranks;
    (b) the float32 eval-mode S3D encoder (TF32 off) at sp 2 and at sph 2
        against the same forward unsharded, on 4 clips;
    (c) device-resident steps: S3D InfoNCE at sph 2, r50 InfoNCE at sp 2 and
        S3D CoCLR with a full queue at sp 2, each with its launches, pool
        shapes, median step time and peak device memory;
    and the time of the largest temporal halo of the S3D step and of one
    sp_pmean of BatchNorm statistics; then the classifier:
    (d), (e) main_classifier --train_what ft and last --sp_size 2 from
        `pretrained`, 3 loop steps and validation each
        (classifier_sp_loops);
    (f) device-resident finetune steps: S3D at sph 2, at sp 2 and at
        img_dim 224 with sph 2, r50 at sp 2 (classifier_sp_step), and the
        float32 eval-mode classifier at sp 2 and sph 2 against unsharded.
    Writes out/rank<rank>.json."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SP_RANKS),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch
    import torch.distributed as tdist
    from coclr_tpu_torch import main_nce
    from coclr_tpu_torch.kernels import build
    from coclr_tpu_torch.models.encoder import ProjectionEncoder, init_params_
    from coclr_tpu_torch.models.moco import MoCo, draw_shuffle
    from coclr_tpu_torch.ops import seqpar
    from coclr_tpu_torch.ops.augment import make_pretrain_preprocess
    from coclr_tpu_torch.parallel import dist
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step
    from coclr_tpu_torch.train.pretrain import member_chunk, run_pretrain

    dev = torch.device("cuda", 0)
    tag = f"seqpar rank {rank}"
    work = os.path.join(out, f"rank{rank}")
    os.makedirs(work)
    res = {"rank": rank}

    # (a) main_nce --sp_size 2 through run_pretrain (pool shapes counted
    # over the run, kept per step)
    argv = ["--net", "s3d", "--seq_len", str(T), "--img_dim", str(S),
            "--batch_size", str(B), "--moco-k", str(K), "--moco-dim", str(DIM),
            "--epochs", "1", "--workers", "8", "--print_freq", "1",
            "--data_root", data_root, "--prefix", "smoke", "--dist-backend",
            "gloo", "--sp_size", "2"]
    cfg = main_nce.cfg_from_args(main_nce.parse_args(argv))
    with PoolShapes() as rec:
        (model, _, info), counts, _, peak = counted(
            lambda: run_pretrain(cfg, max_steps=SP_LOOP, device="cuda"), work)
    world = dist.maybe_initialize(dev, "gloo", 0, 2, 1)
    n = len(info["step_s"])
    per_step = {k: c / n for k, c in counts.items()}
    check(n == SP_LOOP and math.isfinite(info["loss"]),
          f"[{tag}] (a) {n} steps, loss {info['loss']}")
    check(world.sp == 2 and world.n_data == 1 and world.seqpar is not None,
          f"[{tag}] (a) not a (data 1, sp 2) grid")
    check(per_step == {"jitter": 1, "pool1d_bwd": 37},
          f"[{tag}] (a) launches per step {per_step}")
    check(int(model.queue_ptr) == SP_LOOP * B % K, f"[{tag}] (a) queue_ptr")
    check(same_on_all_ranks(list(model.encoder_q.parameters()) + [model.queue],
                            world),
          f"[{tag}] (a) encoder_q or the queue differs between the ranks")
    res["infonce"] = dict(counts=counts, per_step=per_step, peak=peak,
                          step_ms=statistics.median(info["step_s"][2:]) * 1e3,
                          shapes=[list(k) + [v // n]
                                  for k, v in rec.shapes.items()],
                          ckpt=os.path.join(work, info["exp_path"], "model",
                                            "epoch0.pth.tar"))
    print(f"[{tag}] (a) main_nce --sp_size 2: {n} steps of {B} clips (T chunk "
          f"{T // 2} of {T}), launches {counts}, median step "
          f"{res['infonce']['step_ms']:.1f} ms after 2 warm-up, peak "
          f"{peak / 2**30:.2f} GiB; encoder_q and the queue equal on both "
          f"ranks", force=True, flush=True)
    del model
    torch.cuda.empty_cache()

    # (b) float32 eval-mode forward, sp 2 and sph 2 against unsharded
    worlds = {"sp2": world, "sph2": dist.with_seqpar(world, 1, 2)}
    enc = ProjectionEncoder("s3d", DIM, torch.float32)
    init_params_(enc, torch.Generator().manual_seed(3))
    conditioned_(enc[0])
    enc = enc.to(dev).eval()
    x = torch.randn(4, 3, T, S, S, device=dev,
                    generator=torch.Generator(dev).manual_seed(4))
    with torch.no_grad():
        ref = enc(x)
    res["forward"] = {}
    for name, w in worlds.items():
        sharded = ProjectionEncoder("s3d", DIM, torch.float32, sp=w.seqpar)
        sharded.load_state_dict(enc.state_dict())
        sharded = sharded.to(dev).eval()
        xs = member_chunk({"x": x}, 2, w.sp_rank, w.sp)["x"]
        xs = member_chunk({"x": xs}, 3, w.sph_rank, w.sph)["x"].contiguous()
        with torch.no_grad():
            y = sharded(xs)
        err = float((y - ref).abs().max())
        res["forward"][name] = dict(err=err, scale=float(ref.abs().max()))
        check(err <= 1e-4, f"[{tag}] (b) {name} forward differs from the "
                           f"unsharded one by {err} (limit 1e-4)")
        del sharded, xs, y
    print(f"[{tag}] (b) float32 eval-mode S3D encoder (TF32 off), 4 clips: "
          f"max abs difference to the unsharded 128-d output "
          f"{res['forward']['sp2']['err']:.3g} at sp 2, "
          f"{res['forward']['sph2']['err']:.3g} at sph 2 (limit 1e-4; output "
          f"up to {res['forward']['sp2']['scale']:.3g})", force=True,
          flush=True)
    del enc, x, ref
    torch.cuda.empty_cache()

    # the largest temporal halo of the S3D step (Conv_1a's temporal conv,
    # pad 3 on a T chunk of 16) and one sp_pmean of BatchNorm statistics
    h = torch.randn(B, 64, T // 2, S // 2, S // 2, device=dev).to(torch.bfloat16)
    stats = torch.randn(1024, device=dev)
    for name, fn in (("halo", lambda: seqpar.temporal_halo(h, 3, 3,
                                                           world.sp_group)),
                     ("pmean", lambda: seqpar.sp_pmean(stats, world.seqpar))):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res[name + "_ms"] = statistics.median(times[1:]) * 1e3
    res["halo_bytes"] = 2 * B * 64 * 3 * (S // 2) ** 2 * 2
    del h, stats
    torch.cuda.empty_cache()

    # (c) device-resident steps
    for name, net, variant, w, expect in (
            ("sph2_s3d", "s3d", "infonce", worlds["sph2"], 37),
            ("sp2_r50", "r50", "infonce", worlds["sp2"], 2),
            ("sp2_coclr_open", "s3d", "coclr", worlds["sp2"], 37)):
        cfg = full_width(variant, "", net=net, dataset="ucf101-2stream-2clip",
                         topk=5, dist_backend="gloo", sp_size=w.sp,
                         sph_size=w.sph)
        model = MoCo(net, DIM, K, torch.bfloat16, variant=variant,
                     sp=w.seqpar).to(dev).train()
        gen = torch.Generator(dev).manual_seed(10)  # alike on both ranks
        u8 = lambda: torch.randint(0, 256, (B, 2, T, S, S, 3),
                                   dtype=torch.uint8, device=dev, generator=gen)
        batch = {"aug_base": torch.randint(0, 2, (B, 2), dtype=torch.uint8,
                                           device=dev, generator=gen)}
        if variant == "coclr":
            batch.update(seq_rgb=u8(), seq_flow=u8(),
                         vname=torch.randint(0, 100, (B,), dtype=torch.int32,
                                             device=dev, generator=gen))
            model.queue_label.fill_(1)
            model.queue_vname.copy_(torch.randint(0, 100, (K,), device=dev,
                                                  generator=gen))
        else:
            batch["seq"] = u8()
        batch = {k: v.contiguous() for k, v in member_chunk(
            batch, 2, w.sp_rank, w.sp).items()}
        sp_ctx = (T, w.sp_rank * (T // w.sp)) if w.sp > 1 else None
        opt = make_optimizer(cfg, model.encoder_q.parameters())
        ddp = dist.wrap(model.encoder_q, w)
        pre = make_pretrain_preprocess(cfg)
        perm = draw_shuffle(torch.Generator().manual_seed(0), B * w.n_data)

        def step():
            b = member_chunk(pre(batch, gen, sp_ctx), 3, w.sph_rank, w.sph)
            return pretrain_step(model, opt, b, 1e-3, cfg, ddp=ddp, perm=perm,
                                 data_group=w.data_group)

        torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        with PoolShapes() as rec:
            metrics = step()
        one = {k: kern.launches for k, kern in build.KERNELS.items()}
        check(one == {"jitter": 1, "pool1d_bwd": expect},
              f"[{tag}] (c) {name} step launches {one}")
        check(math.isfinite(float(metrics["loss"])), f"[{tag}] (c) {name} loss")
        if variant == "coclr":
            check(float(metrics["queue_is_full"]) == 1.0,
                  f"[{tag}] (c) the CoCLR gate is not open")
        check(same_on_all_ranks(list(model.encoder_q.parameters())
                                + [model.queue], w),
              f"[{tag}] (c) {name}: encoder_q or the queue differs between "
              f"the ranks")
        ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step()["loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
        res[name] = dict(counts=one, dev_ms=statistics.median(ms[1:]),
                         peak=torch.cuda.max_memory_allocated(),
                         loss=float(metrics["loss"]),
                         shapes=[list(k) + [v] for k, v in rec.shapes.items()])
        print(f"[{tag}] (c) {name} ({net} {variant}, sp {w.sp} x sph "
              f"{w.sph}) device-resident step: launches {one}, loss "
              f"{res[name]['loss']:.4f}, median {res[name]['dev_ms']:.1f} ms, "
              f"peak {res[name]['peak'] / 2**30:.2f} GiB; encoder_q and the "
              f"queue equal on both ranks", force=True, flush=True)
        del model, opt, ddp, batch
        torch.cuda.empty_cache()

    # the classifier: (d), (e) the loops through main_classifier's flags,
    # (f) device-resident steps and the eval-mode forward
    t0 = time.time()
    res.update(classifier_sp_loops(dev, world, work, data_root, pretrained,
                                   tag))
    t1 = time.time()
    for name, net, img, w, expect in (
            ("cls_sph2", "s3d", S, worlds["sph2"], 37),
            ("cls_sp2_dev", "s3d", S, worlds["sp2"], 37),
            ("cls_r50_sp2", "r50", S, worlds["sp2"], 2),
            ("cls_224_sph2", "s3d", 224, worlds["sph2"], 37)):
        res[name] = classifier_sp_step(dev, w, net, img, f"{tag} {name}",
                                       expect)
    res["cls_forward"] = classifier_forward_sp(dev, worlds, tag)
    print(f"[{tag}] classifier loops {t1 - t0:.1f} s, device steps and "
          f"forward {time.time() - t1:.1f} s", force=True, flush=True)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    tdist.barrier(group=world.host_group)
    tdist.destroy_process_group()


def phase_seqpar(dev, work, data_root, card, paths, unsharded_shapes,
                 pretrained):
    """Sequence parallelism (--sp_size / --sph_size) through the entry points
    in two spawned ranks that share cuda:0 over gloo (seqpar_rank), the
    classifier's finetune step at sp 2 x sph 2 in four (seqpar4_rank) and
    at img_dim 224 unsharded in this process; then in this process: the
    new pool1d_bwd launch shapes exact against the plain version in
    bfloat16 and float32 (timed, with their bound and library times),
    kernel 1 at the sp launch (F = 1024, gray on) and at the classifier's
    (F = 512, gray off). Returns the paths it counted and the kernels' sp
    numbers. Ranks on one card time-slice it: their times are not scaling
    numbers."""
    import torch
    import torch.multiprocessing as tmp
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  load_reference_state_dict)

    t0 = time.time()
    out = os.path.join(work, "seqpar")
    os.makedirs(out)
    torch.cuda.empty_cache()
    tmp.spawn(seqpar_rank, args=(free_port(), out, data_root, pretrained),
              nprocs=SP_RANKS)
    ranks = []
    for r in range(SP_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    wrote = [sorted(glob_ckpts(os.path.join(out, f"rank{r}")))
             for r in range(SP_RANKS)]
    check(wrote[0] and not any(wrote[1:]),
          f"[seqpar] checkpoints not written by rank 0 alone: {wrote}")
    back = MoCo("s3d", DIM, K, torch.bfloat16)
    load_reference_state_dict(back, load_checkpoint(
        ranks[0]["infonce"]["ckpt"])["state_dict"])
    check(int(back.queue_ptr) == SP_LOOP * B % K,
          "[seqpar] checkpoint read back wrong")
    del back
    ranks_s = time.time() - t0
    add = lambda key: {k: sum(r[key]["counts"][k] for r in ranks)
                       for k in ("jitter", "pool1d_bwd")}
    new = {"seqpar_sp2": {"counts": add("infonce"),
                          "per_step": ranks[0]["infonce"]["per_step"]}}
    for name in ("sph2_s3d", "sp2_r50", "sp2_coclr_open"):
        new["seqpar_" + name] = {"counts": add(name),
                                 "per_step": ranks[0][name]["counts"]}
    same = {"sph2_s3d": ("infonce", "S3D InfoNCE"),
            "sp2_r50": ("r50_infonce", "r50 InfoNCE"),
            "sp2_coclr_open": ("coclr_open", "S3D CoCLR full queue")}
    print(f"[seqpar] 2 ranks sharing one card ({card}) over gloo, {ranks_s:.1f} "
          f"s: (a) main_nce --sp_size 2 loop step per rank "
          f"{[round(r['infonce']['step_ms'], 1) for r in ranks]} ms, peak "
          f"{[round(r['infonce']['peak'] / 2**30, 2) for r in ranks]} GiB; "
          f"checkpoint {wrote[0]} from rank 0 only, read back strictly; one "
          f"temporal halo of {ranks[0]['halo_bytes']} B (Conv_1a, pad 3) "
          f"{[round(r['halo_ms'], 2) for r in ranks]} ms, one sp_pmean of "
          f"1024 floats {[round(r['pmean_ms'], 3) for r in ranks]} ms",
          flush=True)
    for name, (ref, what) in same.items():
        un = paths[ref]
        print(f"[seqpar] {what} ({name}): per-rank step "
              f"{[round(r[name]['dev_ms'], 1) for r in ranks]} ms and peak "
              f"{[round(r[name]['peak'] / 2**30, 2) for r in ranks]} GiB; the "
              f"same program unsharded on the card alone {un['dev_ms']:.1f} ms, "
              f"peak {un['peak'] / 2**30:.2f} GiB (peak ratio "
              f"{ranks[0][name]['peak'] / un['peak']:.2f}); the ranks "
              f"time-slice one card, so the times are not scaling numbers",
              flush=True)

    # kernel 2 at every new launch shape of (a) and (c), exact in both dtypes
    gen = torch.Generator(dev).manual_seed(5)
    pool = {}
    for name, key in (("s3d_sp2", "infonce"), ("s3d_sph2", "sph2_s3d"),
                      ("r50_sp2", "sp2_r50")):
        shapes = {tuple(v[:6]): v[6] for v in ranks[0][key]["shapes"]}
        fresh = {k: c for k, c in shapes.items() if k not in unsharded_shapes}
        check(fresh, f"[seqpar] no new pool shape at {name}")
        pool[name] = measure_pool(fresh, dev, gen, f"pool-{name}",
                                  exact_f32=True)
        pool[name]["launches_per_step"] = sum(shapes.values())
    coclr = {tuple(v[:6]) for v in ranks[0]["sp2_coclr_open"]["shapes"]}
    sp2 = {tuple(v[:6]) for v in ranks[0]["infonce"]["shapes"]}
    check(coclr == sp2, "[seqpar] the CoCLR sp 2 step pools at other shapes "
                        "than the InfoNCE one")
    # kernel 1 at the sp 2 launch: 32 clips x 2 x a T chunk of 16
    jit = jitter_case(B * 2 * T // 2, S, dev, gen, timed=True,
                      tag="jitter-sp2")

    # the classifier: its loops' checkpoints, the 4-rank grid, img_dim 224
    # unsharded, the new pool shapes and kernel 1 at its sp 2 launch
    t1 = time.time()
    cls = classifier_sp_results(dev, out, ranks, wrote, paths, card)
    new.update(cls["paths"])
    held = set(unsharded_shapes) | {
        tuple(v[:6]) for key in ("infonce", "sph2_s3d", "sp2_r50")
        for v in ranks[0][key]["shapes"]}
    for name, shapes in cls["shapes"].items():
        if name in ("cls_sp2", "probe_sp2", "cls_sp2_dev", "cls_sph2",
                    "cls_r50_sp2"):
            check(set(shapes) <= held, f"[seqpar] {name} pools at shapes "
                                       f"that pretraining's do not take")
            continue
        fresh = {k: c for k, c in shapes.items() if k not in held}
        check(fresh, f"[seqpar] no new pool shape at {name}")
        pool[name] = measure_pool(fresh, dev, gen, f"pool-{name}",
                                  exact_f32=True)
        pool[name]["launches_per_step"] = sum(shapes.values())
    cls_jit = phase_jitter_eval(dev, T // 2, "jitter-cls-sp2")
    print(f"[seqpar] classifier part took {time.time() - t1:.1f} s; phase "
          f"took {time.time() - t0:.1f} s", flush=True)
    return new, {"pool": pool, "jitter": jit, "cls_jitter": cls_jit,
                 "ranks": ranks}


def classifier_sp_results(dev, out, ranks, wrote, paths, card):
    """The classifier part of the seqpar phase from the two ranks' results:
    rank 0 alone wrote the classifiers' checkpoints, which read back
    strictly; the (data 1, sp 2, sph 2) finetune step in four spawned
    ranks; the img_dim 224 step unsharded in this process; per-rank times
    and peaks beside the unsharded finetune's. Returns the paths and each
    one's pool shapes."""
    import torch
    import torch.multiprocessing as tmp
    from coclr_tpu_torch import main_classifier
    from coclr_tpu_torch.evalsuite import driver
    from coclr_tpu_torch.utils.checkpoint import load_checkpoint

    for name in ("cls_sp2", "probe_sp2"):
        ckpt = ranks[0][name]["ckpt"]
        check(os.path.relpath(ckpt, os.path.join(out, "rank0")) in wrote[0],
              f"[seqpar] {name}: no checkpoint from rank 0")
        cfg = main_classifier.cfg_from_args(main_classifier.parse_args(
            eval_argv("", "--train_what", "ft" if name == "cls_sp2"
                      else "last")))
        driver.build_model(cfg).load_state_dict(
            load_checkpoint(ckpt)["state_dict"])
    torch.cuda.empty_cache()
    t0 = time.time()
    tmp.spawn(seqpar4_rank, args=(free_port(), out), nprocs=4)
    print(f"[seqpar] 4 ranks: {time.time() - t0:.1f} s", flush=True)
    grid4 = []
    for r in range(4):
        with open(os.path.join(out, f"grid4-rank{r}.json")) as f:
            grid4.append(json.load(f))
    alone = classifier_sp_step(dev, None, "s3d", 224, "seqpar cls-224", 37)

    un, un_r50 = paths["finetune"], paths["r50_finetune"]
    ratio = lambda peak, ref: round(peak / ref, 2)
    for name in ("cls_sp2", "probe_sp2"):
        ref = paths["finetune" if name == "cls_sp2" else "probe"]
        print(f"[seqpar] main_classifier --train_what "
              f"{'ft' if name == 'cls_sp2' else 'last'} --sp_size 2 loop, "
              f"2 ranks sharing one card ({card}) over gloo: per-rank step "
              f"{[round(r[name]['step_ms'], 1) for r in ranks]} ms, peak "
              f"{[round(r[name]['peak'] / 2**30, 2) for r in ranks]} GiB "
              f"(peak ratio {ratio(ranks[0][name]['peak'], ref['loop_peak'])} "
              f"against the unsharded loop's {ref['loop_peak'] / 2**30:.2f} "
              f"GiB, step {ref['step_ms']:.1f} ms); validation count "
              f"{ranks[0][name]['val']['count']} of {ranks[0][name]['clips']} "
              f"clips; checkpoint from rank 0 only, read back strictly",
              flush=True)
    per_rank = lambda name: [r[name] for r in ranks]
    rows = [(per_rank("cls_sph2"), un, "S3D finetune at sph 2"),
            (per_rank("cls_sp2_dev"), un, "S3D finetune at sp 2"),
            (grid4, un, "S3D finetune at sp 2 x sph 2 (4 ranks)"),
            (per_rank("cls_r50_sp2"), un_r50, "r50 finetune at sp 2"),
            (per_rank("cls_224_sph2"), alone,
             "S3D finetune at img_dim 224, sph 2")]
    for got, ref, what in rows:
        print(f"[seqpar] {what}, device-resident: per-rank step "
              f"{[round(g['dev_ms'], 1) for g in got]} ms, peak "
              f"{[round(g['peak'] / 2**30, 2) for g in got]} GiB; unsharded "
              f"on the card alone {ref['dev_ms']:.1f} ms, peak "
              f"{ref['peak'] / 2**30:.2f} GiB (peak ratio "
              f"{ratio(got[0]['peak'], ref['peak'])}); the ranks time-slice "
              f"one card, so the times are not scaling numbers", flush=True)
    fwd = ranks[0]["cls_forward"]
    print(f"[seqpar] eval-mode float32 classifier logits against unsharded: "
          f"{fwd['sp2']['err']:.3g} at sp 2, {fwd['sph2']['err']:.3g} at "
          f"sph 2 (limit 1e-4)", flush=True)

    add = lambda rs, key: {k: sum((r[key] if key else r)["counts"][k]
                                  for r in rs)
                           for k in ("jitter", "pool1d_bwd")}
    new, shapes = {}, {}
    for name in ("cls_sp2", "probe_sp2", "cls_sph2", "cls_sp2_dev",
                 "cls_r50_sp2", "cls_224_sph2"):
        new["seqpar_" + name] = {"counts": add(ranks, name),
                                 "per_step": ranks[0][name].get(
                                     "per_step", ranks[0][name]["counts"])}
        shapes[name] = {tuple(v[:6]): v[6] for v in ranks[0][name]["shapes"]}
    new["seqpar_cls_sp2xsph2"] = {"counts": add(grid4, None),
                                  "per_step": grid4[0]["counts"]}
    shapes["cls_sp2xsph2"] = {tuple(v[:6]): v[6] for v in grid4[0]["shapes"]}
    new["cls_224"] = {"counts": alone["counts"], "per_step": alone["counts"]}
    shapes["cls_224"] = {tuple(v[:6]): v[6] for v in alone["shapes"]}
    return {"paths": new, "shapes": shapes}


# the drive phase: the recipe at full S3D width, one epoch a phase. 4 classes
# x 7 train groups x 8 clips = 224 train videos = 7 steps of 32; a queue of
# 128 fills after 4, so CoCLR's steps 5-7 train with the gate open
DRIVE_K, DRIVE_TRAIN, DRIVE_TEST = 128, 224, 32
DRIVE_FLAGS = ["--seq_len", str(T), "--img_dim", str(S), "--batch_size",
               str(B), "--moco_k", str(DRIVE_K), "--n_classes", "4",
               "--n_groups", "8", "--n_clips", "8", "--test_groups", "1",
               "--epochs_nce", "1", "--epochs_coclr", "1", "--cycles", "1",
               "--skip_downstream", "--retrieval_max_windows", "1",
               "--workers", "8"]
DRIVE_TRAIN_TAGS = {"cyc_nce_rgb": "nce_rgb", "cyc_nce_flow": "nce_flow",
                    "cyc_cf": "coclr_flowmining", "cyc_cr": "coclr_rgbmining"}
DRIVE_RETRIEVALS = ("retrieval_rgb_init", "retrieval_flow_init",
                    "retrieval_rgb_coclr", "retrieval_flow_coclr")


def drive_counts(path):
    """{phase tag: launch counts} from the lines the drive's CLI processes
    wrote at exit (kernels/build.py write_counts); the drive's own line
    must count no launch."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            argv = rec["argv"][1:]
            if "--workdir" in argv:
                # the drive itself: its feature-health reader imports the
                # retrieval module and so the wrappers, and launches nothing
                check(not any(rec["counts"].values()),
                      f"the drive process launched kernels: {rec['counts']}")
                continue
            if "--prefix" in argv:
                tag = DRIVE_TRAIN_TAGS[argv[argv.index("--prefix") + 1]]
            else:
                tag = os.path.basename(
                    argv[argv.index("--dirname") + 1])[len("feat_"):]
            check(tag not in out, f"two processes for drive phase {tag}")
            out[tag] = rec["counts"]
    return out


def phase_drive(work):
    """The CoCLR recipe drive (python -m
    coclr_tpu_torch.tools.drive_coclr_cycle, DRIVE_FLAGS) in a subprocess:
    staging, the two InfoNCE inits, FlowMining, RGBMining --reverse and the
    four retrievals, each through the port's CLI in a process of its own
    (COCLR_KERNEL_COUNTS collects each one's launches). Checks every phase,
    Self-acc@1 in both CoCLR logs, the checkpoint chain bit for bit, the
    four R@1, that each retrieval's features are finite (their health is
    printed) and each process's launches."""
    import torch
    from coclr_tpu_torch.evalsuite.retrieval import CLIP_BATCH
    from coclr_tpu_torch.kernels import build
    from coclr_tpu_torch.tools import drive_coclr_cycle as drive

    torch.cuda.empty_cache()
    wd = os.path.join(work, "cyc")
    counts_file = os.path.join(work, "drive_counts.jsonl")
    log = os.path.join(work, "drive.log")
    env = dict(os.environ, **{build.COUNTS_ENV: counts_file})
    t0 = time.time()
    with open(log, "w") as f:
        p = subprocess.run(
            [sys.executable, "-m", "coclr_tpu_torch.tools.drive_coclr_cycle",
             "--workdir", wd, *DRIVE_FLAGS],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=f, stderr=subprocess.STDOUT, timeout=600)
    wall = time.time() - t0
    with open(log) as f:
        text = f.read()
    check(p.returncode == 0, f"the drive failed (rc {p.returncode}):\n"
          f"{text[-6000:]}")
    with open(drive.report_path(wd, "DRIVE_coclr_cycle")) as f:
        phases = json.load(f)["phases"]
    logs = {}
    for tag in list(DRIVE_TRAIN_TAGS.values()) + list(DRIVE_RETRIEVALS):
        with open(os.path.join(wd, "drivelogs", f"{tag}.log")) as f:
            logs[tag] = f.read()
    for tag in DRIVE_TRAIN_TAGS.values():
        check(drive.parse_epochs(logs[tag]), f"no progress lines in {tag}")
    for tag in ("coclr_flowmining", "coclr_rgbmining"):
        check(drive.SELF_RE.findall(logs[tag]), f"no Self-acc@1 in {tag}")
    recall = {tag: phases[tag].get("R@1") for tag in DRIVE_RETRIEVALS}
    check(all(r is not None and 0.0 <= r <= 1.0 for r in recall.values()),
          f"retrieval R@1 {recall}")
    # the features' health is printed; only their finiteness is checked
    # (R@k and the spread are a learning signal at one epoch a phase)
    for tag in DRIVE_RETRIEVALS:
        h = phases[tag].get("features")
        check(h is not None, f"no feature health in the report for {tag}")
        print(f"[drive] {tag} features: " + ", ".join(
            f"{k} {h[k]:.4g}" if isinstance(h[k], float) else f"{k} {h[k]}"
            for k in ("nonfinite", "std_min", "std_median",
                      "effective_rank", "hub_share")), flush=True)
        check(h["finite"] and not phases[tag].get("nonfinite_features"),
              f"{tag}: {h['nonfinite']} non-finite feature values")
    chain, _ = drive.checkpoint_chain(wd)
    check(all(chain.values()), f"checkpoint chain {chain}")

    # every training step runs the backward (a gated CoCLR step skips only
    # the optimizer step), so each launches jitter once and the pool 37
    # times, bar the replays of the step's CUDA graph, which launch the
    # pool from the device (the epoch line counts them); retrieval
    # launches jitter once per 32 clips and no pool
    steps = DRIVE_TRAIN // B
    retr = -(-DRIVE_TRAIN // CLIP_BATCH) - (-DRIVE_TEST // CLIP_BATCH)
    replays = {tag: sum(map(int, re.findall(r"^Epoch: \[\d+\]\[\d+\] "
                                            r"T-epoch:\S+ captures:\d+ "
                                            r"replays:(\d+)$", logs[tag],
                                            re.M)))
               for tag in DRIVE_TRAIN_TAGS.values()}
    expect = {tag: {"jitter": steps,
                    "pool1d_bwd": 37 * (steps - replays[tag])}
              for tag in DRIVE_TRAIN_TAGS.values()}
    expect.update({tag: {"jitter": retr, "pool1d_bwd": 0}
                   for tag in DRIVE_RETRIEVALS})
    by_phase = drive_counts(counts_file)
    check(by_phase == expect, f"drive launches {by_phase}, expected {expect}")
    counts = {name: sum(c[name] for c in by_phase.values())
              for name in build.KERNELS}
    secs = {tag: phases[tag]["wall_s"] for tag in expect}
    print(f"[drive] the recipe (two InfoNCE inits -> FlowMining -> "
          f"RGBMining --reverse -> 4 retrievals) in {wall:.1f} s, staging "
          f"{wall - sum(secs.values()):.1f} s of it (budget 240 s); each "
          f"process: { {k: round(v, 1) for k, v in secs.items()} }",
          flush=True)
    gated = DRIVE_K // B
    print(f"[drive] every phase exited 0 with progress lines; Self-acc@1 "
          f"logged in both CoCLR phases; checkpoint chain {chain} (encoder_q "
          f"moves only in the {steps - gated} gate-open steps of {steps}); "
          f"R@1 {recall}; launches per process {by_phase}; step graph "
          f"replays per process {replays}", flush=True)
    return {"counts": counts}


def glob_ckpts(root):
    return [os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files
            if f.endswith(".pth.tar")]


def print_profile(tag, prof, n):
    """Print a trace reader summary (coclr_tpu_torch/utils/profiling.py) of n
    steps: busy share, device ops and time per step, the top device ops and
    the port's two kernels."""
    print(f"[{tag}] {n} steps: device busy {prof['busy_us_per_step'] / 1e3:.1f} "
          f"ms of {prof['window_us_per_step'] / 1e3:.1f} ms wall a step = "
          f"{prof['busy']:.1%} busy; {prof['device_ops_per_step']:.0f} device "
          f"ops, {prof['device_us_per_step'] / 1e3:.2f} ms of device op time, "
          f"{prof['host_launches_per_step']:.0f} host launch calls per step",
          flush=True)
    cats = {k: round(v / 1e3, 3) for k, v in prof["categories_us_per_step"].items()}
    print(f"[{tag}] device ms per step by category: {json.dumps(cats)}",
          flush=True)
    for name, us, launches in prof["top_ops_us_per_step"]:
        print(f"[{tag}]   {us / 1e3:8.3f} ms/step {launches:6.1f}/step  "
              f"{name[:110]}", flush=True)
    print(f"[{tag}] the port's kernels per step: "
          f"{json.dumps(prof['kernels'])}", flush=True)


def profile_steps(step, n, expect=("jitter", "pool1d_bwd")):
    """torch.profiler over n synchronized steps, read by the package's trace
    reader (coclr_tpu_torch/utils/profiling.py read_trace on the live
    profiler): prints the summary (print_profile) and the 8 host ops with
    the most self time; fails unless each kernel in `expect` ran; returns
    each kernel's ms per step, the busy share and the device op time (ms)
    per step."""
    import torch
    from coclr_tpu_torch.utils.profiling import read_trace
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary = read_trace(prof, n, topk=10, wall_us=wall_us)
    check(summary["device_ops_per_step"] > 0,
          "the profiler recorded no device activity")
    print_profile("profile", summary, n)
    # where the host's time goes (self time, inflated by the profiler itself)
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:8]
    for a in host:
        print(f"[profile]   host {a.self_cpu_time_total / 1e3 / n:8.3f} ms/step "
              f"{a.count / n:7.1f} calls/step  {a.key[:90]}", flush=True)
    kernels = {key: summary["kernels"][f"{key}_kernel"]["us_per_step"] / 1e3
               for key in ("jitter", "pool1d_bwd")}
    check(all(kernels[k] > 0 for k in expect),
          "the profiler saw no launch of one of the port's kernels")
    kernels["busy"] = summary["busy"]
    kernels["device_ms"] = summary["device_us_per_step"] / 1e3
    return kernels


def phase_profile(work, data_root, paths):
    """profile: the port's profiling as a user runs it.
    (a) run_pretrain (S3D InfoNCE, full width) with profile_steps 3 over the
        12-step epoch: the trace file under <exp>/trace, read back by the
        package's reader; jitter once and pool1d_bwd 37 times a step;
    (b) the tool (python -m coclr_tpu_torch.tools.profile_step, called
        in-process) for infonce, finetune and infonce --net r50, 3 steps
        each: its device time per step within 15 % of this script's own
        profiler window over the same program (phases 4, 7 and 9; the
        window's finetune step runs main_classifier's Adam where the tool
        runs SGD, as the JAX tool does), both kernels in its categories;
    (c) the port's validate_structure on the synthetic RGB and flow LMDBs.
    Returns the paths it counted."""
    from coclr_tpu_torch.data.lmdb_check import validate_structure
    from coclr_tpu_torch.data.lmdb_format import LMDBReader
    from coclr_tpu_torch.tools import profile_step
    from coclr_tpu_torch.utils.profiling import (TRACE_SUFFIX, read_trace,
                                                trace_events)

    out = {}
    t0 = time.time()
    cfg = full_width("infonce", data_root, profile_steps=3,
                     name_prefix="profiled_")
    _, info, per_step, counts, _ = run_counted(cfg, work, 12)
    check(per_step == {"jitter": 1, "pool1d_bwd": 37},
          f"[profile-loop] unexpected launches per step: {per_step}")
    trace = info["trace"]
    check(trace is not None and os.path.isfile(os.path.join(work, trace))
          and trace.endswith(TRACE_SUFFIX)
          and os.path.dirname(trace) == os.path.join(info["exp_path"], "trace"),
          f"[profile-loop] no trace file under <exp>/trace: {trace}")
    size = os.path.getsize(os.path.join(work, trace))
    loop = read_trace(os.path.join(work, trace), 3, topk=10)
    print(f"[profile-loop] --profile_steps 3 wrote {trace} ({size} bytes, "
          f"gzipped) at steps 9-11 of 12", flush=True)
    print_profile("profile-loop", loop, 3)
    events, _ = trace_events(os.path.join(work, trace))
    copies = [(n, d) for c, n, _, d in events if c == "gpu_memcpy"]
    print(f"[profile-loop] host-device copies in the window: {len(copies)}, "
          f"{sum(d for _, d in copies) / 1e3:.3f} ms in all "
          f"({sorted({n for n, _ in copies})})", flush=True)
    seen = {k: v["launches_per_step"] for k, v in loop["kernels"].items()}
    check(seen == {"jitter_kernel": 1, "pool1d_bwd_kernel": 37},
          f"[profile-loop] kernel launches per step in the trace: {seen}")
    out["profile_loop"] = {"counts": counts, "per_step": per_step,
                           "trace_summary": loop}

    windows = {"infonce": paths["infonce"]["in_step"]["device_ms"],
               "finetune": paths["finetune"]["in_step"]["device_ms"],
               "r50_infonce": paths["r50_infonce"]["in_step"]["device_ms"]}
    runs = {"infonce": ["--workload", "infonce"],
            "finetune": ["--workload", "finetune"],
            "r50_infonce": ["--workload", "infonce", "--net", "r50"]}
    for name, argv in runs.items():
        logdir = os.path.join(work, "profile_" + name)
        line, counts, sec, _ = counted(lambda: profile_step.main(
            argv + ["--steps", "3", "--topk", "10", "--logdir", logdir]), work)
        pool = 2 if name.startswith("r50") else 37
        # the wrappers launch in every step but the graph's replays (warm-up
        # steps included), and the trace shows both kernels in every traced
        # step
        steps, warm = 3 + line["warmup_steps"], line["warmup_steps"]
        launching = steps - line["replayed_steps"]
        check(counts == {"jitter": steps, "pool1d_bwd": launching * pool},
              f"[profile-tool] {name}: launches in {warm} warm-up and 3 "
              f"traced steps ({line['replayed_steps']} replays): {counts}")
        traced = {k: line["launches_per_step"].get(k + "_kernel")
                  for k in ("jitter", "pool1d_bwd")}
        check(traced == {"jitter": 1, "pool1d_bwd": pool},
              f"[profile-tool] {name}: launches per traced step: {traced}")
        cats = line["categories_us_per_step"]
        check(cats.get("jitter_kernel", 0) > 0
              and cats.get("pool1d_bwd_kernel", 0) > 0,
              f"[profile-tool] {name}: the port's kernels are not in "
              f"categories_us_per_step: {sorted(cats)}")
        tool_ms = line["device_us_per_step"] / 1e3
        ratio = tool_ms / windows[name]
        print(f"[profile-tool] {name}: {tool_ms:.2f} ms of device op time a "
              f"step against {windows[name]:.2f} ms in this script's window "
              f"over the same program ({ratio - 1:+.1%}; limit 15 %); busy "
              f"{line['busy']:.1%}; {sec:.1f} s", flush=True)
        check(abs(ratio - 1) <= 0.15,
              f"[profile-tool] {name}: the tool's device time is not within "
              f"15 % of the window's")
        out["profile_tool_" + name] = {"counts": counts, "line": line}

    for name in ("ucf101_frame.lmdb", "ucf101_tvl1_frame.lmdb"):
        path = os.path.join(data_root, "UCF101", name)
        stats = validate_structure(path)
        with LMDBReader(path) as db:
            entries = len(db)
        check(stats["entries"] == entries > 0,
              f"[lmdb-check] {name}: {stats} against {entries} entries read")
        print(f"[lmdb-check] {name} passes validate_structure: {stats}",
              flush=True)
    print(f"[profile] phase took {time.time() - t0:.1f} s", flush=True)
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "coclr_tpu_torch")):
        print("chip_smoke: coclr_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = phase_build()
    jit = phase_jitter(dev)
    jit_eval = phase_jitter_eval(dev)
    pool = phase_pool(dev)
    work = os.path.join(here, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        data_root = make_data(work)
        paths = {"infonce": phase_slice(dev, work, data_root),
                 "ubernce": phase_ubernce(dev, work, data_root)}
        pretrained = paths["infonce"]["ckpt"]
        paths["coclr_gated"] = phase_coclr(dev, work, data_root, pretrained)
        paths["finetune"] = phase_finetune(dev, work, data_root, pretrained)
        paths["probe"] = phase_probe(dev, work, data_root, pretrained)
        paths["retrieval"] = phase_retrieval(work, data_root, pretrained,
                                             "ucf101", "feature")
        paths["retrieval_flow"] = phase_retrieval(
            work, data_root, pretrained, "ucf101-f", "feature_flow")
        paths["ncrop"] = phase_ncrop(work, data_root, paths["probe"]["ckpt"],
                                     "ucf101", "ten")
        # the flow stream's classifier: the probe's weights, in a directory
        # of its own so that its prob json does not overwrite the RGB one
        flow_ckpt = os.path.join(work, "flow_probe", "model", "epoch0.pth.tar")
        os.makedirs(os.path.dirname(flow_ckpt))
        shutil.copy(paths["probe"]["ckpt"], flow_ckpt)
        paths["ncrop_flow"] = phase_ncrop(work, data_root, flow_ckpt,
                                          "ucf101-f", "center")
        phase_fusion(work, pretrained, paths["ncrop"]["json"],
                     paths["ncrop_flow"]["json"], paths["retrieval"]["cache"],
                     paths["retrieval_flow"]["cache"])
        paths["coclr_open"] = phase_coclr_device(dev)
        t0 = time.time()
        paths.update(phase_resnet(dev, work, data_root))
        print(f"[resnet] phase took {time.time() - t0:.1f} s", flush=True)
        paths.update(phase_profile(work, data_root, paths))
        paths.update(phase_ddp(work, data_root, pretrained, card))
        unsharded = {tuple(r["shape"]) for r in pool["rows"]
                     + pool["r50"]["rows"]}
        sp_paths, sp = phase_seqpar(dev, work, data_root, card, paths,
                                    unsharded, pretrained)
        paths.update(sp_paths)
        paths["drive"] = phase_drive(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    trained = ("infonce", "ubernce", "coclr_gated", "coclr_open", "finetune",
               "probe", "r50_infonce", "r3d50_infonce", "r50_coclr_open",
               "r50_finetune", "ddp_nccl_1rank", "ddp_gloo_2rank",
               "ddp_gloo_2rank_alltoall", "ddp_gloo_2rank_coclr_open",
               "ddp_gloo_2rank_finetune", "profile_loop", "seqpar_sp2",
               "seqpar_sph2_s3d", "seqpar_sp2_r50", "seqpar_sp2_coclr_open",
               "seqpar_cls_sp2", "seqpar_probe_sp2", "seqpar_cls_sph2",
               "seqpar_cls_sp2_dev", "seqpar_cls_sp2xsph2",
               "seqpar_cls_r50_sp2", "seqpar_cls_224_sph2", "cls_224")

    def launches(name):
        return {"launches": sum(p["counts"][name] for p in paths.values()),
                "launches_by_path": {k: p["counts"][name]
                                     for k, p in paths.items()},
                "launches_per_step": {k: paths[k].get("per_step",
                                                      paths[k]["counts"])[name]
                                      for k in trained},
                "ms_in_step": {k: paths[k]["in_step"][name]
                               for k in ("infonce", "coclr_open", "finetune",
                                         "probe", "r50_infonce",
                                         "r50_coclr_open", "r50_finetune")}}

    j2, j4 = jit[2048], jit[4096]
    r50 = pool["r50"]
    kernels = [
        dict(name="jitter_normalize", route="cuda",
             source="coclr_tpu_torch/csrc/jitter.cu",
             replaces="coclr_tpu/ops/pallas_aug.py:146",
             **launches("jitter"),
             max_abs_err=max(j2["max_abs_err"], j4["max_abs_err"],
                             jit["edges"]["max_abs_err"],
                             jit_eval["max_abs_err"],
                             sp["jitter"]["max_abs_err"],
                             sp["cls_jitter"]["max_abs_err"]),
             ms=j2["ms"], kernel_ms=j2["ms"], ms_planar=j2["ms_planar"],
             plain_ms=j2["plain_ms"], bound_ms=j2["bound_ms"],
             bound_by=j2["bound_by"], library_ms=None,
             shape="F=2048 frames, 3x128x128 uint8 channels-last view -> "
                   "bfloat16",
             coclr_launch=dict(
                 shape="F=4096 frames (RGB + flow), 3x128x128 uint8 "
                       "channels-last view -> bfloat16",
                 **{k: j4[k] for k in ("max_abs_err", "ms", "ms_planar",
                                       "plain_ms", "bound_ms", "bound_by")}),
             eval_launch=dict(
                 shape="F=1024 frames (32 clips x 32), 3x128x128 uint8 "
                       "channels-last view after the uint8 flip, gray off -> "
                       "bfloat16",
                 **{k: jit_eval[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by")}),
             sp_launch=dict(
                 shape="F=1024 frames (32 clips x 2 x a T chunk of 16, "
                       "--sp_size 2), 3x128x128 uint8 channels-last view, "
                       "gray on -> bfloat16",
                 library_ms=None,
                 **{k: sp["jitter"][k] for k in ("max_abs_err", "ms",
                                                 "plain_ms", "bound_ms",
                                                 "bound_by")}),
             cls_sp_launch=dict(
                 shape="F=512 frames (32 clips x a T chunk of 16, "
                       "main_classifier --sp_size 2), 3x128x128 uint8 "
                       "channels-last view after the uint8 flip, gray off -> "
                       "bfloat16",
                 library_ms=None,
                 **{k: sp["cls_jitter"][k] for k in ("max_abs_err", "ms",
                                                     "plain_ms", "bound_ms",
                                                     "bound_by")})),
        dict(name="pool1d_bwd", route="cuda",
             source="coclr_tpu_torch/csrc/pool1d_bwd.cu",
             replaces="coclr_tpu/ops/pallas_pool.py:106",
             **launches("pool1d_bwd"),
             max_abs_err=max([pool["max_abs_err"]]
                             + [v["max_abs_err"] for v in sp["pool"].values()]),
             ms=pool["ms"], kernel_ms=pool["ms"],
             plain_ms=pool["plain_ms"], bound_ms=pool["bound_ms"],
             bound_by=pool["bound_by"], library_ms=pool["library_ms"],
             library=pool["library"],
             shape="sum over the 37 launches of one full-width S3D step, bfloat16",
             r50_launch=dict(
                 shape="sum over the 2 launches of one full-width r50 / r3d50 "
                       "step (the stem pool's H and W axes), bfloat16",
                 **{k: r50[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "library", "rows")}),
             sp_launches={
                 name: dict(
                     shape=f"sum over the launches of one full-width {name} "
                           f"step at the shapes no earlier path takes "
                           f"(halo'd blocks, lo = 0, a T / H chunk, or "
                           f"img_dim 224), bfloat16, exact in bfloat16 and "
                           f"float32",
                     **{k: v[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "library", "rows",
                                          "launches_per_step")})
                 for name, v in sp["pool"].items()}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
