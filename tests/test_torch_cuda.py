"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor coclr_tpu, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import contextlib
import itertools
import math

import numpy as np
import pytest
import torch

from coclr_tpu_torch.kernels import jitter, pool
from coclr_tpu_torch.kernels.jitter import (fused_jitter_normalize,
                                            jitter_normalize_plain)

POOL_CASES = [(3, 1, 1, 16), (3, 2, 1, 16), (3, 2, 1, 13), (2, 2, 0, 16),
              (2, 2, 0, 17), (3, 2, 1, 64)]
# (P, N, Q, k, s, lo) for every path of the kernel (kernels/pool.py plan):
# whole planes with 16-byte staging at Q = 1, 2k, 4, 8k and not 8k, odd N;
# whole planes staged element by element (odd N * Q); planes above the
# tile budget, tiled along Q with 16-byte staging (Q = 8k) and without; and
# windows other than S3D's, which the kernel reads at run time.
POOL_PATHS = [(300, 64, 1, 3, 2, 1), (300, 13, 1, 3, 1, 1), (77, 17, 4, 2, 2, 0),
              (40, 16, 24, 3, 1, 1), (30, 15, 40, 3, 2, 1), (21, 9, 7, 2, 2, 0),
              (50, 11, 6, 3, 2, 1),
              (5, 63, 63, 3, 2, 1), (3, 112, 112, 3, 2, 1), (2, 120, 121, 3, 1, 1),
              (2, 100, 100, 2, 2, 0), (40, 10, 8, 4, 2, 1), (64, 9, 1, 2, 1, 0)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _jitter_args(frames, size, dev):
    gen = torch.Generator(dev).manual_seed(0)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(frames, device=dev,
                                                   generator=gen)
    x = torch.randint(0, 256, (frames, 3, size, size), dtype=torch.uint8,
                      device=dev, generator=gen)
    fh = u(-0.1, 0.1)
    fh[::4] = 0.0
    gray = torch.randint(-1, 3, (frames,), device=dev, generator=gen,
                         dtype=torch.int32)
    perms = torch.tensor(list(itertools.permutations(range(4))), device=dev)
    perms = perms[torch.arange(frames, device=dev) % 24]
    orders = (perms[:, 0] | perms[:, 1] << 2 | perms[:, 2] << 4
              | perms[:, 3] << 6).to(torch.int32)
    return x, u(0.6, 1.4), u(0.6, 1.4), u(0.6, 1.4), fh, gray, orders


def _channels_last(x):
    """The same frames as a [F, 3, S1, S2] view of channels-last memory."""
    return x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [112, 9, 128, 288])
def test_jitter_kernel_matches_plain(dev, size):
    """bfloat16 kernel output vs the plain float32 version cast to bfloat16:
    more than 1 bf16 ULP off on at most 1e-3 of the outputs (HSV
    branch ties). 9 x 9 frames take the one-pixel path; 288 x 288 frames
    (243 KB) do not fit shared memory and take the path that reads device
    memory twice. Channels-last input gives the planar result bit for bit."""
    args = _jitter_args(8 if size == 288 else 48, size, dev)
    got = fused_jitter_normalize(*args).float()
    want = jitter_normalize_plain(*args).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert float(((got - want).abs() > ulp).float().mean()) <= 1e-3
    got32 = fused_jitter_normalize(*args, out_dtype=torch.float32)
    want32 = jitter_normalize_plain(*args, out_dtype=torch.float32)
    assert float(((got32 - want32).abs() > 1e-5).float().mean()) <= 1e-3
    cl = (_channels_last(args[0]),) + args[1:]
    assert cl[0].stride()[1] == 1
    assert torch.equal(fused_jitter_normalize(*cl).float(), got)
    assert torch.equal(fused_jitter_normalize(*cl, out_dtype=torch.float32), got32)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [128, 9, 288])
def test_jitter_kernel_null_path_exact(dev, size):
    """Factors 1, fh 0, gray -1, identity normalize: exactly u8 / 255, from
    planar and from channels-last frames."""
    x = torch.randint(0, 256, (4, 3, size, size), dtype=torch.uint8,
                      device=dev, generator=torch.Generator(dev).manual_seed(3))
    one = torch.ones(4, device=dev)
    params = (one, one, one, one * 0, -one.to(torch.int32),
              torch.full((4,), 228, dtype=torch.int32, device=dev))
    for frames in (x, _channels_last(x)):
        got = fused_jitter_normalize(frames, *params, out_dtype=torch.float32,
                                     mean=(0, 0, 0), std=(1, 1, 1))
        assert torch.equal(got, x.float() * (1.0 / 255.0))


@pytest.mark.cuda
def test_pool_kernel_matches_plain(dev):
    """Post-ReLU zero ties and integer-valued g make the sums exact, so the
    kernel must equal the plain version bit for bit, in both dtypes."""
    gen = torch.Generator(dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for k, s, lo, n in POOL_CASES:
            x = torch.relu(torch.randn(8, n, 40, generator=gen, device=dev)
                           - 0.5).to(dtype)
            out = pool.pool1d_fwd(x, 1, k, s, lo)
            g = torch.randint(-4, 5, out.shape, generator=gen,
                              device=dev).to(dtype)
            assert torch.equal(pool.pool1d_bwd(x, out, g, k, s, lo),
                               pool.pool1d_bwd_plain(x, out, g, k, s, lo))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", POOL_PATHS)
def test_pool_kernel_paths_match_plain(dev, dtype, case):
    """Every tiling of the kernel, bit for bit against the plain version;
    and once more from x, out and g that start off 16-byte alignment."""
    p, n, q, k, s, lo = case
    gen = torch.Generator(dev).manual_seed(p * n + q)
    x = torch.relu(torch.randn(p, n, q, generator=gen, device=dev) - 0.5).to(dtype)
    out = pool.pool1d_fwd(x, 1, k, s, lo)
    g = torch.randint(-4, 5, out.shape, generator=gen, device=dev).to(dtype)
    want = pool.pool1d_bwd_plain(x, out, g, k, s, lo)
    assert torch.equal(pool.pool1d_bwd(x, out, g, k, s, lo), want)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    assert shifted(x).data_ptr() % 16 != 0
    assert torch.equal(pool.pool1d_bwd(shifted(x), shifted(out), shifted(g),
                                       k, s, lo), want)


@pytest.mark.cuda
def test_max_pool_3d_on_card_matches_cpu(dev):
    """The separable pool's autograd on the card (kernel backward) equals
    the same function on the CPU (plain backward), float32, exact."""
    x = torch.relu(torch.randn(2, 5, 8, 12, 10, generator=torch.Generator()
                               .manual_seed(1)) - 0.3)
    w = torch.randint(-3, 4, (2, 5, 4, 6, 5), generator=torch.Generator()
                      .manual_seed(2)).float()
    grads = []
    for d in ("cpu", dev):
        xd = x.detach().to(d).requires_grad_(True)
        y = pool.max_pool_3d(xd, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        (y * w.to(d)).sum().backward()
        grads.append(xd.grad.cpu())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_wrapper_counts_launches_and_rejects_bad_input(dev):
    before = pool.KERNEL.launches
    x = torch.zeros(2, 8, 3, device=dev)
    out = pool.pool1d_fwd(x, 1, 3, 2, 1)
    pool.pool1d_bwd(x, out, out, 3, 2, 1)
    assert pool.KERNEL.launches == before + 1
    with pytest.raises(TypeError):
        pool.pool1d_bwd(x.half(), out.half(), out.half(), 3, 2, 1)


@pytest.mark.cuda
def test_two_stream_preprocess_on_card_matches_cpu(dev):
    """The two-stream preprocess (one jitter launch over RGB and flow
    frames, then blur and flip) on the card against the same draws through
    the plain version on the CPU, in float32: median abs difference < 1e-5
    and mean < 1e-3 (HSV branch ties flip on ULPs and the blur smears
    them)."""
    from coclr_tpu_torch.ops.augment import augment_batch, draw_aug_params

    gen = torch.Generator().manual_seed(4)
    B, T, S = 4, 8, 32
    batch = {"seq_rgb": torch.randint(0, 256, (B, 2, T, S, S, 3), generator=gen,
                                      dtype=torch.uint8),
             "seq_flow": torch.randint(0, 256, (B, 2, T, S, S, 3), generator=gen,
                                       dtype=torch.uint8),
             "aug_base": torch.ones(B, 2, dtype=torch.uint8)}
    params = draw_aug_params(gen, batch["aug_base"], 2 * T)
    want = augment_batch(batch, params, dtype=torch.float32)
    launches = jitter.KERNEL.launches
    got = augment_batch({k: v.to(dev) for k, v in batch.items()},
                        {k: v.to(dev) for k, v in params.items()},
                        dtype=torch.float32)
    assert jitter.KERNEL.launches == launches + 1
    for name in ("seq_rgb", "seq_flow"):
        d = (got[name].cpu() - want[name]).abs()
        assert float(d.median()) < 1e-5 and float(d.mean()) < 1e-3, name


def _coclr_s3d(dtype, dim, K):
    """A CoCLR MoCo of S3D whose backbone convs (encoder_q, encoder_k and the
    sampler) are redrawn He-scaled from a seed, so that the eval-mode
    sampler's features differ from clip to clip; the queue is full."""
    from coclr_tpu_torch.models import moco

    model = moco.MoCo("s3d", dim, K, dtype, gen=torch.Generator().manual_seed(0),
                      variant="coclr")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for enc in (model.encoder_q, model.sampler):
            for mod in enc[0].modules():
                if isinstance(mod, torch.nn.Conv3d):
                    mod.weight.normal_(0.0, (2.0 / mod.weight[0].numel()) ** 0.5,
                                       generator=gen)
        model.encoder_k.load_state_dict(model.encoder_q.state_dict())
        model.queue_label.fill_(1)
        model.queue_vname.copy_(torch.arange(K) % 6)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coclr_step_with_full_queue_on_card_matches_cpu(dev, dtype):
    """One CoCLR step of S3D (full queue: sibling masking, top-k mining, the
    self-drop, Adam) on the card in `dtype` through the pool kernel (37
    launches), against the same step in float32 on the CPU through the
    plain versions, and against the card with the plain pool backward
    (cuDNN deterministic): the kernel's step equals that one bit for bit.
    The CPU runs float32 in both cases: a bfloat16 step on the CPU of one
    card machine gave NaN in some encoder_q elements.

    Against the CPU, the mined mask is equal (the top-k's margins, checked
    on the CPU, are at least 2e-2) and Adam's first step moves each encoder_q
    element by at most lr, so none differs by more than 2 lr. float32 (TF32
    off): loss rtol 1e-4, queue rows atol 1e-4, queue_second atol 1e-5, and
    encoder_q's whole gradient rtol 0.1 in norm: a randomly initialised S3D
    with batch-statistics BN at B = 4 turns rounding into max-pool and ReLU
    ties that move it (an input scaled by 1 + 1e-7 moves it 1.8 % on the
    CPU). bfloat16: the same amplification moves the pooled features by
    about 40 % (bfloat16 against float32 on the CPU) and the loss by about a
    third, so only queue_second, the eval-mode sampler's features, is held
    to the CPU, at atol 2e-2, and the loss is checked finite."""
    from coclr_tpu_torch.config import PretrainConfig
    from coclr_tpu_torch.models import moco
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step

    lr, K, B, T, S, D = 1e-3, 64, 4, 8, 64, 16
    cfg = PretrainConfig(net="s3d", model="coclr", moco_k=K, moco_dim=D,
                         topk=3, lr=lr)
    gen = torch.Generator().manual_seed(5)
    clip = lambda: (torch.randn(B, 2, T, S, S, 3, generator=gen)
                    * (0.2 + 2.8 * torch.rand(B, 1, 1, 1, 1, 1, generator=gen))
                    + 2 * torch.randn(B, 1, 1, 1, 1, 3, generator=gen))
    batch = {"seq_rgb": clip(), "seq_flow": clip(),
             "vname": torch.tensor([0, 1, 2, 1], dtype=torch.int32)}
    second = moco.l2_normalize(torch.randn(K, D, generator=gen))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    kernel_bwd = pool.pool1d_bwd
    runs = {}
    try:
        for name, d in (("cpu", "cpu"), ("card", dev), ("card-plain", dev)):
            model = _coclr_s3d(torch.float32 if name == "cpu" else dtype,
                               D, K).to(d).train()
            model.queue_second.copy_(second)
            opt = make_optimizer(cfg, model.encoder_q.parameters())
            b = {k: v.to(d) for k, v in batch.items()}
            with torch.no_grad():
                kf = moco.l2_normalize(model.sampler(
                    b["seq_flow"][:, 1].permute(0, 4, 1, 2, 3)).float())
                sim = (kf @ model.queue_second.t()).masked_fill(
                    b["vname"][:, None].long() == model.queue_vname[None],
                    moco.NEG_INF)
                mask = moco.coclr_mask(kf, b["vname"], model.queue_second,
                                       model.queue_vname, model.queue_label,
                                       cfg.topk)
            if name == "card-plain":
                pool.pool1d_bwd = pool.pool1d_bwd_plain
            launches = pool.KERNEL.launches
            m = pretrain_step(model, opt, b, lr, cfg, drop_self=True, update=True)
            pool.pool1d_bwd = kernel_bwd
            assert pool.KERNEL.launches - launches == (37 if name == "card" else 0)
            grad = torch.cat([p.grad.float().flatten().cpu()
                              for p in model.encoder_q.parameters()])
            runs[name] = (float(m["loss"]), mask.cpu(), sim.sort(1).values.cpu(),
                          {k: v.detach().cpu().float()
                           for k, v in model.state_dict().items()}, grad)
    finally:
        pool.pool1d_bwd = kernel_bwd
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags

    (l0, m0, sim0, s0, g0), (l1, m1, _, s1, g1) = runs["cpu"], runs["card"]
    assert runs["card"][0] == runs["card-plain"][0]
    assert torch.equal(g1, runs["card-plain"][4])
    for key, val in s1.items():
        assert torch.equal(val, runs["card-plain"][3][key]), key
    k = cfg.topk
    assert float((sim0[:, -k] - sim0[:, -k - 1]).min()) >= 2e-2
    assert torch.equal(m0, m1) and int(m0[:, 1:].sum()) > B * k
    f32 = dtype == torch.float32
    assert math.isfinite(l1) and (not f32 or abs(l0 - l1) <= 1e-4 * abs(l0))
    assert float((s1["queue_second"] - s0["queue_second"]).abs().max()) \
        <= (1e-5 if f32 else 2e-2)
    if f32:
        assert float((s1["queue"] - s0["queue"]).abs().max()) <= 1e-4
        assert float((g1 - g0).norm()) <= 0.1 * float(g0.norm())
    for key, val in s0.items():
        if key.startswith("encoder_q.") and "running" not in key \
                and "num_batches" not in key:
            assert float((s1[key] - val).abs().max()) <= 2 * lr + 1e-6, key


@pytest.mark.cuda
def test_eval_preprocess_on_card_matches_cpu(dev):
    """The classifier train preprocess (uint8 flip, then one jitter launch
    with gray off over a channels-last view) on the card against the plain
    version on the CPU, on the same draws with every clip's jitter on:
    float32 median abs difference < 1e-5 and mean < 1e-3 (HSV branch ties
    flip on ULPs); bfloat16 more than 1 bf16 ULP off on at most 1e-3 of the
    outputs."""
    from coclr_tpu_torch.evalsuite import steps

    gen = torch.Generator().manual_seed(6)
    seq = torch.randint(0, 256, (8, 4, 32, 32, 3), generator=gen,
                        dtype=torch.uint8)
    draws = steps.draw_eval_jitter_params(
        gen, 8, p=1.0, strength=steps.TRAIN_JITTER["strength"])
    draws["do_flip"] = torch.arange(8) % 2 == 0
    on_card = {k: v.to(dev) for k, v in draws.items()}
    for dtype in (torch.float32, torch.bfloat16):
        want = steps.apply_train_preprocess(seq, draws, dtype).float()
        launches = jitter.KERNEL.launches
        got = steps.apply_train_preprocess(seq.to(dev), on_card, dtype)
        assert jitter.KERNEL.launches == launches + 1
        d = (got.float().cpu() - want).abs()
        if dtype == torch.float32:
            assert float(d.median()) < 1e-5 and float(d.mean()) < 1e-3
        else:
            ulp = torch.exp2(torch.floor(torch.log2(
                want.abs().clamp_min(1e-30))) - 7)
            assert float((d > ulp).float().mean()) <= 1e-3


def _classifier_step(d, dtype, train_what, seed=0):
    """One SGD step of a small S3D classifier (He-scaled convs, the
    reference's N(0, 0.01) head, dropout 0) on `d`; returns (loss, launches
    of each kernel, the head's weight gradient on the CPU)."""
    from coclr_tpu_torch.config import EvalConfig
    from coclr_tpu_torch.evalsuite import driver, steps

    cfg = EvalConfig(net="s3d", seq_len=8, img_dim=32, train_what=train_what,
                     optim="sgd", lr=0.01, dropout=0.0, compute_dtype=dtype)
    model = driver.build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv3d):
                mod.weight.normal_(0.0, (2.0 / mod.weight[0].numel()) ** 0.5,
                                   generator=gen)
    model.to(d)
    opt = steps.make_classifier_optimizer(cfg, model)
    seq = torch.randint(0, 256, (4, 8, 32, 32, 3), generator=gen,
                        dtype=torch.uint8)
    label = torch.randint(0, 101, (4,), generator=gen)
    draws = steps.draw_train_preprocess(gen, 4)
    before = (jitter.KERNEL.launches, pool.KERNEL.launches)
    x = steps.apply_train_preprocess(seq.to(d), {k: v.to(d) for k, v in
                                                 draws.items()}, cfg.dtype)
    m = steps.train_step(model, opt, x, label.to(d), cfg.lr)
    return (float(m["loss"]), (jitter.KERNEL.launches - before[0],
                               pool.KERNEL.launches - before[1]),
            model.final_fc.weight.grad.float().cpu())


@pytest.mark.cuda
def test_finetune_step_on_card_matches_cpu(dev):
    """One `ft` step of a small S3D classifier on the card (both kernels)
    against the same step in float32 on the CPU (plain versions), TF32 off
    and cuDNN deterministic: float32 loss within rtol 1e-4 and the head's
    gradient within 1e-2 of its norm; a bfloat16 step on the card beside
    it gives a finite loss. The float32 forward of a randomly initialised
    S3D with batch-statistics BN at B = 4 differs between the card and the
    CPU even on the same input, and an N(0, 1) head (large logits) turns
    that into more than 1e-4 of the loss, so the head keeps the
    reference's N(0, 0.01) init."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cpu_loss, _, cpu_grad = _classifier_step("cpu", "float32", "ft")
        card_loss, launches, card_grad = _classifier_step(dev, "float32", "ft")
        bf16_loss, _, _ = _classifier_step(dev, "bfloat16", "ft")
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags
    assert launches == (1, 37)
    assert abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    assert float((card_grad - cpu_grad).norm()) <= 1e-2 * float(cpu_grad.norm())
    assert math.isfinite(bf16_loss)


@pytest.mark.cuda
@pytest.mark.parametrize("train_what,launches", [("ft", (1, 37)),
                                                 ("last", (1, 0))])
def test_classifier_step_launch_counts(dev, train_what, launches):
    """A classifier step launches the jitter kernel once, and the pool
    backward 37 times for `ft` and never for `last` (no backward runs
    through the frozen backbone)."""
    loss, got, _ = _classifier_step(dev, "bfloat16", train_what)
    assert got == launches and math.isfinite(loss)


@pytest.mark.cuda
def test_two_gloo_ranks_on_card_match_two_ranks_on_cpu(dev, tmp_path):
    """One InfoNCE step of S3D on float clips as two gloo ranks sharing the
    card (tests/torch_ddp_ranks.py; each rank launches the pool kernel 37
    times), against the same two ranks on the CPU through the plain
    versions, in float32 with TF32 off, 4 clips a rank: the ranks'
    parameters and queues are bit-identical on the card, and against the
    CPU the tolerances of the CoCLR step above hold: loss rtol 1e-4, queue
    rows atol 1e-4, and each encoder_q element within 2 lr (Adam's first
    step moves it by at most lr)."""
    from torch_ddp_ranks import RankPool

    lr, K, B, T, S, D = 1e-3, 64, 4, 8, 64, 16
    sd = {k: v.numpy().copy() for k, v in _coclr_s3d(
        torch.float32, D, K).state_dict().items()
          if not k.startswith(("sampler.", "queue_second", "queue_vname",
                               "queue_label"))}
    gen = torch.Generator().manual_seed(6)
    seq = (torch.randn(2 * B, 2, T, S, S, 3, generator=gen)
           * (0.2 + 2.8 * torch.rand(2 * B, 1, 1, 1, 1, 1, generator=gen)))
    case = dict(variant="infonce", sd=sd, lr=lr,
                cfg=dict(net="s3d", moco_k=K, moco_dim=D, lr=lr,
                         compute_dtype="float32"),
                batches=[{"seq": seq.numpy()}],
                perms=[torch.randperm(2 * B, generator=gen).numpy()],
                drops=[[True, True]])
    pool = RankPool(2, str(tmp_path))
    try:
        cpu = pool.run("pretrain", dict(case, device="cpu"))
        card = pool.run("pretrain", dict(case, device=str(dev)))
    finally:
        pool.close()
    assert [r["launches"] for r in card] == [37, 37]
    assert [r["launches"] for r in cpu] == [0, 0]
    s0, s1, c0 = card[0]["states"][0], card[1]["states"][0], cpu[0]["states"][0]
    for key, val in s0.items():
        if "running" not in key and "num_batches" not in key:
            assert np.array_equal(val, s1[key]), key
            assert np.array_equal(c0[key], cpu[1]["states"][0][key]), key
    l_card, l_cpu = card[0]["metrics"][0]["loss"], cpu[0]["metrics"][0]["loss"]
    assert math.isfinite(l_card) and abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    assert float(np.abs(s0["queue"] - c0["queue"]).max()) <= 1e-4
    assert int(s0["queue_ptr"][0]) == 2 * B
    for key, val in c0.items():
        if key.startswith("encoder_q.") and "running" not in key \
                and "num_batches" not in key:
            assert float(np.abs(s0[key] - val).max()) <= 2 * lr + 1e-6, key


def condition_resnet_(backbone, seed=0):
    """Well-conditioned random ResNet-2d3d weights in place: He-scaled convs,
    BN affine and running statistics perturbed, and the residual branch's
    bn3 scaled down so that 16 residual sums stay O(1) and no channel of
    the train-mode BatchNorm is near constant over a small batch."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in backbone.named_modules():
            if isinstance(mod, torch.nn.Conv3d):
                mod.weight.normal_(0.0, (2.0 / mod.weight[0].numel()) ** 0.5,
                                   generator=g)
            elif isinstance(mod, torch.nn.BatchNorm3d):
                lo, hi = (0.1, 0.3) if name.endswith("bn3") else (0.8, 1.2)
                mod.weight.uniform_(lo, hi, generator=g)
                mod.bias.uniform_(-0.1, 0.1, generator=g)
                mod.running_mean.uniform_(-0.1, 0.1, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
    return backbone


@contextlib.contextmanager
def _deterministic_float32():
    """TF32 off and cuDNN deterministic inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["r50", "r3d50"])
def test_resnet_on_card_matches_cpu(dev, net):
    """ResNet-2d3d at full depth, B = 2, T = 8, S = 32, float32 with TF32
    off: the eval-mode forward on the card (cuDNN) against the CPU to 1e-4
    of the largest output, and the input gradient of sum(sin(y)) (the
    stem pool's backward: two pool kernel launches, H then W) to 1e-3 of
    the largest; a bfloat16 forward and backward on the card stays finite
    and launches the kernel twice as well."""
    from coclr_tpu_torch.backbones import select_backbone

    src = condition_resnet_(select_backbone(net, dtype=torch.float32)[0]).eval()
    x = torch.rand(2, 3, 8, 32, 32, generator=torch.Generator().manual_seed(1))
    out = {}
    with _deterministic_float32():
        for d in ("cpu", dev):
            model = src.to(d)
            xd = x.detach().to(d).requires_grad_(True)  # x stays a plain input
            before = pool.KERNEL.launches
            y = model(xd)
            torch.sin(y).sum().backward()
            out[str(d)] = (y.detach().cpu(), xd.grad.cpu(),
                           pool.KERNEL.launches - before)
    (y0, g0, n0), (y1, g1, n1) = out["cpu"], out[str(dev)]
    assert (n0, n1) == (0, 2)
    assert float((y1 - y0).abs().max()) <= 1e-4 * float(y0.abs().max())
    assert float((g1 - g0).abs().max()) <= 1e-3 * float(g0.abs().max())

    bf16 = select_backbone(net, dtype=torch.bfloat16)[0]
    bf16.load_state_dict(src.state_dict())
    bf16.to(dev).train()
    xd = x.to(dev).requires_grad_(True)
    before = pool.KERNEL.launches
    bf16(xd).float().sum().backward()
    assert pool.KERNEL.launches - before == 2
    assert bool(torch.isfinite(xd.grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pool_kernel_at_the_r50_stem_shapes(dev, dtype):
    """The two launches of the r50 / r3d50 stem pool's backward at the full
    width of one step (batch 32, seq_len 32, img_dim 128: the stem gives
    [32, 64, 16, 64, 64]): the H pool on [32768, 64, 64] and the W pool on
    [1048576, 64, 1], window 3, stride 2, pad 1, post-ReLU zero ties and
    integer-valued g, bit for bit against the plain version."""
    gen = torch.Generator(dev).manual_seed(7)
    for p, n, q in ((32768, 64, 64), (1048576, 64, 1)):
        x = torch.relu(torch.randn(p, n, q, generator=gen, device=dev)
                       - 0.5).to(dtype)
        out = pool.pool1d_fwd(x, 1, 3, 2, 1)
        g = torch.randint(-4, 5, out.shape, generator=gen, device=dev).to(dtype)
        assert torch.equal(pool.pool1d_bwd(x, out, g, 3, 2, 1),
                           pool.pool1d_bwd_plain(x, out, g, 3, 2, 1))
        del x, out, g
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_alltoall_two_gloo_ranks_on_card_match_cpu(dev, tmp_path):
    """One r50 InfoNCE step with --bn_shuffle alltoall as two gloo ranks
    sharing the card (all_to_all_single over gloo on CUDA tensors; each
    rank launches the pool kernel twice), against the same two ranks on
    the CPU, float32 with TF32 off, 4 clips a rank, each rank's pair of
    local permutations given: the ranks' parameters and queues are
    bit-identical on the card, and against the CPU the loss within rtol
    1e-4, the queue rows within 1e-4 and each encoder_q element within
    2 lr (Adam's first step moves it by at most lr)."""
    from coclr_tpu_torch.models.moco import MoCo, l2_normalize
    from torch_ddp_ranks import RankPool

    lr, K, B, T, S, D = 1e-3, 16, 4, 8, 32, 8
    model = MoCo("r50", D, K, torch.float32)
    condition_resnet_(model.encoder_q[0])
    model.encoder_k.load_state_dict(model.encoder_q.state_dict())
    gen = torch.Generator().manual_seed(6)
    model.eval()
    with torch.no_grad():  # negatives near the positive: the loss moves
        model.queue.copy_(l2_normalize(model.encoder_k(
            torch.randn(K, 3, T, S, S, generator=gen))))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    seq = torch.randn(2 * B, 2, T, S, S, 3, generator=gen)
    pairs = [[torch.randperm(B, generator=gen).numpy() for _ in range(2)]
             for _ in range(2)]
    case = dict(variant="infonce", sd=sd, lr=lr,
                cfg=dict(net="r50", moco_k=K, moco_dim=D, lr=lr,
                         compute_dtype="float32", bn_shuffle="alltoall"),
                batches=[{"seq": seq.numpy()}], perms=[pairs],
                drops=[[True, True]])
    ranks = RankPool(2, str(tmp_path))
    try:  # the rank processes turn TF32 off themselves (prepare_run)
        cpu = ranks.run("pretrain", dict(case, device="cpu"))
        card = ranks.run("pretrain", dict(case, device=str(dev)))
    finally:
        ranks.close()
    assert [r["launches"] for r in card] == [2, 2]
    assert [r["launches"] for r in cpu] == [0, 0]
    s0, s1, c0 = card[0]["states"][0], card[1]["states"][0], cpu[0]["states"][0]
    for key, val in s0.items():
        if "running" not in key and "num_batches" not in key:
            assert np.array_equal(val, s1[key]), key
    l_card, l_cpu = card[0]["metrics"][0]["loss"], cpu[0]["metrics"][0]["loss"]
    assert math.isfinite(l_card) and abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    assert float(np.abs(s0["queue"] - c0["queue"]).max()) <= 1e-4
    for key, val in c0.items():
        if key.startswith("encoder_q.") and "running" not in key \
                and "num_batches" not in key:
            assert float(np.abs(s0[key] - val).max()) <= 2 * lr + 1e-6, key
