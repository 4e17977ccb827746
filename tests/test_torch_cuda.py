"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither jax nor coclr_tpu, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import itertools

import pytest
import torch

from coclr_tpu_torch.kernels import pool
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
