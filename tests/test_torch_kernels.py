"""The port's two kernels (coclr_tpu_torch/kernels) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel it replaces (interpret mode) and the
XLA paths, on the same numpy-seeded inputs and jax.random draws. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coclr_tpu.ops import augment as jaug
from coclr_tpu.ops.pallas_aug import fused_jitter_normalize as jax_jitter
from coclr_tpu.ops.pallas_pool import max_pool_1d as jax_max_pool_1d
from coclr_tpu.ops.pallas_pool import pool1d_bwd as jax_pool1d_bwd
from coclr_tpu_torch.kernels import pool as tpool
from coclr_tpu_torch.kernels.jitter import fused_jitter_normalize
from coclr_tpu_torch.ops import augment as taug


def _frames(seed, f, s1, s2):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (f, 3, s1, s2), np.uint8)
    fb, fc, fs = (rng.uniform(0.6, 1.4, f).astype(np.float32) for _ in range(3))
    fh = rng.uniform(-0.1, 0.1, f).astype(np.float32)
    fh[::4] = 0.0
    gray = rng.randint(-1, 3, f).astype(np.int32)
    perms = np.stack([rng.permutation(4) for _ in range(f)])
    orders = (perms[:, 0] | perms[:, 1] << 2 | perms[:, 2] << 4
              | perms[:, 3] << 6).astype(np.int32)
    return x, fb, fc, fs, fh, gray, orders


@pytest.mark.parametrize("s1,s2", [(16, 16), (12, 20), (9, 7)])
def test_jitter_plain_matches_pallas_kernel(s1, s2):
    """Every op, every order, hue and gray on: float32 to 1e-5 (both compute
    the same float32 chain; only the contrast mean's summation order
    differs, by float32 ULPs). Odd sizes take the one-pixel path."""
    args = _frames(0, 24, s1, s2)
    want = np.asarray(jax_jitter(*map(jnp.asarray, args),
                                 out_dtype=jnp.float32, interpret=True))
    got = fused_jitter_normalize(*map(torch.from_numpy, args),
                                 out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_jitter_null_path_exact():
    """fh = 0, gray = -1, factors = 1: bit-exact u8 / 255, normalized."""
    x = _frames(1, 6, 8, 8)[0]
    one, zero = np.ones(6, np.float32), np.zeros(6, np.float32)
    gray = -np.ones(6, np.int32)
    orders = np.full(6, 228, np.int32)
    got = fused_jitter_normalize(
        *map(torch.from_numpy, (x, one, one, one, zero, gray, orders)),
        out_dtype=torch.float32, mean=(0, 0, 0), std=(1, 1, 1)).numpy()
    np.testing.assert_array_equal(got, x.astype(np.float32) * np.float32(1 / 255))


def _jax_draws(key, aug_base, L):
    """The draws of coclr_tpu.ops.augment.augment_clips (same key split and
    streams), in the port's draw_aug_params format."""
    m = aug_base.size
    base = jnp.asarray(aug_base.reshape(m)).astype(jnp.bool_)
    (k_jitp, k_b, k_c, k_s, k_h, k_order, k_gray, k_grayc, k_blur, k_sigma,
     k_flip) = jax.random.split(key, 11)
    do_jit = base & (jax.random.uniform(k_jitp, (m,)) < 0.8)

    def factor(k, lo, hi, center):
        return jnp.where(do_jit, jax.random.uniform(k, (m,), minval=lo,
                                                    maxval=hi), center)

    out = {
        "fb": factor(k_b, 0.6, 1.4, 1.0), "fc": factor(k_c, 0.6, 1.4, 1.0),
        "fs": factor(k_s, 0.6, 1.4, 1.0), "fh": factor(k_h, -0.1, 0.1, 0.0),
        "orders": jaug.draw_orders(k_order, m, "shuffle"),
        "do_gray": base & (jax.random.uniform(k_gray, (m,)) < 0.2),
        "ch": jax.random.randint(k_grayc, (m * L,), 0, 3),
        "do_blur": base & (jax.random.uniform(k_blur, (m,)) < 0.5),
        "sigma": jax.random.uniform(k_sigma, (m,), minval=0.1, maxval=2.0),
        "do_flip": jax.random.uniform(k_flip, (m,)) < 0.5,
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _augment_both(seed, key, base, hue, backend):
    rng = np.random.RandomState(seed)
    seq = rng.randint(0, 256, (3, 2, 4, 24, 24, 3), np.uint8)
    base = np.asarray(base, np.uint8)
    strength = (0.4, 0.4, 0.4, 0.1 if hue else 0.0)
    want = np.asarray(jaug.augment_clips(
        jnp.asarray(seq), jnp.asarray(base), key, strength=strength,
        dtype=jnp.float32, backend=backend, normalize_out=True))
    params = _jax_draws(key, base, seq.shape[2])
    if not hue:
        params["fh"] = torch.zeros_like(params["fh"])
    got = taug.apply_aug(torch.from_numpy(seq), params, dtype=torch.float32)
    return got.numpy(), want, params


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_apply_aug_matches_augment_clips(backend):
    """Same jax.random draws through both packages (tests/test_augment.py
    bars): hue off, the chain is branch-free and matches to 1e-4; at full
    hue HSV branch ties on clipped pixels flip on ULPs (and the blur smears
    them), so median < 1e-4 and mean < 3e-3."""
    key = jax.random.PRNGKey(11)
    base = [[1, 1], [1, 0], [0, 1]]
    got, want, params = _augment_both(3, key, base, hue=False, backend=backend)
    assert bool(params["do_blur"].any()) and bool((params["fb"] != 1).any())
    assert np.abs(got - want).max() < 1e-4, np.abs(got - want).max()
    got, want, params = _augment_both(3, key, base, hue=True, backend=backend)
    assert bool((params["fh"] != 0).any())
    d = np.abs(got - want)
    assert np.median(d) < 1e-4 and d.mean() < 3e-3, (np.median(d), d.mean())


def test_apply_aug_null_path_matches():
    """aug_base = 0 everywhere: flip only, exact to float tolerance 1e-4."""
    got, want, _ = _augment_both(4, jax.random.PRNGKey(5), [[0, 0]] * 3,
                                 hue=True, backend="xla")
    assert np.abs(got - want).max() < 1e-4


def test_blur_matrix_and_normalize_match():
    sigma = np.asarray([0.1, 0.9, 2.0], np.float32)
    apply = np.asarray([True, True, False])
    want = np.stack([np.asarray(jaug._blur_matrix(20, s, a, jnp.float32))
                     for s, a in zip(sigma, apply)])
    got = taug._blur_matrix(20, torch.from_numpy(sigma), torch.from_numpy(apply),
                            torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    x = np.random.RandomState(2).rand(2, 5, 5, 3).astype(np.float32)
    np.testing.assert_allclose(
        taug.normalize(torch.from_numpy(x), dtype=torch.float32).numpy(),
        np.asarray(jaug.normalize(jnp.asarray(x), dtype=jnp.float32)),
        atol=1e-6)


def test_draw_aug_params_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    base = torch.tensor([[1, 1], [1, 0], [1, 1], [0, 0]], dtype=torch.uint8)
    p = taug.draw_aug_params(gen, base, 5)
    m = base.numel()
    assert p["ch"].shape == (m * 5,) and p["fb"].shape == (m,)
    null = ~base.reshape(m).bool()
    assert bool((p["fb"][null] == 1).all() and (p["fh"][null] == 0).all())
    assert not bool(p["do_gray"][null].any() or p["do_blur"][null].any())
    assert float(p["fh"].abs().max()) <= 0.1 and float(p["sigma"].min()) >= 0.1
    codes = p["orders"].numpy()
    perms = np.stack([(codes >> (2 * i)) & 3 for i in range(4)], 1)
    assert (np.sort(perms, 1) == np.arange(4)).all()


POOL_CASES = [(3, 1, 1, 16), (3, 2, 1, 16), (3, 2, 1, 13), (2, 2, 0, 16),
              (2, 2, 0, 17), (3, 2, 1, 64)]


@pytest.mark.parametrize("k,s,lo,n", POOL_CASES)
def test_pool1d_bwd_plain_matches_pallas_and_vjp(k, s, lo, n):
    """Forced post-ReLU zero ties; atol 1e-5 as tests/test_pallas_pool.py
    (float32 sums of at most ceil(k/s) window grads)."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, n, 24).astype(np.float32)
    x = np.where(x < 0.5, 0.0, x).astype(np.float32)

    def pool(y):
        return jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, k, 1),
                                     (1, s, 1), [(0, 0), (lo, lo), (0, 0)])

    out = np.array(pool(jnp.asarray(x)))
    g = rng.randn(*out.shape).astype(np.float32)
    _, vjp = jax.vjp(pool, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    pallas = np.asarray(jax_pool1d_bwd(jnp.asarray(x), jnp.asarray(out),
                                       jnp.asarray(g), k, s, lo))
    got = tpool.pool1d_bwd(*map(torch.from_numpy, (x, out, g)), k, s, lo).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    fwd = tpool.pool1d_fwd(torch.from_numpy(x), 1, k, s, lo).numpy()
    np.testing.assert_array_equal(fwd, out)


def test_max_pool_1d_autograd_matches_jax():
    """The autograd function (reshape to [P, N, Q] + kernel backward)
    through a loss, against the JAX custom VJP; atol 1e-5."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 12, 10, 5).astype(np.float32)
    g_jax = jax.grad(lambda y: jnp.sum(jnp.sin(jax_max_pool_1d(y, 2, 3, 2, 1))))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sin(tpool.max_pool_1d(xt, 2, 3, 2, 1)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_jax), atol=1e-5)


def test_wrappers_reject_bad_input():
    x = torch.zeros(2, 3, 4, 4, dtype=torch.uint8)
    p = torch.ones(2)
    with pytest.raises(TypeError):
        fused_jitter_normalize(x.float(), p, p, p, p, p.int(), p.int())
    with pytest.raises(ValueError):
        fused_jitter_normalize(x, p[:1], p, p, p, p.int(), p.int())
    with pytest.raises(ValueError):
        tpool.pool1d_bwd(torch.zeros(2, 8, 3), torch.zeros(2, 3, 3),
                         torch.zeros(2, 3, 3), 3, 2, 1)


def test_jitter_channels_last_view_matches_planar():
    """The channels-last view apply_aug passes (no planar copy) gives the
    planar call's result bit for bit, and the wrapper reads both layouts in
    place."""
    from coclr_tpu_torch.kernels.jitter import frame_layout

    args = [torch.from_numpy(a) for a in _frames(5, 6, 12, 10)]
    planar = args[0]
    cl = planar.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    assert not cl.is_contiguous()
    assert frame_layout(planar) == (360, False)
    assert frame_layout(cl) == (360, True)
    assert frame_layout(planar[:, :, ::2]) is None
    want = fused_jitter_normalize(planar, *args[1:], out_dtype=torch.float32)
    got = fused_jitter_normalize(cl, *args[1:], out_dtype=torch.float32)
    assert torch.equal(got, want)


def test_build_key_covers_source_headers_and_flags(tmp_path, monkeypatch):
    """A kernel library is keyed on its source, the local headers it
    includes and the nvcc flags, so a change to any of them rebuilds it."""
    from coclr_tpu_torch.kernels import build

    src, hdr, deep = tmp_path / "k.cu", tmp_path / "a.cuh", tmp_path / "b.cuh"
    src.write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint k;\n')
    hdr.write_text('#pragma once\n#include "b.cuh"\n')
    deep.write_text("#pragma once\n")
    assert build.local_headers(str(src)) == sorted([str(hdr), str(deep)])
    flags = list(build.NVCC_FLAGS)
    key = build.build_key(str(src), flags)
    assert key == build.build_key(str(src), flags)
    assert build.build_key(str(src), flags + ["-lineinfo"]) != key
    deep.write_text("#pragma once\nint b;\n")
    assert build.build_key(str(src), flags) != key
    kernel = build.KERNELS["pool1d_bwd"]
    before = kernel.library
    monkeypatch.setattr(build, "NVCC_FLAGS", flags + ["-DCHANGED"])
    assert kernel.library != before
    assert build.local_headers(kernel.source) == [
        os.path.join(build.CSRC, "common.cuh")]


@pytest.mark.parametrize("itemsize", [2, 4])
def test_pool_plan_tiles_fit_and_align(itemsize):
    """Every tile fits the shared-memory budget, and a tile marked for
    16-byte copies starts every run of x, out and g on 16 bytes."""
    vec = 16 // itemsize
    shapes = [(1048576, 64, 1), (32768, 64, 64), (15360, 16, 256), (300, 13, 1),
              (5, 63, 63), (3, 112, 112), (2, 120, 121), (7, 5, 3), (3, 2000, 5)]
    for p, n, q in shapes:
        for k, s, lo in [(3, 2, 1), (3, 1, 1), (2, 2, 0)]:
            m = (n + 2 * lo - k) // s + 1
            pl = tpool.plan(p, n, m, q, itemsize)
            assert 1 <= pl.pt <= p and 1 <= pl.qt <= q
            tile = pl.pt * pl.qt
            need = sum(-(-b // 16) * 16 for b in (tile * n * itemsize,
                                                 tile * m * itemsize,
                                                 tile * m * itemsize)) + tile * m
            assert need <= tpool.SLAB_BYTES
            if pl.qt < q:
                assert pl.pt == 1 and (pl.qt % vec == 0 or pl.qt < vec)
            if pl.vec:
                starts = range(0, p, pl.pt) if pl.qt == q else range(0, q, pl.qt)
                size = (n * q, m * q) if pl.qt == q else (q, q)
                assert all(a * sz % vec == 0 for a in starts for sz in size)
    with pytest.raises(ValueError):  # one column of the plane is too long
        tpool.plan(1, 9000, 9000, 1, itemsize)


def test_pool1d_bwd_plain_routes_nowhere_without_a_max_like_pallas():
    """A window whose max equals none of its taps (a NaN in x) sends its g
    nowhere, in the plain version and in the Pallas kernel."""
    x = np.zeros((1, 6, 2), np.float32)
    x[0, 2, 0] = np.nan
    out = np.zeros((1, 3, 2), np.float32)
    g = np.arange(1, 7, dtype=np.float32).reshape(1, 3, 2)
    want = np.asarray(jax_pool1d_bwd(*map(jnp.asarray, (x, out, g)), 3, 2, 1))
    got = tpool.pool1d_bwd(*map(torch.from_numpy, (x, out, g)), 3, 2, 1).numpy()
    np.testing.assert_array_equal(got, want)
