"""Sequence parallelism in the port (coclr_tpu_torch/ops/seqpar.py and its
call sites) on the CPU.

One pool of 4 gloo rank processes (tests/torch_ddp_ranks.py, torch only)
serves the module; its groups take the (data, sp, sph) grids (2, 2, 1),
(2, 1, 2) and (1, 2, 2) in turn (parallel/dist.py with_seqpar). Every data
shard of a grid gets the same inputs unless a test says otherwise. The JAX
side runs here on conftest's virtual CPU devices, under shard_map on the
matching mesh.

Held directly against the JAX package: the primitives (exact; 1e-6 where a
sum is taken), the tiny encoder in train mode at sp 2, sph 2 and sp 2 x
sph 2 (outputs and BatchNorm statistics 1e-5, the member-mean gradients
1e-4: tests/test_seqpar.py's bars), the preprocess on a T chunk, the
InfoNCE step over (data 2 x sp 2) and a CoCLR step at sp 2 x sph 2.
Transitively, the port's sharded program against the port's unsharded one
(which tests/test_torch_model.py and tests/test_torch_resnet.py hold
against JAX; the JAX S3D and ResNet programs cost far more than 15 s to
compile here, and their float32 gradients sit 6e-3 to 4e-2 from their own
float64 ones): S3D-G in eval mode at sp 2, the S3D late gather at hw 48 /
sph 2 in train mode, ResNet-2d3d at sp 2 and its late gather at hw 48 /
sph 2.
"""

import functools
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from coclr_tpu.config import PretrainConfig as JaxConfig
from coclr_tpu.models import moco as jmoco
from coclr_tpu.models.encoder import ProjectionEncoder as JaxEncoder
from coclr_tpu.ops import augment as jaug
from coclr_tpu.ops import seqpar as jsp
from coclr_tpu.parallel import make_mesh
from coclr_tpu.parallel.mesh import shard_map_fn, sp_axis_of
from coclr_tpu.parallel.train_step import make_pretrain_step
from coclr_tpu_torch.config import PretrainConfig
from coclr_tpu_torch.models.encoder import ProjectionEncoder, init_params_
from coclr_tpu_torch.ops import augment as taug
from coclr_tpu_torch.parallel import dist as pdist
from coclr_tpu_torch.utils.checkpoint import load_checkpoint
from coclr_tpu_torch.utils.interop import (encoder_state_dict_from_jax,
                                           state_dict_from_jax)
from test_torch_cuda import condition_resnet_
from test_torch_ddp import (_assert_params, _first_moments, _free_port,
                            synth)  # noqa: F401 (synth is a fixture)
from test_torch_kernels import _jax_draws as _jax_aug_draws
from torch_ddp_ranks import RankPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, K, DIM = 1e-3, 16, 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("sp_ranks")))
    yield pool
    pool.close()


def ncdhw(x):
    return np.ascontiguousarray(np.moveaxis(x, -1, 1))


def _shard0(sp, sph, **kw):
    """The sp_encoder task's arguments for the 4 ranks of a (data, sp, sph)
    grid: the inputs go to data shard 0's members only (the others return
    at once)."""
    return [dict(kw, sp=sp, sph=sph) if r < sp * sph else
            dict(kw, sp=sp, sph=sph, sd=None, x=None) for r in range(4)]


def _spec(sp, sph):
    """The JAX mesh of a (1, sp, sph) grid and its sequence-parallel axes."""
    mesh = make_mesh(sp * sph, sp_size=sp, sph_size=sph)
    return mesh, jsp.sp_axes(sp_axis_of(mesh))


@pytest.mark.parametrize("name", ["temporal_halo", "spatial_halo", "gather_h",
                                  "sp_pmean"])
def test_primitive_matches_jax_shard_map(ranks, name):
    """Each primitive at sp 2 x sph 2 on [B 2, C 3, T 8, H 6, W 5] float32
    (a (2, 1) halo, so both edges and the zero-filled global edges show),
    forward and backward of sum(y * ct) with a different cotangent on every
    member: the halos' and the gather's outputs exactly, sp_pmean's and the
    input gradients to 1e-6 (sums over the members, taken in another
    order). The JAX side is the package's
    _halo / gather_h / sp_pmean under shard_map on the (sp 2, sph 2)
    mesh."""
    lo, hi = 2, 1
    mesh, axes = _spec(2, 2)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 6, 5, 3).astype(np.float32)  # NDHWC
    fns = {"temporal_halo": lambda a: jsp.temporal_halo(a, lo, hi, axes.t),
           "spatial_halo": lambda a: jsp.spatial_halo(a, lo, hi, axes.h),
           "gather_h": lambda a: jsp.gather_h(a, axes.h),
           "sp_pmean": lambda a: jsp.sp_pmean(a, axes)}
    spec = P(None, axes.t, axes.h)
    fn = fns[name]
    out_shape = jax.eval_shape(shard_map_fn(fn, mesh, in_specs=spec,
                                            out_specs=spec), x).shape
    ct = rng.randn(*out_shape).astype(np.float32)

    def member(a, c):
        y = fn(a)
        return y, jax.grad(lambda a: jnp.sum(fn(a) * c))(a)

    y, dx = jax.device_get(jax.jit(shard_map_fn(
        member, mesh, in_specs=(spec, spec), out_specs=(spec, spec)))(x, ct))
    out = ranks.run("sp_prims", dict(sp=2, sph=2, x=ncdhw(x),
                                     cts={name: ncdhw(ct)}, lo=lo, hi=hi))
    got_y = np.concatenate([np.concatenate([out[t * 2 + h][name][0]
                                            for h in range(2)], axis=3)
                            for t in range(2)], axis=2)
    got_dx = np.concatenate([np.concatenate([out[t * 2 + h][name][1]
                                             for h in range(2)], axis=3)
                             for t in range(2)], axis=2)
    if name == "sp_pmean":  # a sum over the members, in another order
        np.testing.assert_allclose(got_y, ncdhw(np.asarray(y)), atol=1e-6,
                                   rtol=0)
    else:
        np.testing.assert_array_equal(got_y, ncdhw(np.asarray(y)))
    np.testing.assert_allclose(got_dx, ncdhw(np.asarray(dx)), atol=1e-6,
                               rtol=0)


@functools.lru_cache(maxsize=1)
def _tiny_inputs():
    """The tiny encoder tests' input [2, 8, 8, 8, 3] and JAX variables."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 8, 8, 8, 3)))
    ref = JaxEncoder(network="tiny", dim=DIM, dtype=jnp.float32)
    return x, jax.jit(ref.init)(jax.random.PRNGKey(0), x[:1])


@pytest.mark.parametrize("sp,sph", [(2, 1), (1, 2), (2, 2)],
                         ids=["sp2", "sph2", "sp2xsph2"])
def test_tiny_encoder_train_matches_jax(ranks, sp, sph):
    """The tiny encoder (dim 8) in train mode on [2, 8, 8, 8, 3] float32 at
    sp 2, sph 2 and sp 2 x sph 2, against the JAX encoder under shard_map
    on the same mesh (tests/test_seqpar.py _encoder_equiv): the projected
    output and the BatchNorm running statistics after the forward to 1e-5,
    the gradients of sum(out ** 2) averaged over the members (the JAX
    member's pmean over the sp axes) to 1e-4, on every member of data
    shard 0."""
    mesh, axes = _spec(sp, sph)
    x, variables = _tiny_inputs()
    enc = JaxEncoder(network="tiny", dim=DIM, dtype=jnp.float32, sp_axis=axes)
    names = jsp.sp_names(axes)

    def member(params, stats, x):
        def loss(params):
            out, mut = enc.apply({"params": params, "batch_stats": stats}, x,
                                 train=True, mutable=["batch_stats"])
            return jnp.sum(out ** 2), (out, mut["batch_stats"])
        (_, (out, new)), g = jax.value_and_grad(loss, has_aux=True)(params)
        g = jax.tree_util.tree_map(lambda a: jax.lax.pmean(a, names), g)
        return out, new, g

    out, stats, grads = jax.device_get(jax.jit(shard_map_fn(
        member, mesh, in_specs=(P(), P(), P(None, axes.t, axes.h)),
        out_specs=(P(), P(), P())))(variables["params"],
                                    variables["batch_stats"], x))
    sd = {k: v.numpy() for k, v in encoder_state_dict_from_jax(
        *jax.device_get((variables["params"], variables["batch_stats"])))
        .items()}
    got = ranks.run("sp_encoder", _shard0(sp, sph, net="tiny", sd=sd,
                                          x=ncdhw(x), train=True, dim=DIM))
    want_state = encoder_state_dict_from_jax(variables["params"], stats)
    want_grads = encoder_state_dict_from_jax(grads, {})
    got = got[:sp * sph]  # data shard 0
    for g in got:
        np.testing.assert_allclose(g["out"], out, rtol=1e-5, atol=1e-5)
        for key, val in want_state.items():
            if "running" in key:
                np.testing.assert_allclose(g["state"][key], val.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=key)
    assert set(got[0]["grads"]) <= set(want_grads)
    for key, val in got[0]["grads"].items():
        np.testing.assert_allclose(val, want_grads[key].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def _port_unsharded(net, sd, x, train):
    """The port's unsharded encoder on x [B, C, T, H, W]: output, state
    after the forward, gradients of sum(out ** 2) and the input gradient.
    On one thread, as the ranks run: oneDNN's convolution backward sums in
    another order on several, which moves r50's stem weight gradient by up
    to 3e-4 of its largest element, more than the sharding does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        enc = ProjectionEncoder(net, DIM, torch.float32)
        enc.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        enc.train(train)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = enc(xt)
        (out ** 2).sum().backward()
    finally:
        torch.set_num_threads(threads)
    return {"out": out.detach().numpy(),
            "state": {k: v.numpy() for k, v in enc.state_dict().items()},
            "grads": {n: p.grad.numpy() for n, p in enc.named_parameters()},
            "dx": xt.grad.numpy()}


def _assert_like_unsharded(ranks, net, sp, sph, shape, train, tol):
    """The port's encoder `net` (dim 8, float32) at (sp, sph) on an input of
    `shape` against the port's unsharded one: the output and the running
    statistics to `tol`, each member-mean gradient and the input gradient
    (each member's chunk is sp x sph x its share, the loss being counted
    once per member) to 1e-4 of the tensor's largest element. Eval mode
    takes conditioned random weights (condition_resnet_: outputs and
    gradients O(1)); train mode the reference's initializers, the regime
    of the JAX package's train-mode test (its BatchNorms over a few
    elements amplify float32 rounding, more so at larger weights)."""
    enc = ProjectionEncoder(net, DIM, torch.float32)
    if train:
        init_params_(enc, torch.Generator().manual_seed(0))
    else:
        condition_resnet_(enc[0])
    sd = {k: v.numpy().copy() for k, v in enc.state_dict().items()}
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = _port_unsharded(net, sd, x, train)
    got = ranks.run("sp_encoder", _shard0(sp, sph, net=net, sd=sd, x=x,
                                          train=train, dim=DIM))[:sp * sph]
    np.testing.assert_allclose(got[0]["out"], want["out"], rtol=tol, atol=tol)
    for key, val in want["state"].items():
        if "running" in key:
            np.testing.assert_allclose(got[0]["state"][key], val, rtol=tol,
                                       atol=tol, err_msg=key)
    for g in got:
        assert np.array_equal(g["out"], got[0]["out"])
    for key, val in want["grads"].items():
        np.testing.assert_allclose(got[0]["grads"][key], val, rtol=0,
                                   atol=1e-4 * np.abs(val).max(), err_msg=key)
    t_n, h_n = shape[2] // sp, shape[3] // sph
    for r, g in enumerate(got):
        t, h = r // sph % sp, r % sph
        part = want["dx"][:, :, t * t_n:(t + 1) * t_n, h * h_n:(h + 1) * h_n]
        np.testing.assert_allclose(g["dx"] / (sp * sph), part, rtol=0,
                                   atol=1e-4 * np.abs(want["dx"]).max())


def test_s3dg_eval_sp2_matches_unsharded(ranks):
    """S3D-G in eval mode, b 1, t 16, hw 32, sp 2 (tests/test_seqpar.py's
    S3D case): every temporal halo, the unpadded convs and the stride-2
    pools on halo'd blocks (kernel 2's plain version at N = T_loc + 2,
    lo = 0), the gating means' sp_pmean; output 1e-5, gradients 1e-4.
    MaxPool_4a's T pool takes N = 5 + 1 ... at this size: T_loc 8 -> 4
    after the stem, halo'd to 6."""
    _assert_like_unsharded(ranks, "s3dg", 2, 1, (1, 3, 16, 32, 32), False,
                           1e-5)


def test_s3d_late_gather_train_sph2_matches_unsharded(ranks):
    """S3D in train mode at hw 48, sph 2 (tests/test_spatialpar.py
    test_sph_late_gather_s3d_train_48): the local H runs 24 -> 12 -> 6 -> 3,
    odd, so H is gathered before MaxPool_4a and blocks 4-5 run replicated;
    BatchNorm statistics synced over sph before the gather, local after;
    tol 5e-5 (that test's: the statistics' float32 sums re-associate)."""
    _assert_like_unsharded(ranks, "s3d", 1, 2, (1, 3, 8, 48, 48), True, 5e-5)


@pytest.mark.parametrize("sp,sph,hw", [(2, 1, 16), (1, 2, 48)],
                         ids=["sp2-hw16", "sph2-hw48-late-gather"])
def test_r50_eval_matches_unsharded(ranks, sp, sph, hw):
    """ResNet-2d3d (r50) in eval mode, b 1, t 4: at sp 2 / hw 16 the halo'd
    stride-2 stem (T pad 2 on a local T of 2) and the 3D blocks' (3,1,1)
    conv1 (a halo of 1 on a local T of 1); at sph 2 / hw 48 the H halos of
    the stem, the stem pool and every conv2, and the gather before layer 3
    (local H 24 -> 12 -> 6 -> 3). Output 1e-5, gradients 1e-4."""
    _assert_like_unsharded(ranks, "r50", sp, sph, (1, 3, 4, hw, hw), False,
                           1e-5)


def _fired_key(base, L):
    """A key whose draws apply every op of the augmentation: jitter, hue,
    gray, blur and flip."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        d = _jax_aug_draws(key, base, L)
        if (bool((d["fb"] != 1).any()) and bool((d["fh"] != 0).any())
                and bool(d["do_gray"].any()) and bool(d["do_blur"].any())
                and bool(d["do_flip"].any()) and bool((~d["do_flip"]).any())):
            return key, d
    raise AssertionError("no key fires every op")


@pytest.mark.parametrize("stream", ["single", "two-stream"])
def test_chunked_preprocess_matches_jax(stream, monkeypatch):
    """The preprocess on each T chunk at sp 2 (T 8 -> 4) against the JAX
    package's make_pretrain_preprocess with sp_ctx (augment_clips'
    frame_ctx) on the same chunk, JAX's draws fed to the port
    (draw_aug_params replaced by them, asked for the whole clip's frames:
    8, or 16 for RGB + flow, whose local frames are not contiguous in the
    doubled stream); a key that fires every op, gray included. The bars of
    tests/test_torch_kernels.py (hue on: median < 1e-4, mean < 3e-3). The
    port's chunks, put together, equal its unsharded preprocess exactly."""
    T, S, sp = 8, 16, 2
    rng = np.random.RandomState(3)
    clips = lambda: rng.randint(0, 256, (2, 2, T, S, S, 3), np.uint8)
    base = np.ones((2, 2), np.uint8)
    base[1, 0] = 0
    batch = ({"seq": clips()} if stream == "single" else
             {"seq_rgb": clips(), "seq_flow": clips()})
    batch["aug_base"] = base
    frames = T if stream == "single" else 2 * T
    key, draws = _fired_key(base, frames)
    asked = []

    def jax_draws(gen, aug_base, L):
        asked.append(L)
        return dict(draws)

    monkeypatch.setattr(taug, "draw_aug_params", jax_draws)
    jfn = jaug.make_pretrain_preprocess(JaxConfig(
        net="tiny", compute_dtype="float32", seq_len=T, img_dim=S,
        aug_backend="xla"))
    tfn = taug.make_pretrain_preprocess(PretrainConfig(
        net="tiny", compute_dtype="float32", seq_len=T, img_dim=S))
    t_loc = T // sp
    whole = tfn({k: torch.from_numpy(v) for k, v in batch.items()}, None)
    for i in range(sp):
        chunk = {k: (v[:, :, i * t_loc:(i + 1) * t_loc] if v.ndim >= 3 else v)
                 for k, v in batch.items()}
        want = jfn({k: jnp.asarray(v) for k, v in chunk.items()}, key,
                   sp_ctx=(T, i * t_loc))
        got = tfn({k: torch.from_numpy(v) for k, v in chunk.items()}, None,
                  sp_ctx=(T, i * t_loc))
        assert set(got) == set(want)
        for name in want:
            g = got[name].numpy()
            d = np.abs(g - np.asarray(want[name]))
            assert np.median(d) < 1e-4 and d.mean() < 3e-3, (name, d.max())
            np.testing.assert_array_equal(
                g, whole[name][:, :, i * t_loc:(i + 1) * t_loc].numpy())
    assert asked == [frames] * (sp + 1)


@functools.lru_cache(maxsize=1)
def _coclr_state(T, S):
    """A JAX CoCLR state on tiny (one init program for both variants)."""
    enc = JaxEncoder(network="tiny", dim=DIM, dtype=jnp.float32)
    return jmoco.init_moco_state(jax.random.PRNGKey(0), enc, "coclr",
                                 np.zeros((1, T, S, S, 3), np.float32),
                                 dim=DIM, K=K)


def _jax_moco(variant, sp, sph, B):
    """A JAX state of `variant` on tiny, its step on the (data, sp, sph)
    mesh of 4 devices, and the port's config and state dict of the same
    weights (tests/test_torch_ddp.py _jax_moco on that mesh)."""
    T, S = 4, 16
    kw = dict(net="tiny", model=variant, moco_k=K, moco_dim=DIM, lr=LR,
              compute_dtype="float32", bn_shuffle="gather", topk=2)
    mesh = make_mesh(4, sp_size=sp, sph_size=sph)
    state = _coclr_state(T, S)
    if variant == "infonce":  # the same weights, without CoCLR's buffers
        state = state.replace(queue_label=None, queue_vname=None,
                              queue_second=None, params_s=None, stats_s=None)
    else:
        head = {n: dict(state.params_s[n], bias=state.params_s[n]["bias"] * 0)
                for n in ("fc1", "fc2")}
        state = state.replace(
            params_s=dict(state.params_s, **head),
            queue_label=jnp.ones((K,), jnp.int32),
            queue_vname=jnp.asarray(np.random.RandomState(3).randint(
                0, 6, K).astype(np.int32)))
    enc_sp = JaxEncoder(network="tiny", dim=DIM, dtype=jnp.float32,
                        sp_axis=sp_axis_of(mesh))
    step, tx = make_pretrain_step(
        enc_sp, JaxConfig(seq_len=T, img_dim=S, batch_size=B, **kw),
        mesh=mesh, donate=False)
    host = jax.device_get(state)
    extra = {}
    if variant == "coclr":
        extra.update(queue_label=host.queue_label, params_s=host.params_s,
                     stats_s=host.stats_s, queue_second=host.queue_second,
                     queue_vname=host.queue_vname)
    sd = state_dict_from_jax(host.params_q, host.stats_q, host.params_k,
                             host.stats_k, host.queue,
                             queue_ptr=int(host.queue_ptr), **extra)
    return (state, step, tx.init(state.params_q), kw,
            {k: v.numpy().copy() for k, v in sd.items()}, T, S)


def _draws(key, n_data, rows):
    """The JAX step's shared key permutation of the global batch and each
    data shard's self-drop (fold_in over the data axis)."""
    _, r_shuffle, r_self = jax.random.split(jax.random.fold_in(key, 0), 3)
    perm = np.asarray(jax.random.permutation(r_shuffle, rows)).astype(np.int64)
    return perm, [bool(jax.random.uniform(jax.random.fold_in(r_self, d)) < 0.9)
                  for d in range(n_data)]


@pytest.mark.parametrize("variant,sp,sph", [("infonce", 2, 1),
                                             ("coclr", 2, 2)],
                         ids=["infonce-data2xsp2", "coclr-sp2xsph2"])
def test_pretrain_step_matches_jax_mesh(ranks, variant, sp, sph):
    """One step of `variant` on tiny (T 4, S 16, K 16, dim 8, float32; 2
    clips a data shard) in the (data, sp, sph) grid of 4 ranks against the
    JAX package's make_pretrain_step on make_mesh(4, sp_size, sph_size), on
    the same augmented clips, key permutation and self-drops: InfoNCE over
    (data 2 x sp 2), and CoCLR at sp 2 x sph 2 (the frozen sampler's
    sharded forward, masks from a full queue). The tolerances and the
    Adam-near-eps handling of tests/test_torch_ddp.py: loss 1e-5, first
    moments 1e-5, parameters 1e-4 (2 lr where Adam's first update was in
    its eps regime), BatchNorm statistics (data shard 0's) 1e-4, queue rows
    1e-5, pointers and names exact; the parameters bit-identical on every
    rank."""
    B = 2
    n_data = 4 // (sp * sph)
    state, step, opt_state, kw, sd, T, S = _jax_moco(variant, sp, sph, B)
    rng = np.random.RandomState(11)
    rows = n_data * B
    clips = lambda: rng.randn(rows, 2, T, S, S, 3).astype(np.float32)
    if variant == "coclr":
        batch = {"seq_rgb": clips(), "seq_flow": clips(),
                 "vname": rng.randint(0, 6, rows).astype(np.int32)}
    else:
        batch = {"seq": clips()}
    key = jax.random.PRNGKey(20)
    perm, drop = _draws(key, n_data, rows)
    state, opt_state, jm = step(
        state, opt_state, {k: jnp.asarray(v.copy()) for k, v in batch.items()},
        key, jnp.float32(LR))
    mu = _first_moments(opt_state, state)
    out = ranks.run("sp_pretrain", dict(sp=sp, sph=sph, variant=variant, sd=sd,
                                        cfg=kw, batches=[batch], perms=[perm],
                                        drops=[drop], lr=LR))
    for r in out:
        np.testing.assert_allclose(r["metrics"][0]["loss"], float(jm["loss"]),
                                   atol=1e-5, rtol=0)
        for key, val in r["states"][0].items():
            if "running" not in key and "num_batches" not in key:
                assert np.array_equal(val, out[0]["states"][0][key]), key
    for key, val in mu.items():
        np.testing.assert_allclose(out[0]["moments"][0][key], val, atol=1e-5,
                                   rtol=0, err_msg=key)
    near_eps = {k: (np.abs(v) < 1e-8) & (v != 0) for k, v in mu.items()}
    got = out[0]["states"][0]
    _assert_params(got, state, near_eps)
    assert int(got["queue_ptr"][0]) == int(state.queue_ptr) == rows % K
    np.testing.assert_allclose(got["queue"], np.asarray(state.queue),
                               atol=1e-5, rtol=0)
    if variant == "coclr":
        np.testing.assert_allclose(got["queue_second"],
                                   np.asarray(state.queue_second),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got["queue_vname"],
                                      np.asarray(state.queue_vname))


def _u8_batches(rng, n, b, T, S):
    return [{"seq": rng.randint(0, 256, (b, 2, T, S, S, 3), np.uint8),
             "aug_base": np.ones((b, 2), np.uint8)} for _ in range(n)]


def test_run_pretrain_sp_members_draw_alike(ranks, tmp_path):
    """run_pretrain (InfoNCE, tiny) with sp_size 2 over 4 ranks, (data 2 x
    sp 2), 3 steps, each data shard fed its own batches: the two members of
    a data shard seed the step's generator alike, draw the same self-drop
    and take the same key permutation, the two data shards' seeds differ
    (step_seed keyed by the data rank); each step gets the member's T chunk
    (4 of 8 frames); all ranks end with the same encoder_q and queue; the
    queue pointer is 3 steps x the global batch of 4; rank 0 printed the
    sequence-parallel line, and only it wrote a checkpoint."""
    rng = np.random.RandomState(6)
    shards = [_u8_batches(rng, 3, 2, 8, 16) for _ in range(2)]
    cfg = dict(net="tiny", seq_len=8, img_dim=16, batch_size=2, moco_k=K,
               moco_dim=DIM, epochs=1, compute_dtype="float32", prefix="sp",
               sp_size=2)
    dirs = [tmp_path / f"r{r}" for r in range(4)]
    for d in dirs:
        d.mkdir()
    out = ranks.run("sp_run_pretrain", [dict(cfg=cfg, workdir=str(d),
                                             batches=shards) for d in dirs])
    for d in range(2):
        a, b = out[2 * d], out[2 * d + 1]
        for name in ("seeds", "drops", "perms"):
            assert a[name] == b[name], (d, name)
    assert not set(out[0]["seeds"]) & set(out[2]["seeds"])
    assert all(o["shapes"] == [[2, 2, 4, 16, 16, 3]] * 3 for o in out)
    assert len({o["digest"] for o in out}) == 1
    assert [o["queue_ptr"] for o in out] == [12 % K] * 4
    assert "sequence-parallel x2" in out[0]["printed"]
    wrote = [glob.glob(str(d / "**" / "*.pth.tar"), recursive=True)
             for d in dirs]
    assert "epoch0.pth.tar" in {os.path.basename(f) for f in wrote[0]}
    assert not any(wrote[1:])


def test_run_pretrain_sp1_is_the_unsharded_loop(tmp_path, monkeypatch):
    """With sp_size = sph_size = 1 (the default) run_pretrain in one process
    is the plain loop, bit for bit: 2 InfoNCE steps on tiny equal
    preprocess (the generator seeded step_seed(seed, iteration)) and
    pretrain_step called by hand on the same batches."""
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step
    from coclr_tpu_torch.train.pretrain import run_pretrain, step_seed
    from torch_ddp_ranks import _PreemptingLoader

    monkeypatch.chdir(tmp_path)
    batches = _u8_batches(np.random.RandomState(2), 2, 2, 4, 16)
    cfg = PretrainConfig(net="tiny", seq_len=4, img_dim=16, batch_size=2,
                         moco_k=K, moco_dim=DIM, epochs=1, sp_size=1,
                         sph_size=1, compute_dtype="float32", prefix="one")
    model, _, _ = run_pretrain(cfg, loader=_PreemptingLoader(batches, 0, -1, -1),
                               device="cpu")
    ref = MoCo("tiny", DIM, K, torch.float32,
               gen=torch.Generator().manual_seed(cfg.seed)).train()
    opt = make_optimizer(cfg, ref.encoder_q.parameters())
    pre = taug.make_pretrain_preprocess(cfg)
    gen = torch.Generator()
    for it, batch in enumerate(batches, start=1):
        gen.manual_seed(step_seed(cfg.seed, it))
        pretrain_step(ref, opt, pre({k: torch.from_numpy(v)
                                     for k, v in batch.items()}, gen),
                      cfg.lr, cfg)
    for key, val in ref.state_dict().items():
        assert torch.equal(model.state_dict()[key], val), key


def test_sp_sizes_must_divide_the_launch():
    """--sp_size 2 in one plain process (a world of 1) raises before any
    work, as does a negative size."""
    with pytest.raises(ValueError, match="sp_size"):
        pdist.maybe_initialize(torch.device("cpu"), "gloo", sp_size=2)
    with pytest.raises(ValueError, match="sp_size"):
        pdist.maybe_initialize(torch.device("cpu"), "gloo", sph_size=-1)


def test_two_rank_cli_sp2_on_cpu(synth, tmp_path):
    """`python -m coclr_tpu_torch.main_nce --device cpu --sp_size 2` as two
    processes with the environment torchrun sets: both exit 0 after the 2
    steps of the 8 training videos (global batch 4: one data shard), rank
    0 printed the sequence-parallel line, only rank 0 wrote a checkpoint
    and its queue_ptr is 2 x 4."""
    argv = [sys.executable, "-m", "coclr_tpu_torch.main_nce", "--device",
            "cpu", "--net", "tiny", "--seq_len", "4", "--img_dim", "16",
            "--batch_size", "4", "--moco-k", "16", "--moco-dim", "8",
            "--epochs", "1", "--workers", "2", "--compute_dtype", "float32",
            "--print_freq", "1", "--data_root", synth["data_root"],
            "--prefix", "sp", "--sp_size", "2"]
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   COCLR_META_ROOT=synth["meta_root"], OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        (tmp_path / f"r{rank}").mkdir()
        procs.append(subprocess.Popen(argv, cwd=tmp_path / f"r{rank}", env=env,
                                      text=True, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "sequence-parallel x2" in outs[0][0] and "Epoch:[0]" in outs[0][0]
    assert outs[1][0].strip() == ""
    assert not glob.glob(str(tmp_path / "r1" / "**" / "*.pth.tar"),
                         recursive=True)
    found = glob.glob(str(tmp_path / "r0" / "log-sp" / "*" / "model" /
                          "epoch0.pth.tar"))
    assert len(found) == 1
    ckpt = load_checkpoint(found[0])
    assert int(ckpt["state_dict"]["queue_ptr"][0]) == 2 * 4
