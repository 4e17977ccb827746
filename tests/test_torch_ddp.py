"""The port's data parallelism (coclr_tpu_torch/parallel/dist.py) on the CPU:
two gloo ranks of the port against the JAX package's 2-device mesh (two of
the 8 virtual CPU devices of conftest.py) on the same global batch.

The ranks are two spawned processes (tests/torch_ddp_ranks.py, which
imports torch and the port only), started once for the module; the JAX side
runs here. Both sides take the same draws: the shared key permutation is
JAX's permutation(rng_shuffle, 4), the self-drop each device's own
uniform(fold_in(rng_self, i)) < 0.9, and each device's classifier
preprocess draws. Tolerances are tests/test_ddp_equivalence.py's: loss
1e-5, params 1e-4 (Adam turns float32 all-reduce ordering into parameter
noise), queue rows 1e-5, pointers, labels and names exact; the two ranks'
parameters are bit-identical.
"""

import glob
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coclr_tpu.config import PretrainConfig as JaxConfig
from coclr_tpu.evalsuite import steps as jsteps
from coclr_tpu.models import moco as jmoco
from coclr_tpu.models.encoder import ProjectionEncoder as JaxEncoder
from coclr_tpu.parallel import make_mesh
from coclr_tpu.parallel.train_step import make_pretrain_step
from coclr_tpu.utils import torch_interop
from coclr_tpu_torch.evalsuite import driver, steps
from coclr_tpu_torch.parallel import dist as pdist
from coclr_tpu_torch.utils.interop import (encoder_state_dict_from_jax,
                                           state_dict_from_jax)
from test_torch_coclr import _clips
from test_torch_eval import _cfgs, _jax_train_draws, _pair, _t, _triggered
from torch_ddp_ranks import RankPool, _Samples

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, K, DIM, B, T, S = 1e-3, 16, 8, 2, 4, 16


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(2, str(tmp_path_factory.mktemp("ddp_ranks")))
    yield pool
    pool.close()


def _jax_moco(variant, bn_shuffle):
    """A JAX state of `variant` on `tiny`, its 2-device step, and the port's
    config and state dict of the same weights (numpy copies)."""
    kw = dict(net="tiny", model=variant, moco_k=K, moco_dim=DIM, lr=LR,
              compute_dtype="float32", bn_shuffle=bn_shuffle, topk=2)
    enc = JaxEncoder(network="tiny", dim=DIM, dtype=jnp.float32)
    state = jmoco.init_moco_state(jax.random.PRNGKey(0), enc, variant,
                                  np.zeros((1, T, S, S, 3), np.float32),
                                  dim=DIM, K=K)
    if variant == "coclr":
        # the gate open, sibling names present, and the sampler's head
        # without biases, so that the data and not rounding decides top-k
        head = {n: dict(state.params_s[n], bias=state.params_s[n]["bias"] * 0)
                for n in ("fc1", "fc2")}
        state = state.replace(
            params_s=dict(state.params_s, **head),
            queue_label=jnp.ones((K,), jnp.int32),
            queue_vname=jnp.asarray(np.random.RandomState(3).randint(
                0, 6, K).astype(np.int32)))
    step, tx = make_pretrain_step(
        enc, JaxConfig(seq_len=T, img_dim=S, batch_size=B, **kw),
        mesh=make_mesh(2), donate=False)
    host = jax.device_get(state)
    extra = {}
    if variant in ("ubernce", "coclr"):
        extra["queue_label"] = host.queue_label
    if variant == "coclr":
        extra.update(params_s=host.params_s, stats_s=host.stats_s,
                     queue_second=host.queue_second,
                     queue_vname=host.queue_vname)
    sd = state_dict_from_jax(host.params_q, host.stats_q, host.params_k,
                             host.stats_k, host.queue,
                             queue_ptr=int(host.queue_ptr), **extra)
    return (state, step, tx.init(state.params_q), kw,
            {k: v.numpy().copy() for k, v in sd.items()})


def _batch(rng, variant):
    if variant == "coclr":
        return {"seq_rgb": _clips(rng, 2 * B, T, S),
                "seq_flow": _clips(rng, 2 * B, T, S),
                "vname": rng.randint(0, 6, 2 * B).astype(np.int32)}
    return {"seq": rng.randn(2 * B, 2, T, S, S, 3).astype(np.float32),
            "label": rng.randint(0, 3, 2 * B).astype(np.int32)}


def _alltoall_draws(r_shuffle, b):
    """Each device's two local permutations in the JAX package's
    batch_shuffle_alltoall (coclr_tpu/models/moco.py): permutation(
    fold_in(r_local, i), b) and permutation(fold_in(r_cross, i), b)."""
    r_local, r_cross = jax.random.split(r_shuffle)
    return [tuple(np.asarray(jax.random.permutation(
        jax.random.fold_in(r, i), b)).astype(np.int64)
        for r in (r_local, r_cross)) for i in range(2)]


def _jax_draws(key, bn_shuffle="gather"):
    """The JAX step's key shuffle permutations (gather: the shared one;
    alltoall: each device's pair) and each device's self-drop."""
    _, r_shuffle, r_self = jax.random.split(jax.random.fold_in(key, 0), 3)
    if bn_shuffle == "alltoall":
        perm = _alltoall_draws(r_shuffle, B)
    else:
        perm = np.asarray(jax.random.permutation(r_shuffle, 2 * B)).astype(
            np.int64)
    drops = [bool(jax.random.uniform(jax.random.fold_in(r_self, i)) < 0.9)
             for i in range(2)]
    return perm, drops


def _assert_params(got, state, near_eps, rank0_stats=True):
    """encoder_q and encoder_k against the JAX state: parameters to 1e-4,
    BatchNorm statistics (device 0's, so rank 0's) to 1e-4. In the
    elements of encoder_q in `near_eps` Adam's first update lr g / (|g| +
    eps) was in its eps regime (0 < |g| < 1e-7), where float32 rounding of the
    gradient moves it by a share of lr; there each step can differ by at
    most 2 lr."""
    for prefix, params, stats in (("encoder_q.", state.params_q, state.stats_q),
                                  ("encoder_k.", state.params_k, state.stats_k)):
        want = encoder_state_dict_from_jax(*jax.device_get((params, stats)))
        for key, val in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            if "running" in key and not rank0_stats:
                continue
            diff = np.abs(got[prefix + key] - val.numpy())
            loose = near_eps.get(prefix + key, np.zeros(diff.shape, bool))
            assert diff[~loose].max(initial=0) <= 1e-4, (prefix + key, diff.max())
            assert diff[loose].max(initial=0) <= 2 * LR * int(state.step), key


def _first_moments(opt_state, state):
    """Adam's first moment of encoder_q in the JAX optimizer state, in the
    port's names and layout."""
    mu = encoder_state_dict_from_jax(*jax.device_get((opt_state[1].mu,
                                                      state.stats_q)))
    return {"encoder_q." + k: v.numpy() for k, v in mu.items()
            if "running" not in k and "num_batches" not in k}


@pytest.mark.parametrize("variant,bn_shuffle", [
    ("infonce", "gather"), ("ubernce", "gather"), ("coclr", "gather"),
    ("infonce", "none"), ("infonce", "alltoall"), ("coclr", "alltoall")])
def test_pretrain_step_two_ranks_matches_jax_mesh(ranks, variant, bn_shuffle):
    """Two steps of `variant` on a global batch of 4 (2 per rank / device),
    with the key shuffle `bn_shuffle` on JAX's draws (alltoall: each
    device's pair of local permutations). JAX's metrics are its pmean, its BatchNorm statistics device 0's (rank
    0's); the queues hold the global batch in rank order. The gradient
    averaged over the ranks is held through Adam's first moment after the
    first step (1e-5; measured 5e-8 to 9e-7 of moments up to 1.5), and the
    parameters to 1e-4 after each step, but in the elements (under 1 %)
    whose first gradient was not 0 and below 1e-7 (ten times Adam's eps):
    there Adam's first update is in its eps regime
    and rounding moved one element of InfoNCE's head by 2.4e-4 (a share of
    lr), so they are held to 2 lr a step. The two ranks' whole state but
    the BatchNorm statistics is bit-identical after each step."""
    state, step, opt_state, kw, sd = _jax_moco(variant, bn_shuffle)
    rng = np.random.RandomState(11)
    batches, perms, drops, losses = [], [], [], []
    for i in range(2):
        batch = _batch(rng, variant)
        key = jax.random.PRNGKey(20 + i)
        perm, drop = _jax_draws(key, bn_shuffle)
        state, opt_state, jm = step(
            state, opt_state, {k: jnp.asarray(v.copy()) for k, v in batch.items()},
            key, jnp.float32(LR))
        if i == 0:
            first, mu = state, _first_moments(opt_state, state)
        batches.append(batch)
        perms.append(perm)
        drops.append(drop)
        losses.append(float(jm["loss"]))
    out = ranks.run("pretrain", dict(variant=variant, sd=sd, cfg=kw,
                                     batches=batches, perms=perms, drops=drops,
                                     lr=LR))
    for r in out:
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], losses,
                                   atol=1e-5, rtol=0)
    for got0, got1 in zip(out[0]["states"], out[1]["states"]):
        for key, val in got0.items():
            if "running" not in key and "num_batches" not in key:
                assert np.array_equal(val, got1[key]), key
    # the averaged gradient, through Adam's first moment 0.1 (g + wd p)
    for key, val in mu.items():
        np.testing.assert_allclose(out[0]["moments"][0][key], val, atol=1e-5,
                                   rtol=0, err_msg=key)
    near_eps = {k: (np.abs(v) < 1e-8) & (v != 0) for k, v in mu.items()}
    assert sum(int(v.sum()) for v in near_eps.values()) \
        <= 0.01 * sum(v.size for v in near_eps.values())
    _assert_params(out[0]["states"][0], first, near_eps)
    _assert_params(out[1]["states"][0], first, near_eps, rank0_stats=False)
    _assert_params(out[0]["states"][1], state, near_eps)
    got0 = out[0]["states"][1]
    assert int(got0["queue_ptr"][0]) == int(state.queue_ptr) == 4 * B % K
    np.testing.assert_allclose(got0["queue"], np.asarray(state.queue),
                               atol=1e-5, rtol=0)
    if variant in ("ubernce", "coclr"):
        np.testing.assert_array_equal(got0["queue_label"],
                                      np.asarray(state.queue_label))
    if variant == "ubernce":
        labels = np.concatenate([b["label"] for b in batches])
        np.testing.assert_array_equal(got0["queue_label"][:4 * B], labels)
    if variant == "coclr":
        np.testing.assert_allclose(got0["queue_second"],
                                   np.asarray(state.queue_second),
                                   atol=1e-5, rtol=0)
        names = np.concatenate([b["vname"] for b in batches])
        np.testing.assert_array_equal(got0["queue_vname"][:4 * B], names)
        np.testing.assert_array_equal(got0["queue_vname"],
                                      np.asarray(state.queue_vname))


def test_alltoall_shuffle_matches_jax_mesh_and_falls_back_to_gather(ranks):
    """batch_shuffle_alltoall on two gloo ranks, 8 rows a rank, against the
    JAX package's batch_shuffle_alltoall on its 2-device mesh under the same
    draws (each device's pair from fold_in(rank)), for 3 keys: the shuffled
    rows equal, exactly; the unshuffle restores every rank's rows exactly;
    the global batch is a permutation of the rows, and every rank's BN batch
    holds b / n = 4 rows of every rank (tests/test_alltoall.py's even mix).
    With 3 rows a rank (2 does not divide 3) --bn_shuffle alltoall takes the
    gather form, as the JAX package's encode_keys does: the keys equal the
    gather form's bit for bit, under the same shared permutation."""
    from coclr_tpu.parallel.mesh import mesh_axes, shard_map_fn
    from jax.sharding import PartitionSpec as P
    from coclr_tpu_torch.models.moco import shuffle_mode

    b, n = 8, 2
    mesh = make_mesh(n)
    axis = mesh_axes(mesh)

    def fn(x, rng):
        shuffled, ctx = jmoco.batch_shuffle_alltoall(x, rng, axis)
        return shuffled, jmoco.batch_unshuffle_alltoall(shuffled, ctx, axis)

    f = jax.jit(shard_map_fn(fn, mesh, in_specs=(P(axis), P()),
                             out_specs=(P(axis), P(axis))))
    rows = np.arange(n * b, dtype=np.float32)[:, None]
    _, _, _, kw, sd = _jax_moco("infonce", "alltoall")
    keys_in = np.random.RandomState(9).randn(6, 3, T, S, S).astype(np.float32)
    gather_perm = np.random.RandomState(10).permutation(6).astype(np.int64)
    assert shuffle_mode("alltoall", 3, 2) == "gather"
    assert shuffle_mode("alltoall", 4, 2) == "alltoall"
    assert shuffle_mode("alltoall", 3, 1) == "none"
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want, back = jax.device_get(f(jnp.asarray(rows), key))
        np.testing.assert_array_equal(back, rows)
        out = ranks.run("alltoall", dict(
            rows=rows, perms=_alltoall_draws(key, b), sd=sd, cfg=kw,
            keys_in=keys_in, gather_perm=gather_perm))
        shuffled = np.concatenate([o["shuffled"] for o in out])[:, 0]
        np.testing.assert_array_equal(shuffled, want[:, 0])
        np.testing.assert_array_equal(np.sort(shuffled), np.arange(n * b))
        for r, o in enumerate(out):
            np.testing.assert_array_equal(o["restored"], rows[r * b:(r + 1) * b])
            src = (o["shuffled"][:, 0] // b).astype(np.int64)
            np.testing.assert_array_equal(np.bincount(src, minlength=n),
                                          [b // n] * n)
            assert np.array_equal(o["keys"]["alltoall"], o["keys"]["gather"])


def test_world_one_group_equals_no_group(ranks):
    """Three InfoNCE steps on rank 0 as the one rank of a gloo group
    (DistributedDataParallel over it) and as one plain process: every
    metric and every tensor of the state bit-identical."""
    _, _, _, kw, sd = _jax_moco("infonce", "gather")
    rng = np.random.RandomState(2)
    batches = [{"seq": rng.randn(B, 2, T, S, S, 3).astype(np.float32)}
               for _ in range(3)]
    got = ranks.run("world_one", dict(variant="infonce", sd=sd, cfg=kw,
                                      batches=batches, lr=LR))[0]
    assert got["group"]["metrics"] == got["none"]["metrics"]
    for key, val in got["none"]["state"].items():
        assert np.array_equal(got["group"]["state"][key], val), key


@pytest.mark.parametrize("train_what", ["ft", "last"])
def test_classifier_step_two_ranks_matches_jax_mesh(ranks, train_what,
                                                    monkeypatch):
    """Two SGD steps of the classifier (dropout 0) on a global batch of 4,
    each rank's clips through the port's preprocess on its JAX device's
    draws; JAX's preprocess is the identity on those clips (as in
    test_torch_eval). Loss to 1e-5, top-1 exactly, every parameter to
    1e-4, the ranks' parameters bit-identical; 'last' leaves the backbone
    bit-identical. Validation first, over 5 clips in global batches of 4:
    the loader pads the last batch of 1 to 2 (rank 1's row not valid) as
    the JAX driver pads it for the devices, and the means equal one
    process's over the 5 clips and the JAX mesh's eval step (rtol 1e-5)."""
    monkeypatch.setattr(jsteps, "preprocess_train", lambda x, rng, dtype: x)
    jcfg, cfg = _cfgs(train_what=train_what, optim="sgd", lr=0.05,
                      batch_size=B)
    jmodel, state, model = _pair(jcfg, cfg, seed=4)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    mesh = make_mesh(2)
    train, jeval, tx = jsteps.make_classifier_steps(jmodel, jcfg, mesh)
    opt_state = tx.init(state.params)

    rng = np.random.RandomState(8)
    val = [{"seq": rng.randint(0, 256, (1, T, S, S, 3), np.uint8),
            "label": np.int64(rng.randint(0, 101))} for _ in range(5)]
    jsums = {k: 0.0 for k in ("loss", "top1", "top5")}
    for lo in (0, 4):  # the JAX driver's padding of the final batch
        part = val[lo:lo + 4]
        pad = len(part) % 2
        seq = np.stack([v["seq"][0] for v in part + part[-1:] * pad])
        label = np.array([v["label"] for v in part + part[-1:] * pad], np.int32)
        valid = np.array([1.0] * len(part) + [0.0] * pad, np.float32)
        jm, _, _ = jeval(state, {"seq": jnp.asarray(seq),
                                 "label": jnp.asarray(label),
                                 "valid": jnp.asarray(valid)})
        for k in jsums:
            jsums[k] += float(jm[k]) * len(part)
    one = driver.validate(model, _one_loader(val), cfg, torch.device("cpu"))

    xs, labels, jlosses, jtop1, fired = [], [], [], [], 0
    for i in range(2):
        seq = rng.randint(0, 256, (2 * B, T, S, S, 3), np.uint8)
        label = rng.randint(0, 101, 2 * B).astype(np.int32)
        key = jax.random.PRNGKey(30 + i)
        x = []
        for d in range(2):
            rng_aug, _ = jax.random.split(
                jax.random.fold_in(jax.random.fold_in(key, d), 0))
            draws = _jax_train_draws(rng_aug, B)
            fired += _triggered(draws)
            x.append(steps.apply_train_preprocess(
                _t(seq[d * B:(d + 1) * B]), draws, torch.float32).numpy())
        state, opt_state, jm = train(
            state, opt_state, {"seq": jnp.asarray(np.concatenate(x)),
                               "label": jnp.asarray(label)},
            key, jnp.float32(cfg.lr))
        xs.append(x)
        labels.append([label[:B], label[B:]])
        jlosses.append(float(jm["loss"]))
        jtop1.append(float(jm["top1"]))
    assert fired > 0

    kw = {f: getattr(cfg, f) for f in ("net", "dataset", "seq_len", "img_dim",
                                       "batch_size", "optim", "lr", "wd",
                                       "dropout", "train_what", "compute_dtype",
                                       "schedule")}
    out = ranks.run("classifier", dict(cfg=kw, sd=sd, xs=xs, labels=labels,
                                       lr=cfg.lr, val_samples=val))
    assert out[0]["valid_rows"] == [[1.0, 1.0], [1.0]]
    assert out[1]["valid_rows"] == [[1.0, 1.0], [0.0]]
    for r in out:
        for k in ("loss", "top1", "top5"):
            np.testing.assert_allclose(r["val"][k], one[k], rtol=1e-5)
            np.testing.assert_allclose(r["val"][k], jsums[k] / 5, rtol=1e-5)
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], jlosses,
                                   rtol=1e-5)
        assert [m["top1"] for m in r["metrics"]] == jtop1
    want = torch_interop_classifier(state)
    for key, val in out[0]["state"].items():
        if "num_batches" in key:
            continue
        if "running" not in key:
            assert np.array_equal(val, out[1]["state"][key]), key
        if train_what == "last" and key.startswith("backbone."):
            assert np.array_equal(val, sd[key]), key
        np.testing.assert_allclose(val, want[key], atol=1e-4, err_msg=key)


def _one_loader(samples):
    from coclr_tpu_torch.data.loader import Loader

    return Loader(_Samples(samples), 2 * B, shuffle=False, drop_last=False,
                  num_workers=1)


def torch_interop_classifier(state):
    from coclr_tpu_torch.utils.interop import classifier_state_dict_from_jax

    return {k: v.numpy() for k, v in classifier_state_dict_from_jax(
        *jax.device_get((state.params, state.batch_stats))).items()}


def _steps_batches(rng, n):
    return [{"seq": rng.randint(0, 256, (B, 2, T, S, S, 3), np.uint8),
             "aug_base": np.ones((B, 2), np.uint8)} for _ in range(n)]


def test_preemption_on_one_rank_stops_both_at_the_same_iteration(ranks,
                                                                 tmp_path):
    """SIGTERM on rank 1 alone while it fetches its third batch: both ranks
    agree on the flag after that step, leave the loop at the same
    iteration with the same state, and only rank 0 writes preempt.pth.tar.
    Then --resume from it, given to rank 0 alone (rank 1's path does not
    exist): rank 0 reads it and both ranks go on from its state, epoch and
    iteration, and end equal."""
    rng = np.random.RandomState(4)
    cfg = dict(net="tiny", seq_len=T, img_dim=S, batch_size=B, moco_k=K,
               moco_dim=DIM, epochs=2, compute_dtype="float32", prefix="pre",
               dist_backend="gloo")
    out = ranks.run("run_pretrain", [
        dict(cfg=cfg, workdir=str(tmp_path), batches=_steps_batches(rng, 6),
             signal_rank=1, at=2) for _ in range(2)])
    assert [o["preempted"] for o in out] == [True, True]
    assert [len(o["step_s"]) for o in out] == [3, 3]
    assert out[0]["iteration"] == out[1]["iteration"] == 4
    assert out[0]["ranks"] == 2 and out[0]["digest"] == out[1]["digest"]
    found = glob.glob(str(tmp_path / "log-pre" / "*" / "model" / "*.pth.tar"))
    assert [os.path.basename(f) for f in found] == ["preempt.pth.tar"]

    # the preempted epoch (0, wound back to -1) is run again, then epoch 1
    resumed = ranks.run("run_pretrain", [
        dict(cfg=dict(cfg, resume=path), workdir=str(tmp_path),
             batches=_steps_batches(rng, 1))
        for path in (found[0], str(tmp_path / "absent.pth.tar"))])
    assert [len(o["step_s"]) for o in resumed] == [2, 2]
    assert [o["iteration"] for o in resumed] == [6, 6]
    assert [o["adam_steps"] for o in resumed] == [[5], [5]]
    assert resumed[0]["digest"] == resumed[1]["digest"]


def test_alltoall_shuffle_and_multi_rank_test_raise(ranks, tmp_path,
                                                    monkeypatch):
    """--bn_shuffle alltoall on two ranks runs run_pretrain (each rank draws
    its own pair of local permutations a step): both ranks finish the 3
    steps of the epoch with the same encoder_q and queue (sha256 digest);
    an unknown --bn_shuffle raises ValueError on both before any step;
    --test under WORLD_SIZE 2 raises before it reads anything;
    --num_devices other than the launch's world raises."""
    cfg = dict(net="tiny", seq_len=T, img_dim=S, batch_size=B, moco_k=K,
               moco_dim=DIM, epochs=1, compute_dtype="float32",
               bn_shuffle="alltoall", prefix="a2a")
    batches = _steps_batches(np.random.RandomState(6), 3)
    out = ranks.run("run_pretrain", dict(cfg=cfg, workdir=str(tmp_path),
                                         batches=batches))
    assert [o.get("raised") for o in out] == [None, None]
    assert [len(o["step_s"]) for o in out] == [3, 3]
    assert [o["ranks"] for o in out] == [2, 2]
    assert out[0]["digest"] == out[1]["digest"]
    out = ranks.run("run_pretrain", dict(cfg=dict(cfg, bn_shuffle="ring"),
                                         workdir=str(tmp_path)))
    for o in out:
        assert o["raised"] == "ValueError" and "bn_shuffle" in o["message"]

    from coclr_tpu_torch import main_classifier

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="one process"):
        main_classifier.main(["--test", str(tmp_path / "x.pth.tar"),
                              "--retrieval", "--device", "cpu"])
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="num_devices"):
        pdist.maybe_initialize(torch.device("cpu"), "gloo", num_devices=2)
    with pytest.raises(ValueError, match="dist-backend"):
        pdist.maybe_initialize(torch.device("cpu"), "mpi")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

    root = tmp_path_factory.mktemp("ddp_synth")
    out = make_synthetic_ucf(str(root), n_classes=2, n_groups=3, n_clips=2,
                             n_frames=12, size=(40, 48), flow=False)
    meta_root = root / "meta_root"
    meta_root.mkdir()
    os.symlink(out["root"], meta_root / "ucf101")
    (root / "data" / "UCF101").mkdir(parents=True)
    os.symlink(out["db_path"], root / "data" / "UCF101" / "ucf101_frame.lmdb")
    return {"meta_root": str(meta_root), "data_root": str(root / "data")}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_cli_on_cpu(synth, tmp_path):
    """`python -m coclr_tpu_torch.main_nce --device cpu` as two processes
    with the environment torchrun sets, each in a directory of its own:
    both exit 0 after the 2 steps of the 8 training videos (global batch
    4); rank 1 wrote no checkpoint, and rank 0's holds queue_ptr 2 x 4 and
    loads into coclr_tpu through moco_state_from_torch; only rank 0 printed
    (rank 1's standard output is empty)."""
    argv = [sys.executable, "-m", "coclr_tpu_torch.main_nce", "--device",
            "cpu", "--net", "tiny", "--seq_len", "4", "--img_dim", "16",
            "--batch_size", "2", "--moco-k", "16", "--moco-dim", "8",
            "--epochs", "1", "--workers", "2", "--compute_dtype", "float32",
            "--print_freq", "1", "--data_root", synth["data_root"],
            "--prefix", "ddp", "--num_devices", "2"]
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   COCLR_META_ROOT=synth["meta_root"], OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        (tmp_path / f"r{rank}").mkdir()
        procs.append(subprocess.Popen(argv, cwd=tmp_path / f"r{rank}", env=env,
                                      text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "Epoch:[0]" in outs[0][0] and "2 rank(s) over gloo" in outs[0][0]
    assert "Epoch:[0]" not in outs[1][0] and outs[1][0].strip() == ""

    assert not glob.glob(str(tmp_path / "r1" / "**" / "*.pth.tar"),
                         recursive=True)
    found = glob.glob(str(tmp_path / "r0" / "log-ddp" / "*" / "model" /
                          "epoch0.pth.tar"))
    assert len(found) == 1
    raw = torch_interop.load_torch_checkpoint(found[0])
    assert int(raw["state_dict"]["queue_ptr"][0]) == 2 * 4
    enc = JaxEncoder(network="tiny", dim=8, dtype=jnp.float32)
    template = jmoco.init_moco_state(jax.random.PRNGKey(1), enc, "infonce",
                                     np.zeros((1, 4, 16, 16, 3), np.float32),
                                     dim=8, K=16)
    jstate = torch_interop.moco_state_from_torch(raw["state_dict"], template)
    np.testing.assert_array_equal(np.asarray(jstate.queue),
                                  raw["state_dict"]["queue"].T)
    assert int(jstate.queue_ptr) == 8
