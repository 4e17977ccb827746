"""Sequence parallelism in the port's classifier (coclr_tpu_torch/evalsuite
under --sp_size / --sph_size) on the CPU.

One pool of 4 gloo rank processes (tests/torch_ddp_ranks.py, torch only)
takes the (data, sp, sph) grids (2, 2, 1), (2, 1, 2) and (1, 2, 2); a pool
of 2 runs run_classifier_train at (data 1, sp 2) and (data 1, sph 2). The JAX side runs on
conftest's virtual CPU devices: coclr_tpu.evalsuite.steps'
make_classifier_steps on make_mesh(4, sp_size, sph_size), one compiled step
per mesh, its preprocess swapped for the identity where both sides take
the same preprocessed clips. Everything is at small size: the tiny net,
T 8, S 16, 5 classes, 2 clips a data shard, SGD (Adam's near-eps first
step stays out), float32.

Held against the JAX package: two finetune steps on each grid (loss rtol
1e-4, atol 1e-6; parameters and BatchNorm statistics rtol 1e-4 with atol
1e-5, 3e-5 at sph: tests/test_seqpar.py's and tests/test_spatialpar.py's
bars), the padded eval step at sp 2 and sph 2 (metrics and count rtol
1e-4, logits rtol 1e-4 with atol 1e-5), a member's train preprocess (T
chunk at full H, then the H cut; 1e-6) with its negative control, and one
linear-probe step at sp 2 (the head 1e-5, the backbone bit for bit).
Against the port's own one-process run: run_classifier_train at sp 2 and
at sph 2 with dropout and jitter on.
"""

import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coclr_tpu.config import EvalConfig as JaxEvalConfig
from coclr_tpu.evalsuite import steps as jsteps
from coclr_tpu.models.classifier import LinearClassifier as JaxClassifier
from coclr_tpu.parallel import make_mesh
from coclr_tpu.parallel.mesh import sp_axis_of
from coclr_tpu.utils import torch_interop
from coclr_tpu_torch.config import EvalConfig
from coclr_tpu_torch.evalsuite import driver, steps
from coclr_tpu_torch.models.classifier import LinearClassifier
from coclr_tpu_torch.parallel import dist as pdist
from coclr_tpu_torch.train.pretrain import step_seed
from coclr_tpu_torch.utils.interop import classifier_state_dict_from_jax
from test_torch_ddp import synth  # noqa: F401 (a fixture)
from test_torch_eval import _jax_train_draws, _t, _triggered
from torch_ddp_ranks import RankPool, _Samples

T, S, NC, B, LR = 8, 16, 5, 2, 0.05
GRIDS = [(2, 1), (1, 2), (2, 2)]
IDS = ["data2xsp2", "data2xsph2", "sp2xsph2"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("cls_sp_ranks")))
    yield pool
    pool.close()


def _kw(train_what):
    """The configuration both packages take."""
    return dict(net="tiny", dataset="ucf101", seq_len=T, img_dim=S,
                batch_size=B, optim="sgd", lr=LR, wd=1e-3, dropout=0.0,
                train_what=train_what, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _weights(train_what):
    """The port's classifier state dict (He-scaled convolutions, an N(0, 1)
    head, so that the logits are far from flat) and the JAX variables of
    the same weights (copies, through coclr_tpu's own converter)."""
    last = train_what == "last"
    model = LinearClassifier(num_class=NC, network="tiny", dropout=0.0,
                             use_dropout=not last, use_l2_norm=last,
                             use_final_bn=last, freeze_backbone=last,
                             dtype=torch.float32,
                             gen=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv3d):
                mod.weight.normal_(0.0, (2.0 / mod.weight[0].numel()) ** 0.5,
                                   generator=gen)
        model.final_fc.weight.normal_(generator=gen)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return sd, torch_interop.flax_from_torch_classifier(
        {k: v.copy() for k, v in sd.items()})


def _state(train_what):
    _, variables = _weights(train_what)
    return jsteps.ClassifierState(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        step=jnp.zeros((), jnp.int32))


@functools.lru_cache(maxsize=None)
def _jax_steps(sp, sph, train_what):
    """coclr_tpu's classifier steps on make_mesh(4, sp, sph), compiled on
    their first call and kept for the module (its preprocess is the
    identity in every test that trains)."""
    mesh = make_mesh(4, sp_size=sp, sph_size=sph)
    last = train_what == "last"
    model = JaxClassifier(num_class=NC, network="tiny", dropout=0.0,
                          use_dropout=not last, use_l2_norm=last,
                          use_final_bn=last, dtype=jnp.float32,
                          sp_axis=sp_axis_of(mesh))
    return jsteps.make_classifier_steps(model, JaxEvalConfig(**_kw(train_what)),
                                        mesh)


def _clips(rng, rows):
    """Preprocessed clips (the normalize of random uint8 frames)."""
    u8 = rng.randint(0, 256, (rows, T, S, S, 3), np.uint8)
    return steps.preprocess_eval(_t(u8), torch.float32).numpy()


def _jax_state_dict(state):
    return {k: v.numpy() for k, v in classifier_state_dict_from_jax(
        *jax.device_get((state.params, state.batch_stats))).items()}


def _run_jax_train(sp, sph, train_what, xs, labels, monkeypatch):
    monkeypatch.setattr(jsteps, "preprocess_train", lambda x, rng, dtype: x)
    train, _, tx = _jax_steps(sp, sph, train_what)
    state = _state(train_what)
    opt_state = tx.init(state.params)
    losses = []
    for i, (x, label) in enumerate(zip(xs, labels)):
        state, opt_state, m = train(
            state, opt_state, {"seq": jnp.asarray(x.copy()),
                               "label": jnp.asarray(label.copy())},
            jax.random.PRNGKey(40 + i), jnp.float32(LR))
        losses.append(float(m["loss"]))
    return losses, _jax_state_dict(state)


@pytest.mark.parametrize("sp,sph", GRIDS, ids=IDS)
def test_finetune_steps_match_jax_mesh(ranks, sp, sph, monkeypatch):
    """Two `ft` SGD steps (dropout 0) on the same preprocessed clips and
    labels in each grid against the JAX steps on the matching mesh: the
    loss of each step rtol 1e-4, atol 1e-6 on every rank; every parameter
    and BatchNorm statistic (data shard 0's, as JAX keeps device 0's) rtol
    1e-4 with atol 1e-5 (3e-5 at sph); the parameters bit-identical on
    every rank."""
    n_data = 4 // (sp * sph)
    rng = np.random.RandomState(7)
    xs = [_clips(rng, n_data * B) for _ in range(2)]
    labels = [rng.randint(0, NC, n_data * B).astype(np.int32)
              for _ in range(2)]
    losses, want = _run_jax_train(sp, sph, "ft", xs, labels, monkeypatch)
    sd, _ = _weights("ft")
    out = ranks.run("sp_classifier", dict(sp=sp, sph=sph, cfg=_kw("ft"), sd=sd,
                                          num_class=NC, lr=LR, xs=xs,
                                          labels=labels))
    for r in out:
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]], losses,
                                   rtol=1e-4, atol=1e-6)
        for key, val in r["state"].items():
            if "running" not in key and "num_batches" not in key:
                assert np.array_equal(val, out[0]["state"][key]), key
    atol = 3e-5 if sph > 1 else 1e-5
    for key, val in want.items():
        if "num_batches" in key:
            continue
        np.testing.assert_allclose(out[0]["state"][key], val, rtol=1e-4,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("sp,sph", GRIDS[:2], ids=IDS[:2])
def test_padded_eval_step_matches_jax_mesh(ranks, sp, sph):
    """The eval step on a global batch of 4 with valid [1, 1, 1, 0] at sp 2
    and at sph 2 (2 data shards): each member cuts its T and H chunk
    before preprocess_eval and sums over the data group. Loss, top-1,
    top-5 and count rtol 1e-4 against the JAX mesh's eval step (count 3,
    not 3 x sp x sph); every member's logits rtol 1e-4, atol 1e-5 against
    JAX's rows of its data shard."""
    rng = np.random.RandomState(9)
    val = {"seq": rng.randint(0, 256, (4, T, S, S, 3), np.uint8),
           "label": rng.randint(0, NC, 4).astype(np.int32),
           "valid": np.array([1, 1, 1, 0], np.float32)}
    _, evals, _ = _jax_steps(sp, sph, "ft")
    jm, jlogits, _ = evals(_state("ft"),
                           {k: jnp.asarray(v.copy()) for k, v in val.items()})
    jlogits = np.asarray(jlogits)
    sd, _ = _weights("ft")
    out = ranks.run("sp_classifier", dict(sp=sp, sph=sph, cfg=_kw("ft"), sd=sd,
                                          num_class=NC, lr=LR, val=val))
    assert float(jm["count"]) == 3.0
    for r, o in enumerate(out):
        for k in ("loss", "top1", "top5", "count"):
            np.testing.assert_allclose(o["eval"][k], float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        d = r // (sp * sph)
        np.testing.assert_allclose(o["logits"], jlogits[d * B:(d + 1) * B],
                                   rtol=1e-4, atol=1e-5)


def _fired_key():
    """A key whose train draws (the JAX step's fold over the data axis, then
    fold_in 0 and split) apply the contrast on both data shards, with a
    flip and a clip left unflipped among them."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        draws = [_jax_train_draws(jax.random.split(jax.random.fold_in(
            jax.random.fold_in(key, d), 0))[0], B) for d in range(2)]
        flips = torch.cat([dr["do_flip"] for dr in draws])
        if all(bool((dr["fc"] != 1.0).any()) for dr in draws) \
                and bool(flips.any()) and not bool(flips.all()):
            return key, draws
    raise AssertionError("no key fires the contrast on both data shards")


def test_member_train_preprocess_matches_jax_whole_clip(monkeypatch):
    """Each member of (data 2, sp 2, sph 2) preprocesses its data shard's T
    chunk at full H on its data shard's draws, then cuts its H rows
    (preprocess_train's h_chunk), on a key whose contrast fires on both
    data shards: bit-identical to the port's preprocess of the whole clip,
    sliced to the member's T and H chunk, and within 2e-5 of coclr_tpu's
    preprocess_train (XLA branch) on the whole clip, sliced (the bar of
    test_torch_eval's whole-clip comparison: the two packages' float32
    chains differ by a few ULPs, up to 2.9e-6 here, as JAX's own jitted
    and eager runs differ by 7e-7). Cutting H before the preprocess (a
    chunk-local contrast mean) differs by more than 1e-3."""
    key, draws = _fired_key()
    # frames darker at the top than at the bottom, as a sky over a field:
    # the H chunks' luma means differ from the frame's
    u8 = (np.random.RandomState(13).randint(0, 128, (2 * B, T, S, S, 3))
          + 8 * np.arange(S)[:, None, None]).astype(np.uint8)
    jfn = jax.jit(lambda x, rng: jsteps.preprocess_train(x, rng, jnp.float32,
                                                         backend="xla"))
    t_loc, h_loc = T // 2, S // 2
    fired = 0
    for d in range(2):
        rng_aug = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(key, d), 0))[0]
        fired += _triggered(draws[d])
        monkeypatch.setattr(steps, "draw_train_preprocess",
                            lambda gen, b, d=d: dict(draws[d]))
        clips = u8[d * B:(d + 1) * B]
        want = np.asarray(jfn(jnp.asarray(clips), rng_aug))
        whole = steps.preprocess_train(_t(clips), None, torch.float32).numpy()
        for t in range(2):
            chunk = clips[:, t * t_loc:(t + 1) * t_loc]
            for h in range(2):
                rows = slice(h * h_loc, (h + 1) * h_loc)
                ref = want[:, t * t_loc:(t + 1) * t_loc, rows]
                got = steps.preprocess_train(_t(chunk), None, torch.float32,
                                             h_chunk=(h, 2)).numpy()
                np.testing.assert_array_equal(
                    got, whole[:, t * t_loc:(t + 1) * t_loc, rows])
                np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
                early = steps.preprocess_train(
                    _t(np.ascontiguousarray(chunk[:, :, rows])), None,
                    torch.float32).numpy()
                assert np.abs(early - ref).max() > 1e-3, (d, t, h)
    assert fired > 0


def test_probe_step_at_sp2_matches_jax_mesh(ranks, monkeypatch):
    """One linear-probe (`last`) SGD step at (data 2 x sp 2) against the JAX
    step on make_mesh(4, sp_size=2): the frozen backbone's forward runs its
    halos and sp_pmeans without autograd; its parameters and BatchNorm
    buffers stay bit-identical to the start on every rank; final_bn
    (affine and running statistics) and final_fc within 1e-5 of JAX's;
    the loss rtol 1e-4."""
    rng = np.random.RandomState(15)
    xs = [_clips(rng, 2 * B)]
    labels = [rng.randint(0, NC, 2 * B).astype(np.int32)]
    losses, want = _run_jax_train(2, 1, "last", xs, labels, monkeypatch)
    sd, _ = _weights("last")
    out = ranks.run("sp_classifier", dict(sp=2, sph=1, cfg=_kw("last"), sd=sd,
                                          num_class=NC, lr=LR, xs=xs,
                                          labels=labels))
    for r in out:
        np.testing.assert_allclose(r["metrics"][0]["loss"], losses[0],
                                   rtol=1e-4)
        for key, val in sd.items():
            if key.startswith("backbone."):
                assert np.array_equal(r["state"][key], val), key
    head = [k for k in want if not k.startswith("backbone.")
            and "num_batches" not in k]
    assert {k.split(".")[0] for k in head} == {"final_bn", "final_fc"}
    for key in head:
        np.testing.assert_allclose(out[0]["state"][key], want[key], atol=1e-5,
                                   rtol=0, err_msg=key)


def _samples(rng, n):
    """Samples of the in-memory datasets: frames darker at the top than at
    the bottom (so a chunk-local contrast mean would show), random labels
    of the 101-way head."""
    ramp = 8 * np.arange(S)[:, None, None]
    return [{"seq": (rng.randint(0, 128, (1, T, S, S, 3)) + ramp)
             .astype(np.uint8), "label": np.int64(rng.randint(0, 101))}
            for _ in range(n)]


def _jitter_seed():
    """A seed whose step draws (data rank 0, iterations 1 and 2) jitter some
    clip in each step."""
    gen = torch.Generator()
    for seed in range(100):
        fired = []
        for it in (1, 2):
            gen.manual_seed(step_seed(seed, it, 0))
            fired.append(_triggered(steps.draw_train_preprocess(gen, B)))
        if all(fired):
            return seed
    raise AssertionError("no seed jitters both steps")


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process run_classifier_train (`ft`, dropout 0.5, jitter on,
    SGD, 2 steps, a validation of 3 clips) that the sharded runs are held
    against: its configuration, data, model and info."""
    rng = np.random.RandomState(21)
    train, val = _samples(rng, 4), _samples(rng, 3)
    kw = dict(_kw("ft"), dropout=0.5, epochs=1, workers=1, print_freq=1,
              prefix="sp", schedule=(100,), seed=_jitter_seed())
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("cls_one"))
    try:
        model, _, info = driver.run_classifier_train(
            EvalConfig(**kw), _Samples(train), _Samples(val), device="cpu")
    finally:
        os.chdir(cwd)
    return kw, train, val, model, info


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    pool = RankPool(2, str(tmp_path_factory.mktemp("cls_sp_pair")))
    yield pool
    pool.close()


@pytest.mark.parametrize("sp,sph", [(2, 1), (1, 2)], ids=["sp2", "sph2"])
def test_run_classifier_train_on_two_ranks_equals_one_process(
        pair, one_process, sp, sph, tmp_path):
    """run_classifier_train (`ft`, dropout 0.5, jitter on, SGD) at (data 1 x
    sp 2), and at (data 1 x sph 2), on two ranks against the one-process
    port run on the same seed and data, 2 steps and a validation of 3
    clips: data rank 0's draws are the one-process draws, so the two
    members flip, jitter and drop out as the one process does, and at sph 2
    each preprocesses the whole frame before its H cut. The state within
    1e-4 of the one-process state, and each tensor's change from the start
    within 1e-3 of the largest element of the one-process change (the
    updates are 1e-5 to 0.2); the ranks' parameters bit-identical;
    the validation means rtol 1e-5 and its count 3 on both (not 6); rank 0
    alone printed the sequence-parallel line and wrote the checkpoint."""
    kw, train, val, one, info = one_process
    dirs = [tmp_path / f"r{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    out = pair.run("run_classifier", [dict(cfg=dict(kw, sp_size=sp,
                                                    sph_size=sph),
                                           workdir=str(d), train=train,
                                           val=val) for d in dirs])
    assert [o["steps"] for o in out] == [2, 2] == [len(info["step_s"])] * 2
    assert out[0]["digest"] == out[1]["digest"]
    start = driver.build_model(EvalConfig(**kw)).state_dict()
    for key, val_ in one.state_dict().items():
        if "num_batches" not in key:
            np.testing.assert_allclose(out[0]["state"][key], val_.numpy(),
                                       atol=1e-4, rtol=0, err_msg=key)
            moved = val_.numpy() - start[key].numpy()
            np.testing.assert_allclose(
                out[0]["state"][key] - start[key].numpy(), moved, rtol=0,
                atol=1e-3 * np.abs(moved).max(), err_msg=key)
    for o in out:
        assert o["val"]["count"] == info["val"]["count"] == 3
        for k in ("loss", "top1", "top5"):
            np.testing.assert_allclose(o["val"][k], info["val"][k], rtol=1e-5)
    line = ("(sequence-parallel x2)" if sp > 1
            else "(spatial-sequence-parallel x2)")
    assert line in out[0]["printed"]
    assert "sequence-parallel" not in out[1]["printed"]
    wrote = [glob.glob(str(d / "**" / "*.pth.tar"), recursive=True)
             for d in dirs]
    assert wrote[0] and not wrote[1]


def test_data_ranks_draw_apart_on_a_cpu_generator():
    """step_seed keeps the ranks' seeds (and the shared permutation's
    offset) apart in the low 32 bits, the only ones torch's CPU generator
    reads: the first draws of data ranks 0-7 at one iteration all differ,
    as do the permutation generator's, and rank 0's seed is the
    one-process seed."""
    from coclr_tpu_torch.train.pretrain import SHUFFLE_SEED

    gen = torch.Generator()
    firsts = set()
    for rank in range(8):
        for offset in (0, SHUFFLE_SEED):
            gen.manual_seed((step_seed(3, 5, rank) + offset) % (1 << 32))
            firsts.add(float(torch.rand((), generator=gen)))
    assert len(firsts) == 16
    assert step_seed(3, 5, 0) == step_seed(3, 5) == 3 * 1_000_003 + 5


def test_sp_size_that_does_not_divide_the_launch_raises(ranks, tmp_path):
    """run_classifier_train with sp_size 3 on 4 ranks raises ValueError on
    every rank before any work."""
    kw = dict(_kw("ft"), epochs=1, workers=1, sp_size=3)
    out = ranks.run("run_classifier", dict(cfg=kw, workdir=str(tmp_path),
                                           train=[], val=[]))
    for o in out:
        assert o.get("raised") == "ValueError", o
        assert "sp_size 3" in o["message"]


def test_one_process_test_with_sp_size_runs_unsharded(synth, tmp_path,
                                                      monkeypatch, capsys):
    """`main_classifier --test <classifier> --center_crop --sp_size 2` in
    one process (no launcher) runs the unsharded N-crop test: it starts no
    process group, prints no sequence-parallel line and writes the same
    probabilities as the same command without --sp_size."""
    from coclr_tpu_torch import main_classifier
    from coclr_tpu_torch.utils.checkpoint import save_checkpoint

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COCLR_META_ROOT", synth["meta_root"])
    flags = ["--net", "tiny", "--seq_len", str(T), "--img_dim", str(S),
             "--workers", "1", "--compute_dtype", "float32", "--data_root",
             synth["data_root"], "--device", "cpu", "--max_windows", "1"]
    cfg = main_classifier.cfg_from_args(main_classifier.parse_args(flags))
    model = driver.build_model(cfg)
    ckpt = str(tmp_path / "cls" / "model" / "epoch0.pth.tar")
    save_checkpoint({"epoch": 0, "state_dict": model.state_dict(),
                     "best_acc": 0.0, "iteration": 1}, filename=ckpt)
    probs = {}
    for extra in (["--sp_size", "2", "--sph_size", "2"], []):
        got = main_classifier.main(flags + ["--test", ckpt, "--center_crop"]
                                   + extra)
        assert set(got) == {"center"}
        with open(os.path.join(os.path.dirname(ckpt),
                               "epoch0.pth.tar-prob-center.json")) as f:
            probs[bool(extra)] = json.load(f)
    assert pdist._WORLD is None
    assert "sequence-parallel" not in capsys.readouterr().out
    assert probs[True] == probs[False] and probs[True]
