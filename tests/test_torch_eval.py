"""The port's evaluation suite (coclr_tpu_torch/evalsuite) against the JAX
package, on the CPU with the `tiny` net (and a small S3D) in float32: the
train preprocess, LinearClassifier, the classifier steps, the eval step,
retrieval and its cache, the N-crop test, the feature probe, both merge
modes, and the eval CLIs end to end.

Random draws are made with jax.random as coclr_tpu makes them and fed to
the port's apply steps. Every test whose path runs the jitter asserts that
some clip's jitter applied. Weights go from the port into coclr_tpu
through coclr_tpu's own flax_from_torch_classifier and come back through
the port's classifier_state_dict_from_jax.
"""

import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coclr_tpu.config import EvalConfig as JaxEvalConfig
from coclr_tpu.data import hostaug as jhostaug
from coclr_tpu.data.datasets import UCF101LMDB as JaxUCF101LMDB
from coclr_tpu.evalsuite import driver as jdriver
from coclr_tpu.evalsuite import feature_probe as jprobe
from coclr_tpu.evalsuite import merge as jmerge
from coclr_tpu.evalsuite import ncrop as jncrop
from coclr_tpu.evalsuite import retrieval as jretrieval
from coclr_tpu.evalsuite import steps as jsteps
from coclr_tpu.ops import augment as jaug
from coclr_tpu.utils import torch_interop
from coclr_tpu_torch.config import EvalConfig
from coclr_tpu_torch.data import hostaug
from coclr_tpu_torch.data.datasets import UCF101LMDB
from coclr_tpu_torch.evalsuite import driver, feature_probe, merge, ncrop, retrieval, steps
from coclr_tpu_torch.models.classifier import dropout
from coclr_tpu_torch.parallel.train_step import to_ncdhw
from coclr_tpu_torch.utils.interop import classifier_state_dict_from_jax

T, S = 4, 16
TRAIN_STRENGTH = (0.4, 0.4, 0.4, 0.1)
EVAL_STRENGTH = (0.2, 0.2, 0.2, 0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    """The same configuration for both packages."""
    base = dict(net="tiny", dataset="ucf101", seq_len=T, img_dim=S,
                batch_size=4, epochs=1, workers=2, compute_dtype="float32",
                schedule=(100,), optim="sgd", lr=0.1, dropout=0.0)
    base.update(kw)
    return JaxEvalConfig(**base), EvalConfig(**base)


def _pair(jcfg, cfg, seed):
    """(JAX model, JAX state, port model) holding the same weights: the
    port's classifier with its convolutions redrawn He-scaled and its head
    N(0, 1) (the reference's N(0, 0.01) would make the outputs too flat to
    tell apart), carried into coclr_tpu by its own
    flax_from_torch_classifier (no JAX init to compile)."""
    model = driver.build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv3d):
                mod.weight.normal_(0.0, (2.0 / mod.weight[0].numel()) ** 0.5,
                                   generator=gen)
        model.final_fc.weight.normal_(generator=gen)
    # copies: the port updates its BN buffers in place, and JAX on the CPU
    # may read a numpy array's memory after the call that was given it
    variables = torch_interop.flax_from_torch_classifier(
        {k: v.numpy().copy() for k, v in model.state_dict().items()})
    state = jsteps.ClassifierState(params=variables["params"],
                                   batch_stats=variables["batch_stats"],
                                   step=jnp.zeros((), jnp.int32))
    return jdriver.build_model(jcfg), state, model


def _jax_eval_draws(key, m, p, strength):
    fb, fc, fs, fh, codes = jaug.eval_color_jitter_params(key, m, p, strength)
    return {k: _t(v) for k, v in zip(("fb", "fc", "fs", "fh", "orders"),
                                     (fb, fc, fs, fh, codes))}


def _jax_train_draws(rng, b):
    """The draws of coclr_tpu.evalsuite.steps.preprocess_train(x, rng)."""
    k_jit, k_flip = jax.random.split(rng)
    draws = _jax_eval_draws(k_jit, b, 0.3, TRAIN_STRENGTH)
    draws["do_flip"] = _t(jax.random.uniform(k_flip, (b,)) < 0.5)
    return draws


def _jax_ncrop_draws(key, m):
    """The per-clip draws of coclr_tpu.evalsuite.ncrop's prob_fn."""
    sb, sc, ss, sh = EVAL_STRENGTH
    out = {k: [] for k in ("fb", "fc", "fs", "fh", "orders")}
    for k in jax.random.split(key, m):
        apply = bool(jax.random.uniform(jax.random.fold_in(k, 0)) < 0.3)
        kb, kc, ks, kh, kperm = jax.random.split(k, 5)
        draw = lambda kk, lo, hi, idle: float(
            jax.random.uniform(kk, (), minval=lo, maxval=hi)) if apply else idle
        out["fb"].append(draw(kb, 1 - sb, 1 + sb, 1.0))
        out["fc"].append(draw(kc, 1 - sc, 1 + sc, 1.0))
        out["fs"].append(draw(ks, 1 - ss, 1 + ss, 1.0))
        out["fh"].append(draw(kh, -sh, sh, 0.0))
        perm = np.asarray(jax.random.permutation(kperm, 4))
        out["orders"].append(int(perm[0] | perm[1] << 2 | perm[2] << 4
                                 | perm[3] << 6))
    return {k: torch.tensor(v, dtype=torch.int32 if k == "orders"
                            else torch.float32) for k, v in out.items()}


def _triggered(draws):
    return int((draws["fb"] != 1.0).sum())


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

    root = tmp_path_factory.mktemp("torch_eval_synth")
    out = make_synthetic_ucf(str(root), n_classes=2, n_groups=3, n_clips=2,
                             n_frames=12, size=(40, 48), flow=False)
    meta_root = root / "meta_root"
    meta_root.mkdir()
    os.symlink(out["root"], meta_root / "ucf101")
    (root / "data" / "UCF101").mkdir(parents=True)
    os.symlink(out["db_path"], root / "data" / "UCF101" / "ucf101_frame.lmdb")
    return {"root": out["root"], "db_path": out["db_path"],
            "meta_root": str(meta_root), "data_root": str(root / "data")}


def _datasets(synth, cfg, mode, jpolicy, policy, max_windows=0):
    kw = dict(root=synth["root"], db_path=synth["db_path"], mode=mode,
              num_frames=cfg.seq_len, return_label=True, img_dim=cfg.img_dim,
              max_windows=max_windows)
    return (JaxUCF101LMDB(policy=jpolicy, **kw), UCF101LMDB(policy=policy, **kw))


def test_train_preprocess_matches_both_jax_branches():
    """apply_train_preprocess (uint8 flip, then the jitter kernel's plain
    version with gray off) against coclr_tpu's preprocess_train through the
    XLA chain and through the Pallas kernel (interpret mode), on JAX's own
    draws: float32 to atol 2e-5 (the two JAX branches agree to that; the
    contrast mean's summation order differs by ULPs)."""
    x = np.random.RandomState(3).randint(0, 256, (8, 3, S, S, 3), np.uint8)
    branches = {b: jax.jit(lambda x, rng, b=b: jsteps.preprocess_train(
        x, rng, jnp.float32, backend=b)) for b in ("xla", "pallas")}
    fired = flips = 0
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        draws = _jax_train_draws(rng, 8)
        fired += _triggered(draws)
        flips += int(draws["do_flip"].sum())
        got = steps.apply_train_preprocess(_t(x), draws, torch.float32).numpy()
        for backend, fn in branches.items():
            want = fn(jnp.asarray(x), rng)
            np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                       err_msg=backend)
    assert fired > 0 and flips > 0


def test_eval_jitter_draws_have_the_reference_distribution():
    """draw_eval_jitter_params: applied on about p of the clips, factors in
    [1 - v, 1 + v], hue in [-h, h], identity elsewhere, every op once in
    each packed order."""
    gen = torch.Generator().manual_seed(0)
    d = steps.draw_eval_jitter_params(gen, 4000, p=0.3, strength=TRAIN_STRENGTH)
    on = d["fb"] != 1.0
    assert abs(float(on.float().mean()) - 0.3) < 0.03
    for k in ("fb", "fc", "fs"):
        assert float(d[k][on].min()) >= 0.6 and float(d[k][on].max()) <= 1.4
        assert bool((d[k][~on] == 1.0).all())
    assert float(d["fh"].abs().max()) <= 0.1 and bool((d["fh"][~on] == 0).all())
    ops = torch.stack([(d["orders"] >> (2 * i)) & 3 for i in range(4)], 1)
    assert bool((ops.sort(1).values == torch.arange(4)).all())


@pytest.mark.parametrize("net,train_what", [("tiny", "last"), ("tiny", "ft"),
                                            ("s3d", "last")])
def test_classifier_forward_matches_jax(net, train_what):
    """LinearClassifier in train mode (the train_what policy: final_bn + L2
    for 'last' with the backbone's BN in eval mode, none for 'ft') and then
    in eval mode: logits and features to 1e-4 of their largest magnitude
    (float32; the N(0, 1) head puts S3D's logits near 20), the BN running
    statistics after the train pass (final_bn's unbiased running variance
    included) to 1e-5. classifier_state_dict_from_jax gives back the port's
    state dict exactly. S3D runs at T 8, 32 x 32 (its pools need that), in
    the train pass only (each JAX S3D program costs seconds to compile)."""
    s3d = net == "s3d"
    t, s = (8, 32) if s3d else (T, S)
    jcfg, cfg = _cfgs(net=net, train_what=train_what, seq_len=t, img_dim=s)
    jmodel, state, model = _pair(jcfg, cfg, seed=1)
    back = classifier_state_dict_from_jax(
        *jax.device_get((state.params, state.batch_stats)))
    assert back.keys() == model.state_dict().keys()
    assert all(torch.equal(v, back[k]) for k, v in model.state_dict().items())
    x = np.random.RandomState(2).randn(2 if s3d else 3, t, s, s, 3).astype(
        np.float32)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))

    @jax.jit
    def jax_forward(variables, x):
        (logits, feat), mut = jmodel.apply(
            variables, x, train=True, train_backbone=train_what != "last",
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        if s3d:
            return logits, feat, mut["batch_stats"], None
        evaluated, _ = jmodel.apply({"params": variables["params"],
                                     "batch_stats": mut["batch_stats"]},
                                    x, train=False)
        return logits, feat, mut["batch_stats"], evaluated

    jl, jf, jstats, jeval = jax_forward(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(x))
    model.train()
    tl, tf = model(to_ncdhw(_t(x)))
    close(tl.detach().numpy(), jl)
    close(tf.detach().numpy(), jf)
    want = classifier_state_dict_from_jax(jax.device_get(state.params),
                                          jax.device_get(jstats))
    got = model.state_dict()
    for key, val in want.items():
        if "running" in key:
            np.testing.assert_allclose(got[key].numpy(), val.numpy(),
                                       atol=1e-5, err_msg=key)
    if train_what == "last":
        assert not torch.equal(got["final_bn.running_var"],
                               torch.ones_like(got["final_bn.running_var"]))
        assert all(torch.equal(v, back[k]) for k, v in got.items()
                   if k.startswith("backbone."))
    if not s3d:
        model.eval()
        with torch.no_grad():
            close(model(to_ncdhw(_t(x)))[0].numpy(), jeval)


def test_dropout_is_inverted_and_drawn_from_the_generator():
    """Kept elements are scaled by 1 / (1 - rate), dropped ones are 0, about
    1 - rate are kept, and the mask is the generator's: the same seed gives
    the same mask, the global RNG plays no part; in train mode the model
    feeds the head the dropped-out feature."""
    h = torch.rand(64, 256) + 0.5
    a = dropout(h, 0.75, torch.Generator().manual_seed(3))
    torch.manual_seed(123)
    b = dropout(h, 0.75, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], h[kept] * 4.0)
    assert abs(float(kept.float().mean()) - 0.25) < 0.02
    assert torch.equal(dropout(h, 0.0, None), h)

    _, cfg = _cfgs(train_what="ft", dropout=0.5)
    model = driver.build_model(cfg).train()
    x = to_ncdhw(torch.rand(2, T, S, S, 3))
    logits, feat = model(x, torch.Generator().manual_seed(9))
    want = torch.nn.functional.linear(
        dropout(feat, 0.5, torch.Generator().manual_seed(9)),
        model.final_fc.weight, model.final_fc.bias)
    assert torch.allclose(logits, want)


@pytest.mark.parametrize("optim", ["sgd", "adam"])
@pytest.mark.parametrize("train_what", ["last", "ft"])
def test_three_classifier_steps_match_jax(train_what, optim, monkeypatch):
    """Three train steps from one state, dropout 0 in both packages. Each
    step's uint8 batch goes through the port's train preprocess on the
    draws coclr_tpu's step makes from its key (the preprocess itself is
    held against coclr_tpu's by the test above), and both steps take those
    clips: coclr_tpu's preprocess is swapped for the identity here, which
    keeps its jitter chain out of each step's compile. Losses to rtol 1e-5
    and top-1 exactly. SGD: every parameter and BN statistic to atol 1e-5
    after the three steps (lr 0.05 times float32 gradients whose sums run in
    another order). Adam's first steps turn ULP-level gradient differences
    into updates of up to lr, so Adam is held on loss and top-1 only.
    'last': the backbone's parameters and BN buffers are bit-identical to
    the start."""
    monkeypatch.setattr(jsteps, "preprocess_train", lambda x, rng, dtype: x)
    jcfg, cfg = _cfgs(train_what=train_what, optim=optim,
                      lr=0.05 if optim == "sgd" else 1e-3)
    jmodel, state, model = _pair(jcfg, cfg, seed=4)
    train, _, tx = jsteps.make_classifier_steps(jmodel, jcfg, None)
    opt_state = tx.init(state.params)
    opt = steps.make_classifier_optimizer(cfg, model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(5)
    fired = 0
    for i in range(3):
        seq = rng.randint(0, 256, (4, T, S, S, 3), np.uint8)
        label = rng.randint(0, 101, 4).astype(np.int32)
        key = jax.random.PRNGKey(10 + i)
        rng_aug, _ = jax.random.split(jax.random.fold_in(key, 0))
        draws = _jax_train_draws(rng_aug, 4)
        fired += _triggered(draws)
        x = steps.apply_train_preprocess(_t(seq), draws, torch.float32)
        state, opt_state, jm = train(state, opt_state,
                                     {"seq": jnp.asarray(x.numpy()),
                                      "label": jnp.asarray(label)},
                                     key, jnp.float32(cfg.lr))
        tm = steps.train_step(model, opt, x, _t(label).long(), cfg.lr)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(tm["top1"]) == float(jm["top1"])
    assert fired > 0

    got = model.state_dict()
    want = classifier_state_dict_from_jax(
        *jax.device_get((state.params, state.batch_stats)))
    for key, val in want.items():
        if train_what == "last" and key.startswith("backbone."):
            assert torch.equal(got[key], start[key]), key
        elif optim == "sgd" and "num_batches" not in key:
            np.testing.assert_allclose(got[key].numpy(), val.numpy(),
                                       atol=1e-5, err_msg=key)


def test_eval_step_with_valid_mask_matches_jax():
    """The eval step on a batch padded with 3 repeated rows and a valid
    mask: loss, top-1, top-5 and count equal JAX's (rtol 1e-5) and the
    unpadded batch's."""
    jcfg, cfg = _cfgs(train_what="ft")
    jmodel, state, model = _pair(jcfg, cfg, seed=6)
    _, jeval, _ = jsteps.make_classifier_steps(jmodel, jcfg, None)
    rng = np.random.RandomState(1)
    seq = rng.randint(0, 256, (5, T, S, S, 3), np.uint8)
    label = rng.randint(0, 101, 5).astype(np.int32)
    seq_p = np.concatenate([seq] + [seq[-1:]] * 3)
    label_p = np.concatenate([label] + [label[-1:]] * 3)
    valid = np.concatenate([np.ones(5), np.zeros(3)]).astype(np.float32)
    jm, _, _ = jeval(state, {"seq": jnp.asarray(seq_p),
                             "label": jnp.asarray(label_p),
                             "valid": jnp.asarray(valid)})
    padded, _, _ = steps.eval_step(
        model, steps.preprocess_eval(_t(seq_p), torch.float32), _t(label_p),
        _t(valid))
    exact, _, _ = steps.eval_step(
        model, steps.preprocess_eval(_t(seq), torch.float32), _t(label))
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(padded[k]), float(jm[k]), rtol=1e-5)
        np.testing.assert_allclose(float(padded[k]), float(exact[k]), rtol=1e-5)
    assert float(padded["count"]) == float(jm["count"]) == 5


def test_retrieval_features_recall_and_cache_match_jax(synth, tmp_path,
                                                       monkeypatch):
    """extract_features over the test split (every window: several batches
    of 4 clips, the last padded) through the eval jitter on JAX's draws for
    each batch: per-video features to atol 1e-5 (float32), labels and
    vnames equal. With the port's train-split features, recall@k equals
    JAX's nn_retrieval on the same features, and cache files written by
    either package read back equal by the other."""
    jcfg, cfg = _cfgs()
    jmodel, state, model = _pair(jcfg, cfg, seed=7)
    jpol = jhostaug.EvalClipPolicy(img_dim=S, mode="test", crop_where=5)
    pol = hostaug.EvalClipPolicy(img_dim=S, mode="test", crop_where=5)
    calls = []

    def jax_draw(gen, m, p, strength):
        draws = _jax_eval_draws(jax.random.fold_in(jax.random.PRNGKey(0),
                                                   len(calls)), m, p, strength)
        calls.append(_triggered(draws))
        return draws

    monkeypatch.setattr(retrieval, "draw_eval_jitter_params", jax_draw)
    jds, ds = _datasets(synth, cfg, "test", jpol, pol)
    want = jretrieval.extract_features(jmodel, state, jds, jcfg, clip_batch=4)
    got = retrieval.extract_features(model, ds, cfg, clip_batch=4)
    assert sum(calls) > 0 and len(calls) > 1
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    feats = {"test": got, "train": retrieval.extract_features(
        model, _datasets(synth, cfg, "train", jpol, pol)[1], cfg, clip_batch=4)}
    assert len(feats["test"][2]) == 4 and len(feats["train"][2]) == 8

    args = (feats["test"][0], feats["test"][1], feats["train"][0],
            feats["train"][1])
    assert retrieval.nn_retrieval(*args) == jretrieval.nn_retrieval(*args)

    for split, (f, l, v) in feats.items():
        retrieval.save_feature_cache(str(tmp_path / "port"), "ucf101", split,
                                     f, l, v)
        jretrieval.save_feature_cache(str(tmp_path / "jax"), "ucf101", split,
                                      f, l, v)
        for reader, d in ((jretrieval, "port"), (retrieval, "jax")):
            rf, rl, rv = reader.load_feature_cache(str(tmp_path / d), "ucf101",
                                                   split)
            np.testing.assert_array_equal(rf, f)
            np.testing.assert_array_equal(rl, l)
            assert rv == [[x] for x in v]


def test_ncrop_probabilities_match_jax(synth, tmp_path, monkeypatch):
    """The ten-crop test over the test split (2 windows a video: one batch
    of 8 clips per configuration), the per-clip jitter on JAX's per-clip
    draws: the center, five and ten prob jsons hold the same videos and
    probabilities to atol 1e-5 (float32), and the same accuracies."""
    jcfg, cfg = _cfgs(ten_crop=True)
    jmodel, state, model = _pair(jcfg, cfg, seed=8)
    draws = _jax_ncrop_draws(jax.random.fold_in(jax.random.PRNGKey(0), 0), 8)
    assert _triggered(draws) > 0
    monkeypatch.setattr(ncrop, "draw_eval_jitter_params",
                        lambda gen, m, p, strength: draws)

    def datasets(policy, jax_side):
        kw = dict(root=synth["root"], db_path=synth["db_path"], mode="test",
                  num_frames=T, return_label=True, img_dim=S, max_windows=2,
                  policy=policy)
        return JaxUCF101LMDB(**kw) if jax_side else UCF101LMDB(**kw)

    want = jncrop.run_ncrop_test(jmodel, state, jcfg,
                                 lambda p: datasets(p, True),
                                 str(tmp_path / "jax"), "ck", clip_batch=8)
    got = ncrop.run_ncrop_test(model, cfg, lambda p: datasets(p, False),
                               str(tmp_path / "port"), "ck", clip_batch=8)
    assert got == want and set(got) == {"center", "five", "ten"}
    for title in got:
        name = f"ck-prob-{title}.json"
        with open(tmp_path / "jax" / name) as f:
            jp = json.load(f)
        with open(tmp_path / "port" / name) as f:
            tp = json.load(f)
        assert sorted(jp) == sorted(tp) and len(tp) == 4
        for v in jp:
            np.testing.assert_allclose(tp[v]["mean_prob"], jp[v]["mean_prob"],
                                       atol=1e-5)
    probs = np.array([tp[v]["mean_prob"] for v in tp])
    assert probs.std(axis=1).min() > 1e-3  # not a flat softmax


def test_feature_probe_full_batch_matches_jax(tmp_path, monkeypatch):
    """run_feature_probe with final_bn, one full batch per epoch, from JAX's
    initial head: the same best accuracy and epoch, and the best epoch's
    probabilities to atol 1e-5 (float32; the batch order differs)."""
    rng = np.random.RandomState(0)
    f_tr = np.concatenate([rng.randn(30, 8) + 1, rng.randn(30, 8) - 1])
    l_tr = np.repeat(np.arange(2), 30)
    f_te = np.concatenate([rng.randn(10, 8) + 1, rng.randn(10, 8) - 1])
    l_te = np.repeat(np.arange(2), 10)
    vnames = [[f"Class{l}/v_{i}"] for i, l in enumerate(l_te)]
    kw = dict(test_vname=vnames, lr=0.1, epochs=12, batch_size=1024,
              schedule=(6, 9), final_bn=True, eval_freq=2, normalize=True)
    want = jprobe.run_feature_probe(f_tr, l_tr, f_te, l_te,
                                    prob_json_path=str(tmp_path / "j.json"),
                                    **kw)
    params, stats = jprobe.init_lp(jax.random.PRNGKey(0), 8, 2, True)
    monkeypatch.setattr(feature_probe, "init_lp", lambda *a: (
        {k: _t(v) for k, v in params.items()},
        {k: _t(v) for k, v in stats.items()}))
    got = feature_probe.run_feature_probe(
        f_tr, l_tr, f_te, l_te, prob_json_path=str(tmp_path / "t.json"),
        device="cpu", **kw)
    assert got == want
    with open(tmp_path / "j.json") as f:
        jp = json.load(f)
    with open(tmp_path / "t.json") as f:
        tp = json.load(f)
    assert sorted(jp) == sorted(tp)
    for v in jp:
        np.testing.assert_allclose(tp[v], jp[v], atol=1e-5)


def test_merge_modes_match_jax_exactly(tmp_path):
    """merge_prob (dict and list entries) and merge_sim (flow caches with an
    extra video dropped by the alignment) give exactly JAX's results."""
    rng = np.random.RandomState(0)
    classes = ["A", "B", "C"]
    names = [f"{classes[i % 3]}/v_{i}" for i in range(9)]
    p1 = {n: {"mean_prob": rng.dirichlet(np.ones(3)).tolist()} for n in names}
    p2 = {n: rng.dirichlet(np.ones(3)).tolist() for n in names}
    for name, d in (("p1.json", p1), ("p2.json", p2)):
        with open(tmp_path / name, "w") as f:
            json.dump(d, f)
    a = (str(tmp_path / "p1.json"), str(tmp_path / "p2.json"), classes)
    assert merge.merge_prob(*a) == jmerge.merge_prob(*a)

    def cache(d, ds, n_extra):
        for split, n in (("train", 12), ("test", 6)):
            vn = [f"{split}/v{i:02d}" for i in range(n + n_extra)]
            jretrieval.save_feature_cache(
                str(tmp_path / d), ds, split,
                rng.randn(len(vn), 5).astype(np.float32),
                rng.randint(0, 3, len(vn)), vn[::-1])

    cache("rgb", "ucf101", 0)
    cache("flow", "ucf101-f", 1)
    b = (str(tmp_path / "rgb"), str(tmp_path / "flow"), "ucf101")
    assert merge.merge_sim(*b) == jmerge.merge_sim(*b)


@pytest.mark.parametrize("entry", ["train", "test", "probe", "merge"])
def test_eval_entry_points_raise_without_cuda(entry, tmp_path, monkeypatch):
    from coclr_tpu_torch import feature_linear_probe, main_classifier
    from coclr_tpu_torch import merge_2stream_prob

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is taken")
    monkeypatch.chdir(tmp_path)
    call = {"train": lambda: main_classifier.main(["--net", "tiny"]),
            "test": lambda: main_classifier.main(["--test", "x.pth.tar",
                                                  "--retrieval"]),
            "probe": lambda: feature_linear_probe.main(["--test", "x"]),
            "merge": lambda: merge_2stream_prob.main(["--mode", "s"])}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_eval_cli_end_to_end_on_cpu(synth, tmp_path, monkeypatch):
    """The recipe with `--device cpu`: main_nce's checkpoint ->
    main_classifier --pretrain (ft, one epoch) -> --test --retrieval ->
    --test --ten_crop -> feature_linear_probe -> merge_2stream_prob in both
    modes. The classifier .pth.tar loads into coclr_tpu through
    flax_from_torch_classifier and gives the port's logits (atol 1e-5)."""
    from coclr_tpu_torch import (feature_linear_probe, main_classifier,
                                 main_nce, merge_2stream_prob)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COCLR_META_ROOT", synth["meta_root"])
    common = ["--net", "tiny", "--seq_len", str(T), "--img_dim", str(S),
              "--workers", "2", "--compute_dtype", "float32", "--data_root",
              synth["data_root"], "--device", "cpu"]
    main_nce.main(common + ["--batch_size", "2", "--moco-k", "8", "--moco-dim",
                            "8", "--epochs", "1", "--prefix", "nce"])
    (pre,) = glob.glob(str(tmp_path / "log-nce" / "*" / "model" / "epoch0.pth.tar"))

    eval_flags = common + ["--batch_size", "2", "--max_windows", "2"]
    model, _, info = main_classifier.main(
        eval_flags + ["--train_what", "ft", "--epochs", "1", "--pretrain", pre,
                      "--dropout", "0.5", "--print_freq", "1"])
    assert len(info["step_s"]) == 4 and np.isfinite(info["loss"])
    (cls,) = glob.glob(os.path.join(info["exp_path"], "model", "epoch0.pth.tar"))
    raw = torch_interop.load_torch_checkpoint(cls)
    pre_sd = torch.load(pre, weights_only=True)["state_dict"]
    assert raw["epoch"] == 0 and set(raw) >= {"best_acc", "iteration"}
    assert not np.array_equal(raw["state_dict"]["backbone.c1.conv.weight"],
                              pre_sd["encoder_q.0.c1.conv.weight"].numpy())

    jcfg = JaxEvalConfig(net="tiny", dataset="ucf101", seq_len=T, img_dim=S,
                         train_what="ft", compute_dtype="float32")
    jvars = torch_interop.flax_from_torch_classifier(raw["state_dict"])
    x = np.random.RandomState(0).randn(2, T, S, S, 3).astype(np.float32)
    jl, _ = jdriver.build_model(jcfg).apply(jvars, jnp.asarray(x), train=False)
    with torch.no_grad():
        tl, _ = model.cpu().eval()(to_ncdhw(_t(x)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)

    recall = main_classifier.main(eval_flags + ["--test", pre, "--retrieval"])
    assert set(recall) == {1, 5, 10, 20, 50}
    feat_dir = os.path.join(os.path.dirname(pre), "feature")
    assert len(glob.glob(os.path.join(feat_dir, "ucf101_*"))) == 6

    res = main_classifier.main(eval_flags + ["--train_what", "ft", "--test",
                                             cls, "--ten_crop"])
    assert set(res) == {"center", "five", "ten"}
    ten = cls + "-prob-ten.json"
    assert os.path.exists(ten)

    best_acc, _ = feature_linear_probe.main(
        ["--test", pre, "--epochs", "4", "--eval_freq", "1", "--lr", "0.1",
         "--final_bn", "--device", "cpu"])
    assert 0.0 <= best_acc <= 1.0
    lp = os.path.join(feat_dir, "epoch0.pth.tar-lp-ucf101-prob.json")
    assert os.path.exists(lp)

    a1, a2, am = merge_2stream_prob.main(
        ["--mode", "c", "--prob1", ten, "--prob2", cls + "-prob-center.json",
         "--class_ind",
         os.path.join(synth["root"], "ClassInd.txt"), "--device", "cpu"])
    assert all(0.0 <= a <= 1.0 for a in (a1, a2, am))
    flow_dir = str(tmp_path / "flowfeat")
    os.makedirs(flow_dir)
    for path in glob.glob(os.path.join(feat_dir, "ucf101_*")):
        shutil.copy(path, os.path.join(
            flow_dir, os.path.basename(path).replace("ucf101_", "ucf101-f_")))
    sim = merge_2stream_prob.main(["--mode", "s", "--prob1", feat_dir,
                                   "--prob2", flow_dir, "--device", "cpu"])
    assert sim == jmerge.merge_sim(feat_dir, flow_dir, "ucf101")
