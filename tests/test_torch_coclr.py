"""The port's UberNCE and CoCLR slice against the JAX package, on the CPU with
the `tiny` net in float32: the masks and losses, three UberNCE steps, six
CoCLR steps through the queue-fill gate, the two-stream preprocess, the
checkpoint init paths (--pretrain and CoCLR's surgery), the frozen sampler,
and `python -m coclr_tpu_torch.main_coclr` end to end."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coclr_tpu.config import PretrainConfig as JaxConfig
from coclr_tpu.models import moco as jmoco
from coclr_tpu.models.encoder import ProjectionEncoder as JaxEncoder
from coclr_tpu.ops import augment as jaug
from coclr_tpu.parallel.train_step import make_pretrain_step
from coclr_tpu.train import init_surgery as jsurgery
from coclr_tpu.utils import torch_interop
from coclr_tpu_torch.config import PretrainConfig
from coclr_tpu_torch.models import moco as tmoco
from coclr_tpu_torch.models.moco import MoCo
from coclr_tpu_torch.ops.augment import augment_batch
from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step
from coclr_tpu_torch.train import init_surgery
from coclr_tpu_torch.utils.interop import (encoder_state_dict_from_jax,
                                           state_dict_from_jax)
from test_torch_kernels import _jax_draws

LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("topk", [0, 2])
def test_masks_losses_and_accuracy_match_jax(full, topk):
    """coclr_mask (siblings, and top-k mining only with a full queue),
    ubernce_mask and mask_accuracy exactly; multi_nce_loss and ubernce_loss
    to rtol 1e-6, on the same float32 inputs."""
    rng = np.random.RandomState(topk + 2 * full)
    b, K, d = 4, 16, 8
    kf = rng.randn(b, d).astype(np.float32)
    kf /= np.linalg.norm(kf, axis=1, keepdims=True)
    second = rng.randn(K, d).astype(np.float32)
    vsrc = np.array([0, 1, 2, 1], np.int32)
    qvname = rng.randint(0, 6, K).astype(np.int32)
    qlabel = np.ones(K, np.int32) if full else np.where(
        np.arange(K) < 12, 1, -1).astype(np.int32)
    assert (vsrc[:, None] == qvname[None, :]).any()  # siblings present
    want = jmoco.coclr_mask(jnp.asarray(kf), jnp.asarray(vsrc),
                            jnp.asarray(second), jnp.asarray(qvname),
                            jnp.asarray(qlabel), topk)
    got = tmoco.coclr_mask(_t(kf), _t(vsrc), _t(second), _t(qvname).long(),
                           _t(qlabel).long(), topk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    siblings = 1 + (vsrc[:, None] == qvname[None, :]).sum(1)
    mined = got.numpy().sum(1) - siblings
    assert (mined == (topk if full else 0)).all()

    logits = (rng.randn(b, 1 + K) * 3).astype(np.float32)
    np.testing.assert_allclose(
        float(tmoco.multi_nce_loss(_t(logits), got)),
        float(jmoco.multi_nce_loss(jnp.asarray(logits), want)), rtol=1e-6)
    for tm, jm in zip(tmoco.mask_accuracy(_t(logits), got),
                      jmoco.mask_accuracy(jnp.asarray(logits), want)):
        assert float(tm) == float(jm)

    labels = rng.randint(0, 3, b).astype(np.int32)
    qlab = np.where(qlabel == 1, rng.randint(0, 3, K), -1).astype(np.int32)
    jm = jmoco.ubernce_mask(jnp.asarray(labels), jnp.asarray(qlab))
    tm = tmoco.ubernce_mask(_t(labels), _t(qlab).long())
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(float(tmoco.ubernce_loss(_t(logits), tm)),
                               float(jmoco.ubernce_loss(jnp.asarray(logits), jm)),
                               rtol=1e-6)


def _jax_and_port(variant, K, dim, T, S, B, **cfg_kw):
    """One JAX state of `variant` on `tiny`, its step, and the port's MoCo
    loaded from it with strict=True."""
    jcfg = JaxConfig(net="tiny", model=variant, seq_len=T, img_dim=S,
                     batch_size=B, moco_k=K, moco_dim=dim, lr=LR,
                     compute_dtype="float32", **cfg_kw)
    enc = JaxEncoder(network="tiny", dim=dim, dtype=jnp.float32)
    state = jmoco.init_moco_state(jax.random.PRNGKey(0), enc, variant,
                                  np.zeros((1, T, S, S, 3), np.float32),
                                  dim=dim, K=K)
    if variant == "coclr":
        # without the head's biases the sampler's features of different
        # clips are far enough apart that the data, not float32 rounding,
        # decides the top-k
        head = {n: dict(state.params_s[n], bias=state.params_s[n]["bias"] * 0)
                for n in ("fc1", "fc2")}
        state = state.replace(params_s=dict(state.params_s, **head))
    step, tx = make_pretrain_step(enc, jcfg, None, preprocess_fn=None,
                                  donate=False)
    host = jax.device_get(state)
    extra = {}
    if variant in ("ubernce", "coclr"):
        extra["queue_label"] = host.queue_label
    if variant == "coclr":
        extra.update(params_s=host.params_s, stats_s=host.stats_s,
                     queue_second=host.queue_second,
                     queue_vname=host.queue_vname)
    model = MoCo("tiny", dim, K, torch.float32, variant=variant)
    model.load_state_dict(state_dict_from_jax(
        host.params_q, host.stats_q, host.params_k, host.stats_k, host.queue,
        queue_ptr=int(host.queue_ptr), **extra), strict=True)
    model.train()
    cfg = PretrainConfig(net="tiny", model=variant, moco_k=K, moco_dim=dim,
                         lr=LR, compute_dtype="float32", **cfg_kw)
    return state, step, tx.init(state.params_q), model, cfg


def _assert_encoders_match(model, state, q_atol=3 * LR):
    """Parameters as in test_three_infonce_steps_match_jax: query atol
    3 x lr (Adam's first steps), key 1e-5, BN statistics 1e-4."""
    for prefix, params, stats, atol in (
            ("encoder_q.", state.params_q, state.stats_q, q_atol),
            ("encoder_k.", state.params_k, state.stats_k, 1e-5)):
        want = encoder_state_dict_from_jax(*jax.device_get((params, stats)))
        got = model.state_dict()
        for key, val in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            tol = 1e-4 if key.endswith(("running_mean", "running_var")) \
                else atol
            np.testing.assert_allclose(got[prefix + key].numpy(), val.numpy(),
                                       atol=tol, err_msg=prefix + key)


def test_three_ubernce_steps_match_jax():
    """Three UberNCE steps from one JAX state on the same augmented batches:
    losses and accuracies rtol 1e-5, queue rows 1e-5, queue_label and
    queue_ptr exact, parameters as for InfoNCE."""
    K, dim, B, T, S = 16, 8, 4, 4, 16
    state, step, opt_state, model, cfg = _jax_and_port("ubernce", K, dim, T, S, B)
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    rng = np.random.RandomState(0)
    for i in range(3):
        seq = rng.randn(B, 2, T, S, S, 3).astype(np.float32)
        label = rng.randint(0, 3, B).astype(np.int32)
        state, opt_state, jm = step(
            state, opt_state, {"seq": jnp.asarray(seq), "label": jnp.asarray(label)},
            jax.random.PRNGKey(i), jnp.float32(LR))
        tm = pretrain_step(model, opt, {"seq": _t(seq), "label": _t(label)},
                           LR, cfg)
        for key in ("loss", "top1", "top5", "top1_self", "top5_self"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    np.testing.assert_array_equal(model.queue_label.numpy(),
                                  np.asarray(state.queue_label))
    assert int(model.queue_ptr) == int(state.queue_ptr) == 3 * B
    np.testing.assert_allclose(model.queue.numpy(), np.asarray(state.queue),
                               atol=1e-5)
    _assert_encoders_match(model, state)


def _clips(rng, B, T, S):
    """Float clips whose per-clip scale and colour differ, so that pooled
    features tell them apart."""
    return (rng.randn(B, 2, T, S, S, 3) * rng.uniform(0.2, 3, (B, 1, 1, 1, 1, 1))
            + rng.randn(B, 1, 1, 1, 1, 3) * 2).astype(np.float32)


def _jax_self_drop(key):
    """The JAX step's self-drop draw for step key `key`."""
    r = jax.random.split(jax.random.fold_in(key, 0), 3)[2]
    return bool(jax.random.uniform(r) < 0.9)


@pytest.mark.parametrize("reverse", [False, True])
def test_coclr_steps_through_the_queue_fill_match_jax(reverse):
    """K = 16, B = 4, topk = 2: steps 1-4 are gated (encoder_q's parameters
    bit-unchanged, queue_is_full 0), steps 5-6 update and mine top-k. The
    port takes JAX's self-drop draws and the loop's gate. Losses rtol 1e-5,
    queue_second 1e-5, queue_vname / queue_label / queue_ptr exact,
    parameters as for InfoNCE."""
    K, dim, B, T, S = 16, 8, 4, 4, 16
    state, step, opt_state, model, cfg = _jax_and_port(
        "coclr", K, dim, T, S, B, topk=2, reverse=reverse)
    from coclr_tpu_torch.train.pretrain import QueueFill

    opt = make_optimizer(cfg, model.encoder_q.parameters())
    fill = QueueFill(model)
    q0 = {k: v.clone() for k, v in model.encoder_q.named_parameters()}
    rng = np.random.RandomState(1)
    drops = []
    for i in range(6):
        batch = {"seq_rgb": _clips(rng, B, T, S),
                 "seq_flow": _clips(rng, B, T, S),
                 "vname": rng.randint(0, 6, B).astype(np.int32)}
        key = jax.random.PRNGKey(100 + i)
        state, opt_state, jm = step(state, opt_state,
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    key, jnp.float32(LR))
        drops.append(_jax_self_drop(key))
        assert fill.full == (i >= 4)
        tm = pretrain_step(model, opt, {k: _t(v) for k, v in batch.items()},
                           LR, cfg, drop_self=drops[-1], update=fill.full)
        fill.advance(B)
        for name in ("loss", "top1", "top5", "top1_self", "top5_self",
                     "queue_is_full"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-5, err_msg=f"step {i} {name}")
        assert float(tm["queue_is_full"]) == float(i >= 4)
        if i < 4:
            for k, v in model.encoder_q.named_parameters():
                assert torch.equal(v, q0[k]), k
    assert any(drops[4:])
    assert int(model.queue_ptr) == int(state.queue_ptr) == (6 * B) % K
    for name in ("queue_vname", "queue_label"):
        np.testing.assert_array_equal(getattr(model, name).numpy(),
                                      np.asarray(getattr(state, name)))
    np.testing.assert_allclose(model.queue_second.numpy(),
                               np.asarray(state.queue_second), atol=1e-5)
    np.testing.assert_allclose(model.queue.numpy(), np.asarray(state.queue),
                               atol=1e-5)
    _assert_encoders_match(model, state)


def test_two_stream_preprocess_matches_jax():
    """RGB and flow concatenated along frames, one set of jax.random draws
    for both (the JAX preprocess, XLA backend), split again. Bars of
    test_apply_aug_matches_augment_clips at full hue: median < 1e-4, mean
    < 3e-3."""
    rng = np.random.RandomState(5)
    B, T, S = 3, 3, 24
    batch = {"seq_rgb": rng.randint(0, 256, (B, 2, T, S, S, 3), np.uint8),
             "seq_flow": rng.randint(0, 256, (B, 2, T, S, S, 3), np.uint8),
             "aug_base": np.array([[1, 1], [1, 0], [0, 1]], np.uint8),
             "vname": np.arange(B, dtype=np.int32)}
    key = jax.random.PRNGKey(11)
    jfn = jaug.make_pretrain_preprocess(JaxConfig(compute_dtype="float32",
                                                  aug_backend="xla"))
    want = jfn({k: jnp.asarray(v) for k, v in batch.items()}, key)
    params = _jax_draws(key, batch["aug_base"], 2 * T)
    assert bool(params["do_blur"].any()) and bool((params["fh"] != 0).any())
    got = augment_batch({k: _t(v) for k, v in batch.items()}, params,
                        dtype=torch.float32)
    assert "aug_base" not in got
    np.testing.assert_array_equal(got["vname"].numpy(), batch["vname"])
    for name in ("seq_rgb", "seq_flow"):
        assert got[name].shape == (B, 2, T, S, S, 3)
        d = np.abs(got[name].numpy() - np.asarray(want[name]))
        assert np.median(d) < 1e-4 and d.mean() < 3e-3, (name, np.median(d),
                                                          d.mean())


def _write_reference_ckpt(path, seed, variant="infonce"):
    """A reference-layout .pth.tar from a JAX state whose encoder_k, queue
    and queue_ptr differ from its encoder_q and from a fresh state."""
    enc = JaxEncoder(network="tiny", dim=8, dtype=jnp.float32)
    sample = np.zeros((1, 4, 16, 16, 3), np.float32)
    state = jmoco.init_moco_state(jax.random.PRNGKey(seed), enc, variant,
                                  sample, dim=8, K=8)
    params_k = jax.tree_util.tree_map(lambda x: 0.5 * x + 0.1, state.params_k)
    state = state.replace(params_k=params_k, queue_ptr=jnp.int32(4))
    torch_interop.save_torch_checkpoint(
        path, torch_interop.torch_from_moco_state(state, variant))
    return state


def _port_encoder(model, prefix):
    return {k[len(prefix):]: v for k, v in model.state_dict().items()
            if k.startswith(prefix)}


def _assert_same_encoder(got, params, stats):
    want = encoder_state_dict_from_jax(*jax.device_get((params, stats)))
    for key, val in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], val), key


def test_pretrain_flag_and_coclr_surgery_match_jax(tmp_path, monkeypatch):
    """The same .pth.tar files through the port and through
    coclr_tpu.train.init_surgery. --pretrain through run_pretrain: the
    file's encoder_q goes into encoder_q and encoder_k, the queue stays
    fresh and queue_ptr 0 (the file's encoder_k, queue and queue_ptr are
    not taken). CoCLR: first file's encoder_q -> q and k, second's ->
    sampler, queues and queue_label untouched; missing files keep the
    random init."""
    from coclr_tpu_torch.train.pretrain import run_pretrain

    monkeypatch.chdir(tmp_path)
    first, second = str(tmp_path / "a.pth.tar"), str(tmp_path / "b.pth.tar")
    # the files' own states serve as the JAX side's templates
    template = _write_reference_ckpt(first, 1)
    template_coclr = _write_reference_ckpt(second, 2, "coclr")

    jstate = jsurgery.init_pretrain_weights(template, first)
    cfg = PretrainConfig(net="tiny", seq_len=4, img_dim=16, batch_size=2,
                         moco_k=8, moco_dim=8, epochs=0,
                         compute_dtype="float32", pretrain=first)
    model, _, _ = run_pretrain(cfg, loader=(), device="cpu")
    _assert_same_encoder(_port_encoder(model, "encoder_q."), jstate.params_q,
                         jstate.stats_q)
    _assert_same_encoder(_port_encoder(model, "encoder_k."), jstate.params_k,
                         jstate.stats_k)
    fresh = MoCo("tiny", 8, 8, torch.float32,
                 gen=torch.Generator().manual_seed(cfg.seed))
    assert torch.equal(model.queue, fresh.queue) and int(model.queue_ptr) == 0

    jstate = jsurgery.coclr_surgery(template_coclr, (first, second))
    model = MoCo("tiny", 8, 8, torch.float32, variant="coclr")
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith("queue")}
    init_surgery.coclr_surgery(model, (first, second))
    for prefix, params, stats in (("encoder_q.", jstate.params_q, jstate.stats_q),
                                  ("encoder_k.", jstate.params_k, jstate.stats_k),
                                  ("sampler.", jstate.params_s, jstate.stats_s)):
        _assert_same_encoder(_port_encoder(model, prefix), params, stats)
    for k, v in before.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert (model.queue_label == -1).all()

    sampler = {k: v.clone() for k, v in model.sampler.state_dict().items()}
    init_surgery.coclr_surgery(model, (str(tmp_path / "none"), first))
    init_surgery.init_pretrain_weights(model, str(tmp_path / "none"))
    _assert_same_encoder(_port_encoder(model, "encoder_q."), jstate.params_q,
                         jstate.stats_q)
    assert not all(torch.equal(model.sampler.state_dict()[k], v)
                   for k, v in sampler.items())


def test_sampler_stays_frozen_in_eval_mode():
    """model.train() leaves the sampler in eval mode; a CoCLR step leaves
    its parameters and BatchNorm buffers as they were."""
    torch.manual_seed(0)
    model = MoCo("tiny", 8, 8, torch.float32, variant="coclr")
    model.train()
    assert model.encoder_q.training and model.encoder_k.training
    assert not any(m.training for m in model.sampler.modules())
    assert not any(p.requires_grad for p in model.sampler.parameters())
    before = {k: v.clone() for k, v in model.sampler.state_dict().items()}
    cfg = PretrainConfig(net="tiny", model="coclr", moco_k=8, moco_dim=8,
                         compute_dtype="float32", topk=2)
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    batch = {"seq_rgb": torch.randn(2, 2, 4, 16, 16, 3),
             "seq_flow": torch.randn(2, 2, 4, 16, 16, 3),
             "vname": torch.tensor([0, 1], dtype=torch.int32)}
    pretrain_step(model, opt, batch, LR, cfg)
    for k, v in model.sampler.state_dict().items():
        assert torch.equal(v, before[k]), k
    model.eval()
    model.train()
    assert not model.sampler.training


@pytest.fixture(scope="module")
def synth2(tmp_path_factory):
    from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

    root = tmp_path_factory.mktemp("torch_synth2")
    out = make_synthetic_ucf(str(root), n_classes=2, n_groups=3, n_clips=2,
                             n_frames=12, size=(40, 48), flow=True)
    meta_root = root / "meta_root"
    meta_root.mkdir()
    os.symlink(out["root"], meta_root / "ucf101")
    (root / "data" / "UCF101").mkdir(parents=True)
    os.symlink(out["db_path"], root / "data" / "UCF101" / "ucf101_frame.lmdb")
    os.symlink(out["db_path_flow"],
               root / "data" / "UCF101" / "ucf101_tvl1_frame.lmdb")
    return {"meta_root": str(meta_root), "data_root": str(root / "data")}


def test_main_coclr_end_to_end_on_cpu_and_checkpoint_loads_into_jax(
        synth2, tmp_path, monkeypatch):
    """`python -m coclr_tpu_torch.main_coclr --device cpu` (in-process) on a
    two-stream synthetic LMDB: 2 steps of 4 samples, an epoch checkpoint
    that loads into coclr_tpu as a CoCLR state (sampler, queue_second,
    queue_vname, queue_label) and back into the port strictly; without
    --device and without CUDA it raises."""
    from coclr_tpu_torch import main_coclr
    from coclr_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  load_reference_state_dict)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COCLR_META_ROOT", synth2["meta_root"])
    argv = ["--net", "tiny", "--seq_len", "4", "--img_dim", "16",
            "--batch_size", "4", "--moco-k", "8", "--moco-dim", "8",
            "--epochs", "1", "--workers", "2", "--compute_dtype", "float32",
            "--print_freq", "1", "--data_root", synth2["data_root"],
            "--prefix", "cli", "--topk", "2"]
    main_coclr.main(argv + ["--device", "cpu"])
    ckpts = glob.glob(str(tmp_path / "log-cli" / "coclr-top2_k8_*" / "model"
                          / "epoch0.pth.tar"))
    assert len(ckpts) == 1

    raw = torch_interop.load_torch_checkpoint(ckpts[0])
    sd = raw["state_dict"]
    assert sd["queue_second"].shape == (8, 8) and int(sd["queue_ptr"][0]) == 0
    assert (sd["queue_label"] == 1).all() and sd["queue_label"].dtype == np.int64
    enc = JaxEncoder(network="tiny", dim=8, dtype=jnp.float32)
    template = jmoco.init_moco_state(jax.random.PRNGKey(1), enc, "coclr",
                                     np.zeros((1, 4, 16, 16, 3), np.float32),
                                     dim=8, K=8)
    state = torch_interop.moco_state_from_torch(sd, template, variant="coclr")
    np.testing.assert_array_equal(
        np.asarray(state.params_s["backbone"]["c1"]["conv"]["kernel"]),
        sd["sampler.0.c1.conv.weight"].transpose(2, 3, 4, 1, 0))
    np.testing.assert_array_equal(np.asarray(state.queue_second),
                                  sd["queue_second"].T)
    np.testing.assert_array_equal(np.asarray(state.queue_vname),
                                  sd["queue_vname"])
    np.testing.assert_array_equal(np.asarray(state.queue_label),
                                  sd["queue_label"])

    back = MoCo("tiny", 8, 8, torch.float32, variant="coclr")
    load_reference_state_dict(back, load_checkpoint(ckpts[0])["state_dict"])
    np.testing.assert_array_equal(back.queue_second.numpy(), sd["queue_second"].T)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main_coclr.main(argv)
