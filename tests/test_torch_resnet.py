"""The port's ResNet-2d3d (coclr_tpu_torch/backbones/resnet2d3d.py: r50 and
r3d50) against the JAX package on the CPU, at full depth and small spatial
size: weights carried both ways, the eval- and train-mode forward, the
gradients, the initializer, an InfoNCE step, a finetune step and the
checkpoint round trip.

Weights go from the port into coclr_tpu through coclr_tpu's own
flax_from_torch_* / moco_state_from_torch (no JAX init to compile) and come
back through the port's state_dict_from_jax; the JAX package's own
parameter tree (from jax.eval_shape of its init) maps onto the port's keys
one to one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coclr_tpu.backbones import select_backbone as jax_select_backbone
from coclr_tpu.config import PretrainConfig as JaxConfig
from coclr_tpu.evalsuite import steps as jsteps
from coclr_tpu.models import moco as jmoco
from coclr_tpu.models.encoder import ProjectionEncoder as JaxEncoder
from coclr_tpu.parallel.train_step import make_pretrain_step
from coclr_tpu.utils import torch_interop
from coclr_tpu_torch.backbones import ResNet2d3d, S3D, select_backbone
from coclr_tpu_torch.config import PretrainConfig
from coclr_tpu_torch.evalsuite import steps
from coclr_tpu_torch.kernels import pool
from coclr_tpu_torch.models.classifier import LinearClassifier
from coclr_tpu_torch.models.encoder import init_backbone_
from coclr_tpu_torch.models.moco import MoCo, l2_normalize
from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step
from coclr_tpu_torch.utils.checkpoint import make_payload, save_checkpoint
from coclr_tpu_torch.utils.interop import (backbone_state_dict_from_jax,
                                           classifier_state_dict_from_jax,
                                           encoder_state_dict_from_jax)
from test_torch_eval import _cfgs, _jax_train_draws, _pair, _t, _triggered
from test_torch_cuda import condition_resnet_
from test_torch_model import ncdhw, ndhwc

B, T, S = 2, 8, 32


def _source(net):
    """A port ResNet with well-conditioned random weights
    (test_torch_cuda.condition_resnet_)."""
    return condition_resnet_(select_backbone(net, dtype=torch.float32)[0])


@pytest.mark.parametrize("net", ["r50", "r3d50"])
def test_resnet_matches_jax_after_state_dict_from_jax(net):
    """Full depth, B=2, T=8, S=32, float32.
    - The JAX package's own parameter tree (eval_shape of its init) carried
      by backbone_state_dict_from_jax loads with strict=True, every shape
      equal; JAX variables made from a port ResNet by coclr_tpu's
      flax_from_torch_backbone come back bit for bit.
    - Eval-mode forward to atol 2e-4 (S3D's bar, tests/test_torch_model.py).
    - Train-mode forward (batch statistics) to atol 2e-4, and the running
      statistics after that one step (torch's unbiased running variance in
      both packages) to rtol 1e-4, atol 1e-6: the batch variance is
      E[x^2] - E[x]^2 in float32 over 32 to 16,384 elements, summed in
      another order on each side (measured up to 1.2e-5 relative in
      layer4 of r3d50).
    - r50: input and weight gradients of sum(sin(y)) in eval mode, the
      port in float32 against the JAX package in float64, to 1e-4 relative
      to the largest (the port measured 2.6e-6; the JAX package's own
      float32 CPU gradients sit 6e-3 from its float64 ones here, so they
      are not the reference). r3d50 differs from r50 only in the (3,1,1)
      conv1 of layers 1-2, whose gradient r50's layers 3-4 already hold;
      its float64 program (15 s of compile on one core) is left out."""
    jm, param = jax_select_backbone(net, dtype=jnp.float32)
    assert param["feature_size"] == select_backbone(net)[1]["feature_size"] == 2048
    x = np.random.RandomState(0).rand(B, T, S, S, 3).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jm.init(k, x, train=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   shapes)
    model, _ = select_backbone(net, dtype=torch.float32)
    from_init = backbone_state_dict_from_jax(zeros["params"],
                                             zeros["batch_stats"])
    model.load_state_dict(from_init, strict=True)
    for key, val in model.state_dict().items():
        assert val.shape == from_init[key].shape, key

    src = _source(net)
    v = torch_interop.flax_from_torch_backbone(
        {k: t.numpy().copy() for k, t in src.state_dict().items()})
    model.load_state_dict(backbone_state_dict_from_jax(v["params"],
                                                       v["batch_stats"]),
                          strict=True)
    for key, val in src.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(model.state_dict()[key], val), key

    @jax.jit
    def forward(v, x):
        y_eval = jm.apply(v, x, train=False)
        y_train, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return y_eval, y_train, mut["batch_stats"]

    want_eval, want_train, stats = jax.device_get(forward(v, jnp.asarray(x)))
    model.eval()
    xt = ncdhw(x).requires_grad_(True)
    y = model(xt)
    np.testing.assert_allclose(ndhwc(y), want_eval, atol=2e-4, rtol=1e-3)
    assert np.abs(want_eval).max() > 0.1

    train = _source(net).train()
    np.testing.assert_allclose(ndhwc(train(ncdhw(x))), want_train, atol=2e-4,
                               rtol=1e-3)
    want_sd = backbone_state_dict_from_jax(v["params"], stats)
    got_sd = train.state_dict()
    for key, val in want_sd.items():
        if "running" in key:
            np.testing.assert_allclose(got_sd[key].numpy(), val.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=key)
            assert not torch.equal(got_sd[key], src.state_dict()[key]), key
    if net != "r50":
        return

    torch.sin(y).sum().backward()
    with jax.enable_x64(True):
        m64, _ = jax_select_backbone(net, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        loss = lambda p, x: jnp.sum(jnp.sin(m64.apply(
            {"params": p, "batch_stats": v64["batch_stats"]}, x, train=False)))
        gp, gx = jax.device_get(jax.jit(jax.grad(loss, (0, 1)))(
            v64["params"], jnp.asarray(x, jnp.float64)))
    np.testing.assert_allclose(ndhwc(xt.grad), gx, atol=1e-4 * np.abs(gx).max())
    want_g = backbone_state_dict_from_jax(gp, {})
    for name, p in model.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_conv_init_is_kaiming_fan_out_for_resnet_only():
    """init_backbone_ draws ResNet-2d3d's convs from N(0, 2 / fan_out), fan_out
    = out channels x kernel volume (the JAX package's variance_scaling(2,
    'fan_out', 'normal')): in every conv of 4,096 weights or more the
    sample std is within 5 % of sqrt(2 / fan_out) (4.5 standard errors
    of a std estimated from 4,096 draws) and the mean within 10 % of it
    from 0 (6.4 standard errors). S3D keeps N(0, 0.01) (std within 5 %);
    the MoCo encoders and
    LinearClassifier draw through it; BN weight 1, bias 0; the draws come
    from the generator alone."""
    def check(backbone, std_of):
        n = 0
        for mod in backbone.modules():
            if isinstance(mod, torch.nn.Conv3d) and mod.weight.numel() >= 4096:
                w = mod.weight.detach().double()
                want = std_of(mod.weight)
                assert abs(float(w.std()) / want - 1) < 0.05, mod
                assert abs(float(w.mean())) < 0.1 * want, mod
                n += 1
            elif isinstance(mod, torch.nn.BatchNorm3d):
                assert torch.equal(mod.weight, torch.ones_like(mod.weight))
                assert torch.equal(mod.bias, torch.zeros_like(mod.bias))
        return n

    fan_out = lambda w: (2.0 / (w.shape[0] * w[0, 0].numel())) ** 0.5
    for net in ("r50", "r3d50"):
        bb, _ = select_backbone(net, dtype=torch.float32)
        init_backbone_(bb, torch.Generator().manual_seed(3))
        assert check(bb, fan_out) == 53
    moco = MoCo("r50", 8, 16, torch.float32)
    assert isinstance(moco.encoder_q[0], ResNet2d3d)
    assert check(moco.encoder_q[0], fan_out) == 53
    clf = LinearClassifier(num_class=5, network="r50", dtype=torch.float32)
    assert check(clf.backbone, fan_out) == 53
    torch.manual_seed(0)
    again = LinearClassifier(num_class=5, network="r50", dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(clf.parameters(),
                                                  again.parameters()))
    s3d = S3D(dtype=torch.float32)
    init_backbone_(s3d, torch.Generator().manual_seed(3))
    assert check(s3d, lambda w: 0.01) > 0


def _template(net, dim, K):
    """A MoCoState whose encoders moco_state_from_torch fills in."""
    return jmoco.MoCoState(params_q={}, stats_q={}, params_k={}, stats_k={},
                           queue=jnp.zeros((K, dim)), queue_ptr=jnp.int32(0),
                           step=jnp.int32(0))


def test_r50_infonce_step_matches_jax(tmp_path):
    """A port r50 MoCo, its backbone conditioned (condition_resnet_), encoder_k its
    copy and its queue holding the keys of 16 other clips (so that the
    negatives score near the positive and the loss, near log(17), moves
    with every logit), saved as a .pth.tar checkpoint, loads into coclr_tpu
    through moco_state_from_torch and gives the same keys (eval mode, 2e-5
    on unit-norm keys). Then one InfoNCE step at B=4, T=8, S=32, K=16, dim
    8, float32, on the same (already augmented) batch: the loss to rtol
    1e-5 (measured 5.5e-6), queue_ptr exact, the queue rows to 1e-5 after
    the enqueue; encoder_q's parameters to 3 lr (Adam's first update is
    about lr sign(g), and the train-mode gradient through 53 BatchNorms
    with float32 statistics is determined only to about 10 % in the worst
    tensor: the JAX package's own float32 gradient sits as far from its
    float64 convolutions, so near-zero elements can flip sign), encoder_k's
    to 1e-5, BN statistics to rtol 1e-4 (as above); no kernel launched
    (the CPU runs the pool's plain version). Later steps are not compared:
    Adam turns those flips into steps of 2 lr in many elements, and the
    losses part by 1e-3 within three steps."""
    lr, K, dim, b = 1e-3, 16, 8, 4
    model = MoCo("r50", dim, K, torch.float32,
                 gen=torch.Generator().manual_seed(5))
    condition_resnet_(model.encoder_q[0])
    model.encoder_k.load_state_dict(model.encoder_q.state_dict())
    rng = np.random.RandomState(0)
    model.eval()
    with torch.no_grad():
        model.queue.copy_(l2_normalize(model.encoder_k(ncdhw(
            rng.randn(K, T, S, S, 3).astype(np.float32)))))
    path = str(tmp_path / "epoch0.pth.tar")
    save_checkpoint(make_payload(model, torch.optim.Adam(
        model.encoder_q.parameters()), 0, 0.0, 0), filename=path)
    raw = torch_interop.load_torch_checkpoint(path)
    state = torch_interop.moco_state_from_torch(raw["state_dict"],
                                                _template("r50", dim, K))
    enc = JaxEncoder(network="r50", dim=dim, dtype=jnp.float32)
    x = rng.randn(b, T, S, S, 3).astype(np.float32)
    want = jax.jit(lambda p, s, x: enc.apply({"params": p, "batch_stats": s},
                                             x, train=False))(
        state.params_q, state.stats_q, jnp.asarray(x))
    with torch.no_grad():
        got = model.encoder_q(ncdhw(x))
    np.testing.assert_allclose(l2_normalize(got).numpy(),
                               np.asarray(jmoco.l2_normalize(want)), atol=2e-5)

    jcfg = JaxConfig(net="r50", model="infonce", seq_len=T, img_dim=S,
                     batch_size=b, moco_k=K, moco_dim=dim, lr=lr,
                     compute_dtype="float32")
    step, tx = make_pretrain_step(enc, jcfg, None, preprocess_fn=None,
                                  donate=False)
    opt_state = tx.init(state.params_q)
    model.train()
    cfg = PretrainConfig(net="r50", moco_k=K, moco_dim=dim, lr=lr,
                         compute_dtype="float32")
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    launches = pool.KERNEL.launches
    seq = rng.randn(b, 2, T, S, S, 3).astype(np.float32)
    state, opt_state, jm = step(state, opt_state, {"seq": jnp.asarray(seq)},
                                jax.random.PRNGKey(0), jnp.float32(lr))
    tm = pretrain_step(model, opt, torch.from_numpy(seq), lr, cfg)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert abs(float(jm["loss"]) - np.log(K + 1)) < 2.5
    assert pool.KERNEL.launches == launches

    assert int(model.queue_ptr) == int(state.queue_ptr) == b
    np.testing.assert_allclose(model.queue.numpy(), np.asarray(state.queue),
                               atol=1e-5)
    got = model.state_dict()
    for prefix, params, stats, atol in (
            ("encoder_q.", state.params_q, state.stats_q, 3 * lr),
            ("encoder_k.", state.params_k, state.stats_k, 1e-5)):
        want = encoder_state_dict_from_jax(*jax.device_get((params, stats)))
        for key, val in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            if "running" in key:
                np.testing.assert_allclose(got[prefix + key].numpy(),
                                           val.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=prefix + key)
            else:
                np.testing.assert_allclose(got[prefix + key].numpy(),
                                           val.numpy(), atol=atol,
                                           err_msg=prefix + key)


def test_r50_finetune_step_matches_jax(monkeypatch):
    """Two `ft` SGD steps of a LinearClassifier on r50 (B=4, T=8, S=32,
    dropout 0), its backbone conditioned (condition_resnet_), its head redrawn
    N(0, 0.01) (the reference's), each batch through the port's train
    preprocess on the JAX step's draws (test_torch_eval's method;
    coclr_tpu's preprocess is the identity on those clips). Losses to rtol
    1e-5 (measured 1e-7), top-1 exactly. After the two steps every
    parameter to atol 1e-4 and every BN statistic to rtol 1e-4 + atol
    1e-4, and the whole update (parameters minus their start) to 1 % in
    norm (measured 0.16 %): the train-mode gradient through 53 BatchNorms
    with float32 statistics is determined only to about 10 % in the worst
    tensor (the JAX package's own float32 gradient sits as far from its
    float64 convolutions as the port's), which at lr 0.05 moved single
    elements by up to 2.3e-5."""
    monkeypatch.setattr(jsteps, "preprocess_train", lambda x, rng, dtype: x)
    jcfg, cfg = _cfgs(net="r50", train_what="ft", optim="sgd", lr=0.05,
                      seq_len=T, img_dim=S)
    jmodel, state, model = _pair(jcfg, cfg, seed=4)
    condition_resnet_(model.backbone)
    with torch.no_grad():
        model.final_fc.weight.normal_(0.0, 0.01,
                                      generator=torch.Generator().manual_seed(6))
    v = torch_interop.flax_from_torch_classifier(
        {k: t.numpy().copy() for k, t in model.state_dict().items()})
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    train, _, tx = jsteps.make_classifier_steps(jmodel, jcfg, None)
    opt_state = tx.init(state.params)
    opt = steps.make_classifier_optimizer(cfg, model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(5)
    fired = 0
    for i in range(2):
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
    num = den = 0.0
    for key, val in want.items():
        if "num_batches" in key:
            continue
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), atol=1e-4,
                                   rtol=1e-4 if "running" in key else 0,
                                   err_msg=key)
        if "running" not in key:
            num += float(((got[key] - val) ** 2).sum())
            den += float(((val - start[key]) ** 2).sum())
    assert (num / den) ** 0.5 <= 1e-2
