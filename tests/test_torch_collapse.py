"""The suspects of a CoCLR retrieval collapse held against the JAX package
from a checkpoint past the queue-fill gate, on the CPU at tiny width in
float32 (tests/torch_collapse_parity.py; the same comparison runs there at
full width on a checkpoint from the card): the eval-mode forward that
retrieval's extract_features runs, each package loading the checkpoint's
backbone itself, and three CoCLR steps from the whole checkpoint with
top-k mining on the same batches and self-drop draws."""

import numpy as np
import pytest
import torch

from coclr_tpu_torch.config import PretrainConfig
from coclr_tpu_torch.models.moco import MoCo
from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step
from coclr_tpu_torch.train.pretrain import QueueFill
from coclr_tpu_torch.utils.checkpoint import make_payload, save_checkpoint
from torch_collapse_parity import (coclr_steps, cosines, eval_features,
                                   normalize, state_diffs, update_diffs)

K, DIM, B, T, S, LR, TOPK = 8, 8, 4, 4, 16, 1e-3, 2


def _clips(rng, n=B):
    """Float clips whose per-clip scale and colour differ, so that pooled
    features tell them apart (test_torch_coclr.py's)."""
    return (rng.randn(n, 2, T, S, S, 3) * rng.uniform(0.2, 3, (n, 1, 1, 1, 1, 1))
            + rng.randn(n, 1, 1, 1, 1, 3) * 2).astype(np.float32)


def _batch(rng):
    return {"seq_rgb": _clips(rng), "seq_flow": _clips(rng),
            "vname": rng.randint(0, 6, B).astype(np.int32)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny CoCLR checkpoint the port trained past the gate: 5 steps of
    4 clips, K = 8, so steps 3-5 update and mine the top 2 (the sampler's
    head without biases, so that the data, not float32 rounding, decides
    the top-k, as in test_torch_coclr.py)."""
    model = MoCo("tiny", DIM, K, torch.float32,
                 gen=torch.Generator().manual_seed(3), variant="coclr")
    with torch.no_grad():
        for name, p in model.sampler.named_parameters():
            if not name.startswith("0.") and name.endswith("bias"):
                p.zero_()
    model.train()
    cfg = PretrainConfig(net="tiny", model="coclr", moco_k=K, moco_dim=DIM,
                         lr=LR, compute_dtype="float32", topk=TOPK)
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    fill = QueueFill(model)
    rng = np.random.RandomState(4)
    opened = 0
    for _ in range(5):
        opened += fill.full
        pretrain_step(model, opt, {k: torch.from_numpy(v) for k, v in
                                   _batch(rng).items()},
                      LR, cfg, drop_self=True, update=fill.full)
        fill.advance(B)
    assert opened == 3 and fill.full
    path = tmp_path_factory.mktemp("collapse") / "epoch0.pth.tar"
    save_checkpoint(make_payload(model, opt, 0, 0.0, 6), filename=str(path))
    return str(path)


def test_eval_forward_from_a_trained_checkpoint_matches_jax(trained):
    """16 normalized clips through both packages' retrieval classifier in
    eval mode (the running statistics the 5 steps left), the backbone
    loaded by each package from the checkpoint: cosine >= 0.9999 per clip,
    and the clips' features differ from one another."""
    rng = np.random.RandomState(6)
    clips = normalize(rng.randint(0, 256, (16, T, S, S, 3), np.uint8))
    port, want = eval_features(trained, clips, "tiny", T, S)
    assert port.shape == want.shape == (16, port.shape[1])
    assert cosines(port, want).min() >= 0.9999
    assert np.abs(port - port[:1]).max() > 1e-3


def test_coclr_steps_from_a_trained_checkpoint_match_jax(trained):
    """Three CoCLR steps from the checkpoint (full queue: every step mines)
    at B = 4 in both packages on the same batches and self-drop draws:
    losses and accuracies rtol 1e-5 (test_torch_coclr.py's bound); the
    port's update of each encoder_q tensor over the three steps within
    1e-3 of the JAX package's, relative to its norm (the losses see only
    the first two updates; a missing third update is off by about 1/3);
    encoder_k 1e-5, BatchNorm statistics 1e-4, the queues 1e-5, the queue
    names, fill flags and pointer equal (test_torch_coclr.py's bounds)."""
    rng = np.random.RandomState(7)
    got, want, model, state, before = coclr_steps(
        trained, [_batch(rng) for _ in range(3)], "tiny", K, DIM, TOPK, LR)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["queue_is_full"] == w["queue_is_full"] == 1.0
        for key in ("loss", "top1", "top5", "top1_self", "top5_self"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    u = update_diffs(model, state, before)
    assert u["worst"] <= 1e-3, u
    d = state_diffs(model, state)
    assert d["encoder_k.params"] <= 1e-5, d
    assert d["encoder_q.stats"] <= 1e-4 and d["encoder_k.stats"] <= 1e-4, d
    assert d["queue"] <= 1e-5 and d["queue_second"] <= 1e-5, d
    assert d["queue_vname_label_ptr_equal"], d
