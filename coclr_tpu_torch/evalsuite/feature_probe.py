"""Linear probe on cached features, ported from
coclr_tpu/evalsuite/feature_probe.py (the reference's
eval/feature_linear_probe.py).

An optional BatchNorm (batch mean and biased variance in training, running
averages with momentum 0.1 in eval) and a Linear head over the retrieval
cache's features, trained by SGD with momentum 0.9 and L2 weight decay on
shuffled minibatches under the step LR; every `eval_freq` epochs the test
accuracy is taken, and the best epoch's per-video probabilities are
written as json. Everything runs on `device`; the minibatch order is drawn
from a generator there.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from coclr_tpu_torch.train.lr import step_schedule
from coclr_tpu_torch.utils import resolve_device


def init_lp(gen: torch.Generator, dim: int, num_class: int, use_bn: bool
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, stats): fc_kernel [dim, num_class] ~ N(0, 0.01), zero
    fc_bias; with use_bn, bn_scale 1, bn_bias 0 and stats mean 0, var 1."""
    params = {"fc_kernel": torch.randn(dim, num_class, generator=gen) * 0.01,
              "fc_bias": torch.zeros(num_class)}
    stats = {}
    if use_bn:
        params["bn_scale"] = torch.ones(dim)
        params["bn_bias"] = torch.zeros(dim)
        stats = {"mean": torch.zeros(dim), "var": torch.ones(dim)}
    return params, stats


def lp_forward(params, stats, x, train: bool):
    """Returns (logits, stats after this batch)."""
    if "bn_scale" in params:
        if train:
            mean = x.mean(dim=0)
            var = x.var(dim=0, unbiased=False)
            stats = {"mean": 0.9 * stats["mean"] + 0.1 * mean.detach(),
                     "var": 0.9 * stats["var"] + 0.1 * var.detach()}
        else:
            mean, var = stats["mean"], stats["var"]
        x = (x - mean) / torch.sqrt(var + 1e-5)
        x = x * params["bn_scale"] + params["bn_bias"]
    return x @ params["fc_kernel"] + params["fc_bias"], stats


def run_feature_probe(train_feature, train_label, test_feature, test_label,
                      test_vname=None, lr: float = 1.0, wd: float = 1e-3,
                      epochs: int = 100, batch_size: int = 1024,
                      schedule=(60, 80), normalize: bool = False,
                      final_bn: bool = False, eval_freq: int = 5,
                      seed: int = 0, prob_json_path: str = "",
                      device="cuda"):
    """Returns (best_acc, best_epoch); the head starts from init_lp's draw
    with `seed`."""
    device = resolve_device(device)
    if np.shape(train_feature)[0] == 0:
        raise ValueError("run_feature_probe: empty train feature set")
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    train_feature = as_t(train_feature, torch.float32)
    test_feature = as_t(test_feature, torch.float32)
    train_label = as_t(train_label, torch.long)
    test_label = as_t(test_label, torch.long)
    if normalize:
        train_feature, test_feature = (
            f / torch.clamp_min(torch.linalg.vector_norm(f, dim=1, keepdim=True),
                                1e-12) for f in (train_feature, test_feature))

    dim = train_feature.shape[-1]
    num_class = int(train_label.max()) + 1
    params, stats = init_lp(torch.Generator().manual_seed(seed), dim,
                            num_class, final_bn)
    params = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    stats = {k: v.to(device) for k, v in stats.items()}
    opt = torch.optim.SGD(list(params.values()), lr=lr, momentum=0.9,
                          weight_decay=wd)
    gen = torch.Generator(device).manual_seed(seed)

    n = train_feature.shape[0]
    batch_size = min(batch_size, n)  # tiny datasets: one full batch
    steps = -(-n // batch_size)

    @torch.no_grad()
    def evaluate(params, stats):
        logits, _ = lp_forward(params, stats, test_feature, train=False)
        acc = (logits.argmax(dim=1) == test_label).float().mean()
        return float(acc), torch.softmax(logits, dim=1)

    best_acc, best_epoch = 0.0, 0
    best = ({k: v.detach().clone() for k, v in params.items()}, dict(stats))
    for epoch in range(epochs):
        for group in opt.param_groups:
            group["lr"] = step_schedule(lr, epoch, schedule)
        perm = torch.randperm(n, generator=gen, device=device)
        # wrap-pad to a whole number of batches (pad < batch_size <= n)
        idx = torch.cat([perm, perm[:steps * batch_size - n]]).view(
            steps, batch_size)
        for batch_idx in idx:
            logits, new_stats = lp_forward(params, stats,
                                           train_feature[batch_idx], train=True)
            yb = train_label[batch_idx]
            loss = torch.mean(torch.logsumexp(logits, dim=1)
                              - logits.gather(1, yb[:, None])[:, 0])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            stats = new_stats
        if epoch % eval_freq == 0:
            acc, _ = evaluate(params, stats)
            if acc >= best_acc:
                best_acc, best_epoch = acc, epoch
                best = ({k: v.detach().clone() for k, v in params.items()},
                        dict(stats))
                print("Best acc: %.4f" % acc)

    print("Final best acc: %.4f" % best_acc)
    if prob_json_path and test_vname is not None:
        probs = evaluate(*best)[1].cpu().numpy()
        stat = {}
        for v, p in zip(test_vname, probs):
            if isinstance(v, (list, tuple)):
                v = v[0]
            stat[v] = p.tolist()
        os.makedirs(os.path.dirname(prob_json_path) or ".", exist_ok=True)
        with open(prob_json_path, "w") as fp:
            json.dump(stat, fp)
        print("prob saved to %s" % prob_json_path)
    return best_acc, best_epoch
