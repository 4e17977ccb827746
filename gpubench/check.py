"""The check that decides `correct`: the program's first steps, as the run
drove them, against the plain reference (reference/), on the same inputs.

The reference starts from the seed: its own initial weights and queue
(drawn as the port draws them), the clips the loader handed the program
(each checked against what the benchmark made), and the augmentation's
draws worked out again from the seed. For CoCLR it runs the gated steps
that fill the queue itself, over the fill batches' clips. It then runs the
same steps in float32 with TF32 off (or, as the control, in fp8).

Numbers compared (each against a limit in limits/<cell>.json):
- `loader`: bytes that differ between the clips the loader handed over and
  the benchmark's own (exact: limit 0);
- `aug`: the largest absolute gap of the first step's augmented clips;
- `stem`: the relative gap (Frobenius) of the first step's output of
  encoder_q's first block (the STEM of the backbone's
  reference/nets/<net>.py), rows missing from the program's counted whole;
- `pool_bwd`: the largest gap of the pool-backward kernel's output at four
  of its first step's launches against reference/pool.py on the same
  inputs (exact); read only where the step launched the kernel (a backbone
  with no max pool launches none);
- `update_median`: by the median leaf of encoder_q, the gap between the
  norms of each parameter's change over the steps, over the larger of the
  reference leaf's and the median leaf's, leaving out leaves whose
  reference gradient is under a thousandth of the median leaf's (they move
  by round-off alone); `update` and `grad` (the first step's gradient as
  Adam took it) are the same by the worst leaf;
- at the first step, from the program's own query, keys and queues (so the
  network's amplification of rounding does not reach them): `loss_local`,
  the relative gap of the step's loss; `grad_q`, the relative gap
  (Frobenius) of the loss's gradient with respect to the queries;
  `enqueue`, the largest gap of
  the queues after the step against the queues before it with the step's
  keys written at the pointer, plus the slots and pointer that differ
  (exact);
- `ema`: at the second step, the gap (Frobenius, over all parameters) of
  encoder_k after it against the EMA of the program's own encoder_k and
  encoder_q before it, over the EMA's change;
- for CoCLR, the checkpoint that the timed call resumes from: `start`
  (encoder_q and the sampler as drawn; exact), `fill` (source ids and
  filled flags; exact) and `fill_keys` (the queues' keys against the
  reference's fill).
Also read, and not compared: each step's loss gap (`loss`, `loss1`...),
the keys (`keys`, `keys1`...), the gradient's gaps (`grad`,
`grad_median`), `update`, CoCLR's `mask` (the positives that differ from
the reference's on the program's own tensors) and `start_k` (encoder_k
against the reference's after its fill).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from gpubench.reference import augment as ref_aug
from gpubench.reference import models
from gpubench.reference import pool as ref_pool
from gpubench.reference import step as ref_step
from gpubench.reference.models import FP32, Precision, ref_name, round_fp8
from gpubench.reference.step import RefMoCo, drop_self_draw

FP8 = Precision(fp8=True)


class Readings:
    """What one side produced in the checked steps."""

    def __init__(self, losses, grad, delta, keys, aug, stem):
        self.losses, self.grad, self.delta = losses, grad, delta
        self.keys, self.aug, self.stem = keys, aug, stem

    @classmethod
    def of_tap(cls, tap):
        return cls(tap.losses, {ref_name(k): v for k, v in tap.grad.items()},
                   {ref_name(k): v for k, v in tap.delta.items()}, tap.queue,
                   tap.aug, tap.stem)


def _to_device(batch, key, device):
    return torch.from_numpy(np.ascontiguousarray(batch[key])).to(device)


def _views(batch, variant, seed, iteration, device, prec):
    """The reference's augmented views of a host batch at `iteration`:
    (views, the augmented clips, the step's seed)."""
    step = ref_aug.step_seed(seed, iteration)
    gen = torch.Generator(device).manual_seed(step)
    base = _to_device(batch, "aug_base", device)
    if variant == "infonce":
        aug = ref_aug.augment(_to_device(batch, "seq", device), base, gen)
    else:
        rgb = _to_device(batch, "seq_rgb", device)
        both = torch.cat([rgb, _to_device(batch, "seq_flow", device)], 2)
        aug = ref_aug.augment(both, base, gen)
    if prec.fp8:
        aug = round_fp8(aug)
    t = aug.shape[2] // (1 if variant == "infonce" else 2)
    views = {"x1": aug[:, 0, :t].permute(0, 4, 1, 2, 3).contiguous(),
             "x2": aug[:, 1, :t].permute(0, 4, 1, 2, 3).contiguous()}
    if variant == "coclr":
        views["f2"] = aug[:, 1, t:].permute(0, 4, 1, 2, 3).contiguous()
        views["vname"] = _to_device(batch, "vname", device).long()
    return views, aug, step


def fill_batches(cell, vnames):
    """The fill's host batches, from the benchmark's own clips by the
    source ids that the loader handed over (checked by `fill`)."""
    data = cell["dataset"]
    for ids in vnames:
        ids = np.asarray(ids)
        batch = {k: v[ids] for k, v in data.streams.items()}
        batch.update(aug_base=data.aug_base[ids], vname=ids)
        yield batch


def run_reference(cell, recorded, device, prec=FP32, start=None):
    """The reference's readings over the recorded steps' host batches, from
    its own initial state, or with `start` (CoCLR past its gate) after its
    own fill over the fill batches; with `start`, the Readings also carry
    the filled state (`filled`) for `start_and_fill`."""
    config, traffic, seed = cell["config"], cell["traffic"], cell["seed"]
    variant = traffic["variant"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = RefMoCo(config["net"], config["moco_dim"], config["moco_k"], seed,
                  variant, device)
    start_iteration, filled = 1, None
    if start is not None:
        for j, batch in enumerate(fill_batches(cell, start["vnames"])):
            views, _, _ = _views(batch, variant, seed, 1 + j, device, prec)
            ref.fill_step(views, config, prec)
            del views
        start_iteration = start["iteration"]
        filled = {"queue": ref.queue.cpu().clone(),
                  "queue_second": ref.queue_second.cpu().clone(),
                  "queue_vname": ref.queue_vname.cpu().clone(),
                  "queue_label": ref.queue_label.cpu().clone(),
                  "encoder_k": {n: p.detach().cpu().clone()
                                for n, p in ref.enc_k.named_parameters()}}
    p0 = {n: p.detach().clone() for n, p in ref.enc_q.named_parameters()}
    losses, keys, grad, aug0 = [], [], None, None
    for j, batch in enumerate(recorded):
        views, aug, step = _views(batch, variant, seed, start_iteration + j,
                                  device, prec)
        if j == 0:
            aug0 = aug.cpu()
        del aug
        if j == 0:
            with torch.no_grad():
                stem = models.stem(ref.enc_q, views["x1"], prec).cpu()
        loss, taken, k = ref.step(views, config["lr"], config, prec,
                                  drop_self=drop_self_draw(step))
        losses.append(loss)
        keys.append(k.cpu())
        if j == 0:
            grad = {n: float(g.norm()) for n, g in taken.items()}
        del views, taken
    delta = {n: float((p.detach() - p0[n]).norm())
             for n, p in ref.enc_q.named_parameters()}
    sizes = {n: p.numel() for n, p in ref.enc_q.named_parameters()}
    out = Readings(losses, grad, delta, torch.cat(keys), {"seq": aug0}, stem)
    out.sizes, out.filled = sizes, filled
    return out


def loader_mismatch(cell, recorded):
    """Bytes that differ between every recorded clip the loader handed over
    (and its flags and source ids) and the benchmark's own."""
    data = cell["dataset"]
    bad = 0
    for batch in recorded:
        j = batch["index"] % data.samples
        for key, arr in data.streams.items():
            bad += int(np.count_nonzero(batch[key] != arr[j]))
        bad += int(np.count_nonzero(batch["aug_base"] != data.aug_base[j]))
        if "vname" in batch:
            bad += int(np.count_nonzero(batch["vname"] != j))
    return bad


def _rows_apart(got, want):
    """(largest, median) distance between the rows of two [K, d] tables."""
    dist = (got.float() - want.float()).norm(dim=1)
    return float(dist.max()), float(dist.median())


def start_and_fill(cell, start, filled) -> dict:
    """The checkpoint that the timed CoCLR call resumes from, against the
    reference after its own fill (`filled`, from run_reference): `start`,
    the largest gap of encoder_q and the sampler from the reference's own
    initial ones (the gated steps must leave them as drawn; exact);
    `start_k`, by the worst leaf, the relative gap (Frobenius) of
    encoder_k; `fill`, the slots whose source id or filled flag differ
    (exact); `fill_keys`, the largest distance of a row of either queue
    from the reference's (unit vectors), with its median row
    (`fill_keys_median`) and, for what a queue left as drawn would read,
    `fill_keys_as_drawn`."""
    config, state = cell["config"], start["state"]
    ref = RefMoCo(config["net"], config["moco_dim"], config["moco_k"],
                  cell["seed"], "coclr", "cpu")
    worst = 0.0
    for prefix, enc in (("encoder_q.", ref.enc_q), ("sampler.", ref.sampler)):
        mine = dict(enc.named_parameters())
        for key, val in state.items():
            name = key[len(prefix):]
            if key.startswith(prefix) and ref_name(name) in mine:
                ref_val = mine[ref_name(name)].detach()
                worst = max(worst, float((val.float() - ref_val).abs().max()))
    start_k = 0.0
    for key, val in state.items():
        if key.startswith("encoder_k.") and \
                ref_name(key[10:]) in filled["encoder_k"]:
            want = filled["encoder_k"][ref_name(key[10:])].float()
            start_k = max(start_k, float((val.float() - want).norm())
                          / max(float(want.norm()), 1e-30))
    fill = int((state["queue_vname"] != filled["queue_vname"]).sum()) + int(
        (state["queue_label"] != filled["queue_label"]).sum())
    out = {"start": worst, "start_k": start_k, "fill": float(fill)}
    far = med = drawn = 0.0
    for name, drawn_table in (("queue", ref.queue),
                              ("queue_second", ref.queue_second)):
        got = state[name].t()  # the checkpoint keeps queues as [dim, K]
        a, b = _rows_apart(got, filled[name])
        far, med = max(far, a), max(med, b)
        drawn = max(drawn, _rows_apart(drawn_table, filled[name])[0])
    out.update(fill_keys=far, fill_keys_median=med, fill_keys_as_drawn=drawn)
    return out


def _leaf_gaps(got: dict, want: dict, keep=None):
    """(worst, median, the worst leaf's name) over leaves of |norm got -
    norm want| / max(norm want, the median leaf's norm)."""
    names = [n for n in want if keep is None or n in keep]
    median = statistics.median(want[n] for n in names)
    gaps = {n: abs(got.get(n, 0.0) - want[n]) / max(want[n], median, 1e-30)
            for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], statistics.median(gaps.values()), worst


def aug_gap(got: dict, want: dict, device, chunk: int = 4) -> float:
    """Largest absolute gap between two sides' augmented clips."""
    worst = 0.0
    for key, w in want.items():
        if key == "seq" and "seq" not in got:
            g = torch.cat([got["seq_rgb"], got["seq_flow"]], 2)
        else:
            g = got[key]
        for lo in range(0, w.shape[0], chunk):
            a = g[lo:lo + chunk].to(device)
            b = w[lo:lo + chunk].to(device)
            worst = max(worst, float((a - b).abs().max()))
    return worst


def pool_gap(launches, device) -> float:
    """Largest gap between the pool-backward kernel's output at the watched
    launches of the first step and the reference's from the same inputs;
    the program's own x, out and g, so the network's amplification of
    rounding does not reach it (exact: one rounding of the same sum)."""
    worst = 0.0
    for x, out, g, dx, k, s, lo in launches:
        want = ref_pool.pool1d_bwd(x.to(device), out.to(device), g.to(device),
                                   k, s, lo)
        worst = max(worst, float((dx.to(device).float()
                                  - want.float()).abs().max()))
    return worst


def stem_gap(got, want, device) -> float:
    """||got - want|| / ||want|| of the first block's outputs, rows that
    `got` lacks counted whole."""
    num = den = 0.0
    for lo in range(0, want.shape[0], 4):
        w = want[lo:lo + 4].to(device)
        g = got[lo:lo + 4].to(device) if got is not None else None
        den += float(w.square().sum())
        rows = 0 if g is None else g.shape[0]
        if rows:
            num += float((g - w[:rows]).square().sum())
        num += float(w[rows:].square().sum())
    return (num / den) ** 0.5


def numbers(got: Readings, want: Readings, device) -> dict:
    """The numbers of one side (`got`) against the reference: those the
    limits compare and the finer readings they were chosen from. Floats
    only; the worst leaves' names are in `worst_leaves`."""
    median = statistics.median(want.grad.values())
    moved = {n for n, g in want.grad.items() if g >= 1e-3 * median}
    out = {"aug": aug_gap(got.aug, want.aug, device),
           "stem": stem_gap(got.stem, want.stem, device)}
    steps = min(len(got.losses), len(want.losses))
    per_step = [abs(got.losses[i] - want.losses[i]) / abs(want.losses[i])
                for i in range(steps)]
    out["loss"] = max(per_step)
    for i, gap in enumerate(per_step):
        out["loss%d" % (i + 1)] = gap
    out["grad"], out["grad_median"], _ = _leaf_gaps(got.grad, want.grad)
    out["update"], out["update_median"], leaf = _leaf_gaps(
        got.delta, want.delta, moved)
    out["update_leaf_size"] = float(want.sizes[leaf]) \
        if getattr(want, "sizes", None) else 0.0
    out["update_leaves_out"] = float(len(want.grad) - len(moved))
    dist = (got.keys - want.keys).norm(dim=1)
    out["keys"] = float(dist.max())
    rows = len(dist) // max(steps, 1)
    for i in range(steps):
        out["keys%d" % (i + 1)] = float(dist[i * rows:(i + 1) * rows].max())
    return out


def worst_leaves(got: Readings, want: Readings) -> dict:
    """The names of the worst leaves of `grad` and `update`."""
    median = statistics.median(want.grad.values())
    moved = {n for n, g in want.grad.items() if g >= 1e-3 * median}
    return {"grad": _leaf_gaps(got.grad, want.grad)[2],
            "update": _leaf_gaps(got.delta, want.delta, moved)[2]}


def local_numbers(cap: dict, cell: dict, device) -> dict:
    """The first step's loss, its gradient to the queries, CoCLR's
    positives and the enqueue, and the second step's EMA, each worked out
    again from the program's own tensors as the tap caught them (tap.py)."""
    config, seed = cell["config"], cell["seed"]
    out = {}

    def dev(name):
        return cap[name].to(device)

    q = dev("q").requires_grad_(True)
    mask = None
    if "kf" in cap:
        mask = ref_step.coclr_mask(dev("kf"), dev("vname").long(),
                                   dev("queue_second"),
                                   dev("queue_vname").long(),
                                   dev("queue_label").long(), config["topk"])
        out["mask"] = float((mask != dev("mask")).sum())
    step = ref_aug.step_seed(seed, cap["iteration"])
    loss = ref_step.contrastive_loss(q, dev("k"), dev("queue"),
                                     config["moco_t"], mask,
                                     drop_self_draw(step))
    (gq,) = torch.autograd.grad(loss, q)
    loss = float(loss.detach())
    out["loss_local"] = abs(cap["loss"] - loss) / abs(loss)
    got = dev("gq") if "gq" in cap else torch.zeros_like(gq)
    out["grad_q"] = float((got - gq).norm() / gq.norm())
    k, K = dev("k"), cap["queue"].shape[0]
    rows = (cap["ptr0"] + torch.arange(k.shape[0], device=device)) % K
    gap, slots = 0.0, int((cap["ptr1"] - cap["ptr0"] - cap["rows"]) % K != 0)
    tables = [("queue", k)]
    if "kf" in cap:
        tables.append(("queue_second", dev("kf")))
    for name, written in tables:
        want = dev(name).clone()
        want[rows] = written
        gap = max(gap, float((dev(name + "_after") - want).abs().max()))
    if "kf" in cap:
        for name, written in (("queue_vname", dev("vname").long()),
                              ("queue_label", torch.ones_like(rows))):
            want = dev(name).long().clone()
            want[rows] = written
            slots += int((dev(name + "_after").long() != want).sum())
    out["enqueue"] = gap + slots
    if "k1" not in cap:
        return out
    num = den = 0.0
    m = config["moco_m"]
    for k0, q0, k1 in zip(cap["k0"], cap["q0"], cap["k1"]):
        k0, q0, k1 = (t.to(device, torch.float64) for t in (k0, q0, k1))
        ema = m * k0 + (1 - m) * q0
        num += float((k1 - ema).square().sum())
        den += float((ema - k0).square().sum())
    out["ema"] = (num / max(den, 1e-300)) ** 0.5
    return out


def judge(values: dict, limits: dict):
    """(correct, {name: {value, limit}}) over the numbers that have a
    limit; a number without one is not compared, and a limit whose number
    was not read (value None) fails."""
    names = [k for k in values if k in limits] + [
        k for k in limits if k not in values]
    shown = {k: {"value": values.get(k), "limit": limits[k]} for k in names}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in shown.values()) and bool(shown)
    return ok, shown
