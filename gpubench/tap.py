"""What the benchmark reads of the program's first steps, for the check of
`correct`: it stands in for coclr_tpu_torch.train.pretrain's module-level
`pretrain_step` for the first `n` calls of the loop and then puts the
program's own function back, so the measured window runs untouched.

For each of those calls it keeps the loss the step returns and, for the
first, the augmented clips it was given, the output of encoder_q's first
block (`stem`, by module name), the inputs and output of the first three
and the last launch of the pool-backward kernel (`pool`; all on the
host), and the parameters before it. After the first call it reads the
gradient as Adam took it from Adam's state (exp_avg / (1 - beta1), which
holds the weight-decay term); after the n-th, the change of every
parameter of encoder_q and the queue rows that n steps of the full batch
write.

`local` holds what the check works out again from the program's own
tensors (check.local_numbers): at the first call, the queries, keys and
queues that the port's moco.moco_logits is given (and for CoCLR what
moco.coclr_mask is given and returns), the queries' gradient, the loss,
and the queues and pointer after the step; at the second, encoder_k and
encoder_q before it and encoder_k after it.

`fault` plants faults that the check has to catch, for the tests and the
calibration (never in a benchmark run); several may be joined by '+':
'unchanged' (the step skips its update), 'half_batch' (the step sees the
first half of the batch, its mean taken over that half), 'altered' (one
clip of the augmentation's output negated before the step reads it),
'pool_scaled' (the pool-backward kernel's output halved in the first
step), 'loss_half' (the loss's mean taken over the first half of the
rows), 'ema_skipped' (encoder_k's EMA left out), 'enqueue_altered' (the
first key negated as it is enqueued).
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered", "pool_scaled", "loss_half",
          "ema_skipped", "enqueue_altered")


def _host(t):
    return t.detach().to("cpu", torch.float32).clone()


class StepTap:
    def __init__(self, module, n: int, fault: str = None, stem: str = None,
                 pool=None, moco=None):
        self.faults = set(fault.split("+")) if fault else set()
        if self.faults - set(FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.module = module
        self.n = n
        self.real = None
        self.calls = 0
        self.losses = []
        self.aug = None
        self.grad = {}
        self.delta = {}
        self.queue = None
        self.queue_rows = 0
        self.stem_name = stem
        self.stem = None
        self.pool_module = pool
        self.pool = []
        self.moco = moco
        self.local = {}
        self.ptr0 = 0
        self._p0 = None

    def install(self):
        self.real = self.module.pretrain_step
        self.module.pretrain_step = self
        return self

    def uninstall(self):
        if self.real is not None:
            self.module.pretrain_step = self.real

    def _watch_pool(self):
        """Keep every launch of the pool-backward kernel in the first step:
        (x, out, g, its dx, k, s, lo), on the device until the step ends."""
        launches = []
        real = self._pool_real = self.pool_module.pool1d_bwd

        def watched(x, out, g, k, s, lo):
            dx = real(x, out, g, k, s, lo)
            if "pool_scaled" in self.faults:
                dx = dx * 0.5
            launches.append((x, out, g, dx, k, s, lo))
            if len(launches) > 4:  # only the first three and the last stay
                launches[-2] = None
            return dx
        self.pool_module.pool1d_bwd = watched
        return launches

    def _keep_stem(self, module, inputs, output):
        self.stem = output.detach().to("cpu", torch.float32)

    def _watch_moco(self, first: bool):
        """Stand in for the port's moco functions for one step: catch what
        `local` holds (at the first step) and plant the moco faults.
        Returns the functions to put back."""
        moco, real = self.moco, {}
        for name in ("moco_logits", "coclr_mask", "infonce_loss",
                     "multi_nce_loss", "dequeue_and_enqueue",
                     "momentum_update"):
            real[name] = getattr(moco, name)
        local, faults = self.local, self.faults

        def moco_logits(q, k, queue, temperature):
            if first and "q" not in local:
                local.update(q=_host(q), k=_host(k), queue=_host(queue))
                if q.requires_grad:
                    q.register_hook(
                        lambda g: local.__setitem__("gq", _host(g)))
            return real["moco_logits"](q, k, queue, temperature)

        def coclr_mask(kf, vname, queue_second, queue_vname, queue_label,
                       topk):
            mask = real["coclr_mask"](kf, vname, queue_second, queue_vname,
                                      queue_label, topk)
            if first and "kf" not in local:
                local.update(kf=_host(kf), vname=_host(vname),
                             queue_second=_host(queue_second),
                             queue_vname=_host(queue_vname),
                             queue_label=_host(queue_label), mask=_host(mask))
            return mask

        def half(logits, *rest):
            h = logits.shape[0] // 2 if "loss_half" in faults else None
            return logits[:h], tuple(r[:h] for r in rest)

        def infonce_loss(logits):
            logits, _ = half(logits)
            return real["infonce_loss"](logits)

        def multi_nce_loss(logits, mask):
            logits, (mask,) = half(logits, mask)
            return real["multi_nce_loss"](logits, mask)

        def dequeue_and_enqueue(queue, queue_ptr, keys, **kw):
            if "enqueue_altered" in faults:
                keys = keys.clone()
                keys[0] = -keys[0]
            return real["dequeue_and_enqueue"](queue, queue_ptr, keys, **kw)

        def momentum_update(params_q, params_k, m):
            if "ema_skipped" not in faults:
                real["momentum_update"](params_q, params_k, m)

        for name, fn in (("moco_logits", moco_logits),
                         ("coclr_mask", coclr_mask),
                         ("infonce_loss", infonce_loss),
                         ("multi_nce_loss", multi_nce_loss),
                         ("dequeue_and_enqueue", dequeue_and_enqueue),
                         ("momentum_update", momentum_update)):
            setattr(moco, name, fn)
        return real

    def _queues(self, model, suffix=""):
        names = ["queue"]
        if hasattr(model, "queue_second"):
            names += ["queue_second", "queue_vname", "queue_label"]
        for name in names:
            self.local[name + suffix] = _host(getattr(model, name))

    def __call__(self, model, optimizer, batch, lr, cfg, **kw):
        i = self.calls
        self.calls += 1
        if i >= self.n:  # the loop still held this object: pass through
            return self.real(model, optimizer, batch, lr, cfg, **kw)
        named = list(model.encoder_q.named_parameters())
        key = "seq" if "seq" in batch else "seq_rgb"
        rows = batch[key].shape[0]
        self.queue_rows += rows
        if "altered" in self.faults:
            batch = dict(batch)
            seq = batch[key].clone()
            seq[0, 0] = -seq[0, 0]
            batch[key] = seq
        if i == 0:
            self.ptr0 = int(model.queue_ptr)
            self._p0 = {n: p.detach().clone() for n, p in named}
            self.aug = {k: batch[k].to("cpu", torch.float32)
                        for k in ("seq", "seq_rgb", "seq_flow") if k in batch}
        if i == 1:
            self.local["q0"] = [_host(p) for _, p in named]
            self.local["k0"] = [_host(p)
                                for p in model.encoder_k.parameters()]
        if "half_batch" in self.faults:
            half = batch[key].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        if "unchanged" in self.faults:
            kw = dict(kw, update=False)
        hook = launches = real_moco = None
        if i == 0 and self.stem_name:
            hook = model.encoder_q.get_submodule(self.stem_name) \
                .register_forward_hook(self._keep_stem)
        if i == 0 and self.pool_module is not None:
            launches = self._watch_pool()
        if self.moco is not None:
            real_moco = self._watch_moco(first=i == 0)
        try:
            out = self.real(model, optimizer, batch, lr, cfg, **kw)
        finally:
            if hook is not None:
                hook.remove()
            if real_moco is not None:
                for name, fn in real_moco.items():
                    setattr(self.moco, name, fn)
            if launches is not None:
                self.pool_module.pool1d_bwd = self._pool_real
                keep = {j % len(launches) for j in (0, 1, 2, -1)
                        if launches}
                self.pool = [tuple(t.to("cpu") if torch.is_tensor(t) else t
                                   for t in launches[j]) for j in sorted(keep)]
        self.losses.append(float(out["loss"]))
        if i == 0:
            beta1 = optimizer.param_groups[0]["betas"][0]
            for n, p in named:
                state = optimizer.state.get(p, {})
                m = state.get("exp_avg")
                self.grad[n] = (0.0 if m is None
                                else float(m.float().norm()) / (1 - beta1))
            if self.moco is not None:
                self._queues(model, "_after")
                self.local.update(loss=self.losses[0], rows=rows,
                                  ptr0=self.ptr0,
                                  ptr1=int(model.queue_ptr))
        if i == 1:
            self.local["k1"] = [_host(p)
                                for p in model.encoder_k.parameters()]
        if i == self.n - 1:
            for n, p in named:
                self.delta[n] = float((p.detach() - self._p0[n]).float().norm())
            self._p0 = None
            rows = (self.ptr0 + torch.arange(self.queue_rows)) \
                % model.queue.shape[0]
            self.queue = model.queue.detach()[rows.to(model.queue.device)].to(
                "cpu", torch.float32)
            self.uninstall()
        return out
