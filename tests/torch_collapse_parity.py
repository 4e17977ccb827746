"""The port against the JAX package from one CoCLR checkpoint, on the CPU in
float32: the eval-mode forward that retrieval's extract_features runs in
each package (the classifier of `--test --retrieval` with the checkpoint's
backbone loaded by each package's own load_pretrained_backbone, no
jitter), and CoCLR steps from the whole checkpoint (the JAX state through
coclr_tpu.utils.torch_interop.moco_state_from_torch) on the same batches
and the same self-drop draws.

tests/test_torch_collapse.py runs it at tiny width. Alone, it holds a
full-width checkpoint, such as the one `python
tests/torch_collapse_probe.py` exports from the card
(`flowmining_state.pt`: encoder_q in float32, the sampler in bfloat16, the
queues; encoder_k is taken equal to encoder_q), on the drive's staged data,
which it stages again from the drive's seed (byte-identical in both
packages):

    JAX_PLATFORMS=cpu python tests/torch_collapse_parity.py \\
        --state flowmining_state.pt --seed 1 --work <new dir>

and prints one JSON line: the least per-clip cosine of the two packages'
features (also after centering them over the clips, as retrieval does),
their max abs difference, each step's metrics in both, and the largest
differences of the parameters, statistics and queues after the steps,
with how far the port's update of encoder_q is from the JAX package's;
and both packages' eval forward in bfloat16 against the float32 one; and
the steps again in bfloat16 in both packages: how far their updates of
encoder_q are apart, beside how far each is from its own float32 update.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from coclr_tpu.config import EvalConfig as JaxEvalConfig  # noqa: E402
from coclr_tpu.config import PretrainConfig as JaxConfig  # noqa: E402
from coclr_tpu.evalsuite import driver as jdriver  # noqa: E402
from coclr_tpu.evalsuite import steps as jsteps  # noqa: E402
from coclr_tpu.models import moco as jmoco  # noqa: E402
from coclr_tpu.models.encoder import ProjectionEncoder as JaxEncoder  # noqa: E402
from coclr_tpu.parallel.train_step import make_pretrain_step  # noqa: E402
from coclr_tpu.utils import torch_interop  # noqa: E402
from coclr_tpu_torch.config import EvalConfig, PretrainConfig  # noqa: E402
from coclr_tpu_torch.evalsuite import driver  # noqa: E402
from coclr_tpu_torch.models.moco import MoCo  # noqa: E402
from coclr_tpu_torch.parallel.train_step import (make_optimizer,  # noqa: E402
                                                 pretrain_step, to_ncdhw)
from coclr_tpu_torch.train.pretrain import QueueFill  # noqa: E402
from coclr_tpu_torch.utils.checkpoint import (load_checkpoint,  # noqa: E402
                                              load_reference_state_dict,
                                              reference_state_dict)

# the drive's shapes (README's configuration) and the comparison's sizes
DRIVE_K, DRIVE_T, DRIVE_S = 128, 32, 128
EVAL_CLIPS, STEPS, STEP_BATCH = 16, 3, 4
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(clips_u8):
    """uint8 [..., 3] -> float32, ImageNet-normalized (no jitter)."""
    return ((clips_u8.astype(np.float32) / 255.0 - IMAGENET_MEAN)
            / IMAGENET_STD).astype(np.float32)


def eval_features(ckpt, clips, net, T, S, dtype="float32"):
    """Features of normalized clips [N, T, S, S, 3] (float32, cast to
    `dtype` for both) through each package's retrieval classifier
    (train_what last: the L2-normalized pooled backbone) in eval mode in
    `dtype`, the backbone loaded from `ckpt` by each package. Returns
    (port [N, d], jax [N, d]) in float32."""
    kw = dict(net=net, dataset="ucf101", seq_len=T, img_dim=S, batch_size=4,
              compute_dtype=dtype, train_what="last")
    cfg, jcfg = EvalConfig(**kw), JaxEvalConfig(**kw)
    model = driver.build_model(cfg)
    # JAX's classifier state from the port's fresh one (no JAX init), then
    # JAX's own tolerant load of the checkpoint's backbone
    variables = torch_interop.flax_from_torch_classifier(
        {k: v.numpy().copy() for k, v in model.state_dict().items()})
    state = jsteps.ClassifierState(params=variables["params"],
                                   batch_stats=variables["batch_stats"],
                                   step=jnp.zeros((), jnp.int32))
    state = jdriver.load_pretrained_backbone(state, ckpt)
    driver.load_pretrained_backbone(model, ckpt)
    model.eval()
    jmodel = jdriver.build_model(jcfg)
    apply = jax.jit(lambda st, x: jmodel.apply(
        {"params": st.params, "batch_stats": st.batch_stats}, x,
        train=False)[1])
    port, want = [], []
    for i in range(0, len(clips), 4):
        x = clips[i:i + 4]
        with torch.no_grad():
            port.append(model(to_ncdhw(torch.from_numpy(x.copy()).to(
                cfg.dtype)))[1].float().numpy())
        want.append(np.asarray(apply(state, jnp.asarray(x.copy(), dtype)),
                               np.float32))
    return np.concatenate(port), np.concatenate(want)


def centered_cosines(a, ref):
    """Per-clip cosine of a's and ref's features after each set is centered
    on its mean over the clips (what retrieval compares: the clips'
    differences, not their shared direction)."""
    return cosines(a - a.mean(0, keepdims=True),
                   ref - ref.mean(0, keepdims=True))


def cosines(a, b):
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                               * np.linalg.norm(b, axis=1))


def self_drop(key):
    """The JAX step's self-drop draw for step key `key`."""
    r = jax.random.split(jax.random.fold_in(key, 0), 3)[2]
    return bool(jax.random.uniform(r) < 0.9)


def coclr_steps(ckpt, batches, net, K, dim, topk, lr, key0=100,
                dtype="float32"):
    """CoCLR steps from the whole checkpoint `ckpt` in both packages on the
    same float32 batches ({'seq_rgb', 'seq_flow': [B, 2, T, S, S, 3],
    'vname': [B]}) and the JAX step's self-drop draws; fresh Adam states.
    Returns (port metrics per step, JAX metrics per step, the port's MoCo,
    the JAX state, encoder_q's state dict before the steps)."""
    b, _, T, S = batches[0]["seq_rgb"].shape[:4]
    sd = load_checkpoint(ckpt)["state_dict"]
    model = MoCo(net, dim, K, getattr(torch, dtype), variant="coclr")
    load_reference_state_dict(model, sd)
    model.train()
    before = {k: v.clone() for k, v in model.encoder_q.state_dict().items()}
    cfg = PretrainConfig(net=net, model="coclr", moco_k=K, moco_dim=dim,
                         lr=lr, compute_dtype=dtype, topk=topk)
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    fill = QueueFill(model)

    enc = JaxEncoder(network=net, dim=dim, dtype=getattr(jnp, dtype))
    # the state's structure only: the checkpoint fills every field but the
    # step count, so JAX's init need not be compiled
    template = jax.eval_shape(lambda: jmoco.init_moco_state(
        jax.random.PRNGKey(0), enc, "coclr",
        np.zeros((1, T, S, S, 3), np.float32), dim=dim, K=K))
    state = torch_interop.moco_state_from_torch(
        {k: v.numpy().copy() for k, v in sd.items()}, template, "coclr")
    state = state.replace(step=jnp.zeros((), jnp.int32))
    jcfg = JaxConfig(net=net, model="coclr", seq_len=T, img_dim=S,
                     batch_size=b, moco_k=K, moco_dim=dim, lr=lr,
                     compute_dtype=dtype, topk=topk)
    step, tx = make_pretrain_step(enc, jcfg, None, preprocess_fn=None,
                                  donate=False)
    opt_state = tx.init(state.params_q)
    got, want = [], []
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(key0 + i)
        state, opt_state, jm = step(
            state, opt_state, {k: jnp.asarray(v.copy())
                               for k, v in batch.items()},
            key, jnp.float32(lr))
        tm = pretrain_step(model, opt, {k: torch.from_numpy(v.copy())
                                        for k, v in batch.items()},
                           lr, cfg, drop_self=self_drop(key),
                           update=fill.full)
        fill.advance(b)
        got.append({k: float(v) for k, v in tm.items()})
        want.append({k: float(jm[k]) for k in got[-1]})
    return got, want, model, state, before


def state_diffs(model, state):
    """Largest abs differences after the steps: encoder_q's and encoder_k's
    parameters and BatchNorm statistics (also relative to each tensor's
    largest magnitude, `_rel`), the two queues; and whether the queue
    names, fill flags and pointer are equal."""
    from coclr_tpu_torch.utils.interop import encoder_state_dict_from_jax

    out = {}
    got = model.state_dict()
    for prefix, params, stats in (
            ("encoder_q.", state.params_q, state.stats_q),
            ("encoder_k.", state.params_k, state.stats_k)):
        want = encoder_state_dict_from_jax(*jax.device_get((params, stats)))
        for kind, keys in (("params", [k for k in want if not k.endswith((
                "running_mean", "running_var", "num_batches_tracked"))]),
                           ("stats", [k for k in want if k.endswith((
                               "running_mean", "running_var"))])):
            out[prefix + kind] = max(
                float(np.abs(got[prefix + k].numpy() - want[k].numpy()).max())
                for k in keys)
            # relative to each tensor's largest magnitude (running
            # variances reach tens at full width)
            out[prefix + kind + "_rel"] = max(
                float(np.abs(got[prefix + k].numpy() - want[k].numpy()).max()
                      / max(float(np.abs(want[k].numpy()).max()), 1e-12))
                for k in keys)
    for name in ("queue", "queue_second"):
        out[name] = float(np.abs(getattr(model, name).numpy()
                                 - np.asarray(getattr(state, name))).max())
    out["queue_vname_label_ptr_equal"] = bool(
        np.array_equal(model.queue_vname.numpy(), np.asarray(state.queue_vname))
        and np.array_equal(model.queue_label.numpy(),
                           np.asarray(state.queue_label))
        and int(model.queue_ptr) == int(state.queue_ptr))
    return out


def port_params(model):
    """The port's encoder_q parameters (no statistics) in float64."""
    return {k: v.double() for k, v in model.encoder_q.state_dict().items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def jax_params(state):
    """The JAX state's params_q in the port's layout, float64."""
    from coclr_tpu_torch.utils.interop import encoder_state_dict_from_jax

    sd = encoder_state_dict_from_jax(*jax.device_get((state.params_q,
                                                      state.stats_q)))
    return {k: v.double() for k, v in sd.items() if not k.endswith((
        "running_mean", "running_var", "num_batches_tracked"))}


def update_gap(got, want, before):
    """||d_got - d_want|| / ||d_want|| of two updates (parameters after
    minus `before`) for each tensor, the worst of them (`worst`,
    `worst_name`) and over all of them at once (`all`)."""
    per, num, den = {}, 0.0, 0.0
    for k, w in want.items():
        b = before[k].double()
        dg, dw = got[k] - b, w - b
        n, d = float((dg - dw).norm() ** 2), float(dw.norm() ** 2)
        per[k] = (n / max(d, 1e-300)) ** 0.5
        num, den = num + n, den + d
    worst = max(per, key=per.get)
    return {"worst": per[worst], "worst_name": worst,
            "all": (num / den) ** 0.5, "tensors": len(per)}


def update_diffs(model, state, before):
    """How far the port's update of encoder_q's parameters over the steps
    (after minus `before`, encoder_q's state dict before them) is from the
    JAX package's (update_gap). A missing or wrong last optimizer step
    shows here, where the losses see only the updates before their
    step."""
    return update_gap(port_params(model), jax_params(state), before)


def state_to_ckpt(state_path, out_path, K, dim=128):
    """The card's export (torch_collapse_probe.export) as a reference-layout
    .pth.tar: encoder_k taken equal to encoder_q, the sampler's bfloat16
    values in float32."""
    payload = torch.load(state_path, map_location="cpu", weights_only=True)
    model = MoCo("s3d", dim, K, torch.float32, variant="coclr")
    model.encoder_q.load_state_dict(payload["encoder_q"])
    model.encoder_k.load_state_dict(payload["encoder_q"])
    model.sampler.load_state_dict({k: v.float() if v.is_floating_point()
                                   else v for k, v in
                                   payload["sampler_bf16"].items()})
    for k, v in payload["buffers"].items():
        getattr(model, k).copy_(v)
    torch.save({"state_dict": reference_state_dict(model), "epoch": 0},
               out_path)
    return payload["source"]


def stage(work, seed):
    """The drive's staging (drive_coclr_cycle.main) at README's drive
    configuration; returns (data_root, meta_root)."""
    from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

    data_root = os.path.join(work, "data")
    db = os.path.join(data_root, "UCF101", "ucf101_frame.lmdb")
    meta_root = os.path.join(work, "meta_root")
    if not os.path.exists(db):
        out = make_synthetic_ucf(
            os.path.join(work, "gen"), n_classes=4, n_groups=24, n_clips=6,
            n_frames=DRIVE_T + 16, size=(136, 180), flow=True,
            content="learnable", seed=seed, test_groups=3, in_memory=True)
        os.makedirs(os.path.dirname(db), exist_ok=True)
        os.replace(out["db_path"], db)
        os.replace(out["db_path_flow"],
                   os.path.join(data_root, "UCF101", "ucf101_tvl1_frame.lmdb"))
        os.makedirs(meta_root, exist_ok=True)
        link = os.path.join(meta_root, "ucf101")
        if not os.path.exists(link):
            os.symlink(os.path.join(work, "gen", "meta"), link)
    return data_root, meta_root


def staged_clips(data_root, dataset, split, T, S, n, windows=1):
    """uint8 clips [n, windows, T, S, S, 3] and their video rows: the first
    `windows` windows of the first n videos of the split, as the retrieval
    path decodes them (EvalClipPolicy, center crop)."""
    from coclr_tpu_torch.data import hostaug

    cfg = EvalConfig(net="s3d", dataset=dataset, seq_len=T, img_dim=S,
                     data_root=data_root)
    ds = driver.build_eval_dataset(
        cfg, split, policy=hostaug.EvalClipPolicy(img_dim=S, mode="test",
                                                  crop_where=5))
    out = []
    for i in range(n):
        seq = ds[i]["seq"]
        out.append(np.stack([seq[min(w, len(seq) - 1)]
                             for w in range(windows)]))
    return np.stack(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", required=True,
                    help="torch_collapse_probe.py's flowmining_state.pt")
    ap.add_argument("--seed", type=int, required=True,
                    help="the drive's seed (its staged data)")
    ap.add_argument("--work", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.work, exist_ok=True)
    T, S = DRIVE_T, DRIVE_S
    ckpt = os.path.join(args.work, "flowmining.pth.tar")
    source = state_to_ckpt(args.state, ckpt, DRIVE_K)
    data_root, meta_root = stage(args.work, args.seed)
    os.environ["COCLR_META_ROOT"] = meta_root

    clips = normalize(staged_clips(data_root, "ucf101", "test", T, S,
                                   EVAL_CLIPS)[:, 0])
    port, want = eval_features(ckpt, clips, "s3d", T, S)
    cos = cosines(port, want)
    result = {"source": source, "clips": len(clips),
              "eval_cosine_min": float(cos.min()),
              "eval_max_abs_diff": float(np.abs(port - want).max()),
              "eval_centered_cosine_min": float(
                  centered_cosines(port, want).min())}
    # both packages' bfloat16 eval forward against the float32 one: how
    # much of the clips' differences each keeps
    pb, jb = eval_features(ckpt, clips, "s3d", T, S, "bfloat16")
    result["bf16"] = {
        "port_vs_jax_cosine_min": float(cosines(pb, jb).min()),
        "port_vs_jax_centered_cosine_min": float(
            centered_cosines(pb, jb).min()),
        "port_vs_float32_centered_cosine": [
            float(c) for c in centered_cosines(pb, port)],
        "jax_vs_float32_centered_cosine": [
            float(c) for c in centered_cosines(jb, port)]}
    n = STEP_BATCH * STEPS
    rgb = normalize(staged_clips(data_root, "ucf101", "train", T, S, n, 2))
    flow = normalize(staged_clips(data_root, "ucf101-f", "train", T, S, n,
                                  2))
    batches = [{"seq_rgb": rgb[i:i + STEP_BATCH],
                "seq_flow": flow[i:i + STEP_BATCH],
                "vname": np.arange(i, i + STEP_BATCH, dtype=np.int32)}
               for i in range(0, n, STEP_BATCH)]
    steps_port, steps_jax, model, state, before = coclr_steps(
        ckpt, batches, "s3d", DRIVE_K, 128, 5, 1e-3)
    result.update(steps_port=steps_port, steps_jax=steps_jax,
                  diffs=state_diffs(model, state),
                  update=update_diffs(model, state, before))
    # the same steps in bfloat16: how far the packages' updates are apart,
    # beside how far each is from its own float32 update
    bport, bjax, bmodel, bstate, _ = coclr_steps(
        ckpt, batches, "s3d", DRIVE_K, 128, 5, 1e-3, dtype="bfloat16")
    pb, jb = port_params(bmodel), jax_params(bstate)
    result["bf16_steps"] = {
        "steps_port": bport, "steps_jax": bjax,
        "port_vs_jax": update_gap(pb, jb, before),
        "port_vs_float32": update_gap(pb, port_params(model), before),
        "jax_vs_float32": update_gap(jb, jax_params(state), before)}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
