"""One bfloat16 (and one float32) InfoNCE step of a small S3D on the CPU, in
the port and, where JAX is installed, in the JAX package on the same
weights and input: prints each loss and how many encoder_q elements are not
finite after the step. The port's step runs with oneDNN on and off.

    python tests/bf16_step_probe.py

B = 4, seq_len 8, img_dim 32, moco-dim 16, moco-k 16, lr 1e-3. Not a test:
it answers whether a bfloat16 step on a given CPU stays finite.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
B, T, S, DIM, K, LR = 4, 8, 32, 16, 16, 1e-3


def jax_step(dtype, seq):
    """The JAX package's step from PRNGKey(0): (loss, non-finite count,
    host copies of the initial state for the port)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from coclr_tpu.config import PretrainConfig
    from coclr_tpu.models import moco
    from coclr_tpu.models.encoder import ProjectionEncoder
    from coclr_tpu.parallel.train_step import make_pretrain_step

    cfg = PretrainConfig(net="s3d", model="infonce", seq_len=T, img_dim=S,
                         batch_size=B, moco_k=K, moco_dim=DIM, lr=LR,
                         compute_dtype=dtype)
    enc = ProjectionEncoder(network="s3d", dim=DIM, dtype=getattr(jnp, dtype))
    state = moco.init_moco_state(jax.random.PRNGKey(0), enc, "infonce",
                                 np.zeros((1, T, S, S, 3), np.float32),
                                 dim=DIM, K=K)
    host = jax.tree_util.tree_map(np.array, jax.device_get(
        (state.params_q, state.stats_q, state.params_k, state.stats_k,
         state.queue)))
    step, tx = make_pretrain_step(enc, cfg, None, preprocess_fn=None,
                                  donate=False)
    state, _, m = step(state, tx.init(state.params_q),
                       {"seq": jnp.asarray(seq)}, jax.random.PRNGKey(0),
                       jnp.float32(LR))
    bad = sum(int((~np.isfinite(np.asarray(a, np.float32))).sum())
              for a in jax.tree_util.tree_leaves(jax.device_get(state.params_q)))
    return float(m["loss"]), bad, host


def port_step(dtype, seq, host=None):
    """The port's step, from `host` (the JAX initial state) or its own
    seeded init: (loss, non-finite encoder_q elements)."""
    import torch

    from coclr_tpu_torch.config import PretrainConfig
    from coclr_tpu_torch.models.moco import MoCo
    from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step

    cfg = PretrainConfig(net="s3d", moco_k=K, moco_dim=DIM, lr=LR,
                         compute_dtype=dtype)
    model = MoCo("s3d", DIM, K, cfg.dtype)
    if host is not None:
        from coclr_tpu_torch.utils.interop import state_dict_from_jax

        model.load_state_dict(state_dict_from_jax(*host, queue_ptr=0),
                              strict=True)
    model.train()
    opt = make_optimizer(cfg, model.encoder_q.parameters())
    m = pretrain_step(model, opt, torch.from_numpy(seq.copy()), LR, cfg)
    bad = sum(int((~torch.isfinite(p)).sum())
              for p in model.encoder_q.parameters())
    return float(m["loss"]), bad


def main():
    import torch

    seq = np.random.RandomState(0).randn(B, 2, T, S, S, 3).astype(np.float32)
    try:  # the JAX package's stack
        import flax  # noqa: F401
        import jax  # noqa: F401
        import optax  # noqa: F401
        have_jax = True
    except ImportError:
        have_jax = False
    print(f"torch {torch.__version__}, CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}, the JAX package "
          f"{'runs' if have_jax else 'does not run'} here", flush=True)
    for dtype in ("bfloat16", "float32"):
        host = None
        if have_jax:
            loss, bad, host = jax_step(dtype, seq)
            print(f"{dtype}: JAX loss {loss:.4f}, {bad} non-finite params_q "
                  "elements", flush=True)
        for onednn in (True, False):
            torch.backends.mkldnn.enabled = onednn
            loss, bad = port_step(dtype, seq, host)
            print(f"{dtype}: port (oneDNN {'on' if onednn else 'off'}) loss "
                  f"{loss:.4f}, {bad} non-finite encoder_q elements",
                  flush=True)


if __name__ == "__main__":
    main()
