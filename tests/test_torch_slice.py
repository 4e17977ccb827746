"""The port's InfoNCE slice against the JAX package, its CPU training loop end to
end, and its import boundary (no jax, nothing of coclr_tpu)."""

import glob
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coclr_tpu.config import PretrainConfig as JaxConfig
from coclr_tpu.models import moco as jmoco
from coclr_tpu.models.encoder import ProjectionEncoder as JaxEncoder
from coclr_tpu.parallel.train_step import make_pretrain_step
from coclr_tpu.utils import torch_interop
from coclr_tpu_torch.config import PretrainConfig
from coclr_tpu_torch.models.moco import MoCo
from coclr_tpu_torch.parallel.train_step import make_optimizer, pretrain_step
from coclr_tpu_torch.utils.interop import encoder_state_dict_from_jax, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coclr_tpu_torch")


def test_three_infonce_steps_match_jax():
    """Three InfoNCE steps on `tiny` from one JAX state, float32, same
    (already augmented) batches on both sides. queue_ptr is exact; losses
    match to rtol 1e-5 and the queue rows to 1e-5 (float32 rounding of the
    same sums; measured 5e-7 and 3e-7). Adam's first steps turn ULP-level
    differences in near-zero gradients into updates of up to lr, so the
    query parameters get atol 3 x lr (measured 1.5e-5 here); the key
    encoder moves by (1 - m) of that, so 1e-5; BN statistics 1e-4."""
    lr, K, dim, B, T, S = 1e-3, 16, 8, 4, 4, 16
    jcfg = JaxConfig(net="tiny", model="infonce", seq_len=T, img_dim=S,
                     batch_size=B, moco_k=K, moco_dim=dim, lr=lr,
                     compute_dtype="float32")
    enc = JaxEncoder(network="tiny", dim=dim, dtype=jnp.float32)
    state = jmoco.init_moco_state(jax.random.PRNGKey(0), enc, "infonce",
                                  np.zeros((1, T, S, S, 3), np.float32),
                                  dim=dim, K=K)
    step, tx = make_pretrain_step(enc, jcfg, None, preprocess_fn=None,
                                  donate=False)
    opt_state = tx.init(state.params_q)

    model = MoCo("tiny", dim, K, torch.float32)
    model.load_state_dict(state_dict_from_jax(
        *jax.device_get((state.params_q, state.stats_q, state.params_k,
                         state.stats_k, state.queue)),
        queue_ptr=int(state.queue_ptr)), strict=True)
    model.train()
    cfg = PretrainConfig(net="tiny", moco_k=K, moco_dim=dim, lr=lr,
                         compute_dtype="float32")
    opt = make_optimizer(cfg, model.encoder_q.parameters())

    rng = np.random.RandomState(0)
    for i in range(3):
        seq = rng.randn(B, 2, T, S, S, 3).astype(np.float32)
        state, opt_state, jm = step(state, opt_state, {"seq": jnp.asarray(seq)},
                                    jax.random.PRNGKey(i), jnp.float32(lr))
        tm = pretrain_step(model, opt, torch.from_numpy(seq), lr, cfg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)

    assert int(model.queue_ptr) == int(state.queue_ptr) == (3 * B) % K
    np.testing.assert_allclose(model.queue.numpy(), np.asarray(state.queue),
                               atol=1e-5)
    for prefix, params, stats, atol in (
            ("encoder_q.", state.params_q, state.stats_q, 3 * lr),
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


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

    root = tmp_path_factory.mktemp("torch_synth")
    out = make_synthetic_ucf(str(root), n_classes=2, n_groups=3, n_clips=2,
                             n_frames=12, size=(40, 48), flow=False)
    meta_root = root / "meta_root"
    meta_root.mkdir()
    os.symlink(out["root"], meta_root / "ucf101")
    (root / "data" / "UCF101").mkdir(parents=True)
    os.symlink(out["db_path"], root / "data" / "UCF101" / "ucf101_frame.lmdb")
    return {"meta_root": str(meta_root), "data_root": str(root / "data")}


def test_cli_end_to_end_on_cpu_and_checkpoint_loads_into_jax(
        synth, tmp_path, monkeypatch):
    """`python -m coclr_tpu_torch.main_nce --device cpu` (in-process) on the
    port's synthetic LMDB: two steps, a reference-format epoch checkpoint
    that loads back into coclr_tpu through moco_state_from_torch, and a
    resume that continues from it."""
    from coclr_tpu_torch import main_nce
    from coclr_tpu_torch.train.pretrain import run_pretrain

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COCLR_META_ROOT", synth["meta_root"])
    main_nce.main(["--net", "tiny", "--seq_len", "4", "--img_dim", "16",
                   "--batch_size", "2", "--moco-k", "8", "--moco-dim", "8",
                   "--epochs", "1", "--workers", "2", "--compute_dtype",
                   "float32", "--print_freq", "1", "--data_root",
                   synth["data_root"], "--prefix", "cli", "--device", "cpu"])
    ckpts = glob.glob(str(tmp_path / "log-cli" / "*" / "model" / "epoch0.pth.tar"))
    assert len(ckpts) == 1

    raw = torch_interop.load_torch_checkpoint(ckpts[0])
    assert raw["epoch"] == 0 and raw["state_dict"]["queue"].shape == (8, 8)
    enc = JaxEncoder(network="tiny", dim=8, dtype=jnp.float32)
    template = jmoco.init_moco_state(jax.random.PRNGKey(1), enc, "infonce",
                                     np.zeros((1, 4, 16, 16, 3), np.float32),
                                     dim=8, K=8)
    state = torch_interop.moco_state_from_torch(raw["state_dict"], template)
    sd = raw["state_dict"]
    np.testing.assert_array_equal(
        np.asarray(state.params_q["backbone"]["c1"]["conv"]["kernel"]),
        sd["encoder_q.0.c1.conv.weight"].transpose(2, 3, 4, 1, 0))
    np.testing.assert_array_equal(np.asarray(state.queue), sd["queue"].T)
    assert int(state.queue_ptr) == int(sd["queue_ptr"][0])

    cfg = main_nce.cfg_from_args(main_nce.parse_args(
        ["--net", "tiny", "--seq_len", "4", "--img_dim", "16", "--batch_size",
         "2", "--moco-k", "8", "--moco-dim", "8", "--epochs", "2",
         "--workers", "2", "--compute_dtype", "float32", "--data_root",
         synth["data_root"], "--resume", ckpts[0]]))
    model, _, info = run_pretrain(cfg, max_steps=1, device="cpu")
    assert np.isfinite(info["train_acc"]) and len(info["step_s"]) == 1
    assert os.path.exists(os.path.join(info["exp_path"], "model", "epoch1.pth.tar"))
    assert not os.path.exists(ckpts[0])  # rotated out (gap 1)


class _SigtermLoader:
    """Yields fixed batches and sends this process SIGTERM before the
    second one, as a preempting scheduler would."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        import signal

        for i, batch in enumerate(self.batches):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def test_preemption_checkpoints_and_stops(tmp_path, monkeypatch):
    """SIGTERM mid-epoch: the in-flight step finishes, preempt.pth.tar is
    written with the epoch wound back one, and the loop stops."""
    from coclr_tpu_torch.train.pretrain import run_pretrain
    from coclr_tpu_torch.utils.checkpoint import load_checkpoint

    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    batches = [{"seq": rng.randint(0, 256, (2, 2, 4, 16, 16, 3), np.uint8),
                "aug_base": np.ones((2, 2), np.uint8)} for _ in range(4)]
    cfg = PretrainConfig(net="tiny", seq_len=4, img_dim=16, batch_size=2,
                         moco_k=8, moco_dim=8, epochs=3,
                         compute_dtype="float32")
    _, _, info = run_pretrain(cfg, loader=_SigtermLoader(batches),
                              device="cpu")
    assert info["preempted"] and len(info["step_s"]) == 2
    ckpt = load_checkpoint(os.path.join(info["exp_path"], "model",
                                        "preempt.pth.tar"))
    assert ckpt["epoch"] == -1 and ckpt["iteration"] == 3


def test_entry_point_raises_without_cuda():
    from coclr_tpu_torch.train.pretrain import run_pretrain

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is taken")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_pretrain(PretrainConfig(net="tiny"))


_BLOCKER = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "optax") or top == "coclr_tpu":
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import coclr_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(coclr_tpu_torch.__path__,
                                                "coclr_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
print(len(mods))
"""


def test_port_imports_without_jax():
    """Every module of coclr_tpu_torch imports with jax, flax, optax and
    coclr_tpu blocked."""
    out = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30


def _reference_scripts():
    """Module names of the repository's tools/, eval/ and root scripts (the
    JAX package's command lines), and the two directories themselves."""
    names = {"tools", "eval"}
    for d in ("tools", "eval", ""):
        names |= {os.path.splitext(f)[0] for f in
                  os.listdir(os.path.join(REPO, d)) if f.endswith(".py")}
    return names - {"chip_smoke"}


def _boundary_hits(text, in_package):
    """Lines of `text` that cross the port's import boundary: an import of
    jax, flax, optax or coclr_tpu; an import of a tools/, eval/ or root
    script; a sys.path / PYTHONPATH entry naming tools/ or eval/; and, in
    the package, any sys.path change at all."""
    names = "|".join(sorted(map(re.escape, _reference_scripts())))
    imports = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|coclr_tpu|%s)"
        r"(\.|\s|,|$)" % names, re.M)
    hits = [m.group(0).strip() for m in imports.finditer(text)]
    for line in text.splitlines():
        path_change = re.search(r"sys\.path\.|addsitedir|PYTHONPATH", line)
        if path_change and (in_package or re.search(r"tools|eval", line)):
            if in_package and "PYTHONPATH" in line \
                    and not re.search(r"tools|eval", line):
                continue  # a child process's path to the repository
            hits.append(line.strip())
    return hits


def test_source_scan_finds_no_jax_or_coclr_tpu_import():
    """No module of the port, and not chip_smoke.py, imports jax or
    coclr_tpu, or imports from (or puts on sys.path) the repository's
    tools/, eval/ or root command lines; the scan catches the JAX
    summarizer's own `sys.path.insert` + `from drive_coclr_cycle import`."""
    files = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
    assert len(files) > 30
    assert {"drive_coclr_cycle", "main_classifier", "main_nce",
            "eval"} <= _reference_scripts()
    for path in files + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            hits = _boundary_hits(f.read(), path.startswith(PORT))
        assert hits == [], (path, hits)
    with open(os.path.join(REPO, "tools", "summarize_coclr_drive.py")) as f:
        copied = _boundary_hits(f.read(), in_package=True)
    assert sorted(copied) == ["from drive_coclr_cycle", "sys.path.insert(0, "
                              "os.path.dirname(os.path.abspath(__file__)))"]
