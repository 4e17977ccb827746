"""The port's recipe drive and report tools (coclr_tpu_torch/tools/) against
the JAX package's (tools/drive_coclr_cycle.py and its summarizers, loaded
by path): the log parsers on the port CLIs' real output, the phase graph
of both drives on every flag set that changes it, the summarizers on the
same logs and artifacts, the resume rules, the host-feed tools at a tiny
size, and one drive end to end on the CPU with its checkpoint chain."""

import contextlib
import glob
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from coclr_tpu_torch.tools import (bench_loader, budget_host_feed,
                                   drive_coclr_cycle, summarize_coclr_drive,
                                   summarize_drives, summarize_scale_drive)
from test_drive_tools import LOG, RETR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVES = sorted(glob.glob(os.path.join(REPO, "DRIVE_coclr_cycle*.json")))


def _load(name):
    """A JAX tool by path (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jdrive():
    return _load("drive_coclr_cycle")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from coclr_tpu_torch.data.synthetic import make_synthetic_ucf

    root = tmp_path_factory.mktemp("drive_synth")
    out = make_synthetic_ucf(str(root), n_classes=2, n_groups=3, n_clips=2,
                             n_frames=12, size=(40, 48), flow=True)
    (root / "meta_root").mkdir()
    os.symlink(out["root"], root / "meta_root" / "ucf101")
    (root / "data" / "UCF101").mkdir(parents=True)
    os.symlink(out["db_path"], root / "data" / "UCF101" / "ucf101_frame.lmdb")
    os.symlink(out["db_path_flow"],
               root / "data" / "UCF101" / "ucf101_tvl1_frame.lmdb")
    return {"meta_root": str(root / "meta_root"),
            "data_root": str(root / "data")}


@pytest.fixture(scope="module")
def coclr_log(synth, tmp_path_factory):
    """What `python -m coclr_tpu_torch.main_coclr --device cpu` prints: 2
    epochs of 2 steps of 4 samples (K = 8: the second epoch trains with
    the gate open), every step printed."""
    from coclr_tpu_torch import main_coclr

    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("drive_coclr"))
    old = os.environ.get("COCLR_META_ROOT")
    os.environ["COCLR_META_ROOT"] = synth["meta_root"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main_coclr.main(
                ["--net", "tiny", "--seq_len", "4", "--img_dim", "16",
                 "--batch_size", "4", "--moco-k", "8", "--moco-dim", "8",
                 "--epochs", "2", "--workers", "2", "--compute_dtype",
                 "float32", "--print_freq", "1", "--data_root",
                 synth["data_root"], "--prefix", "d", "--topk", "2",
                 "--device", "cpu"])
    finally:
        os.chdir(cwd)
        if old is None:
            os.environ.pop("COCLR_META_ROOT", None)
        else:
            os.environ["COCLR_META_ROOT"] = old
    return out.getvalue()


# ---------------------------------------------------------------- parsers


@pytest.mark.parametrize("which", ["fixture", "port_main_coclr"])
def test_parsers_agree_with_the_jax_drive(which, jdrive, request):
    """parse_epochs, parse_retrieval and SELF_RE of both drives give equal
    results on test_drive_tools' LOG and RETR and on the port's own
    main_coclr output (right-aligned steps, Self-acc@1 on every line)."""
    if which == "fixture":
        text = LOG + RETR
    else:
        text = request.getfixturevalue("coclr_log") + RETR
        lines = re.findall(r"^Epoch:\[\d+\]\[.*$", text, re.M)
        assert len(lines) == 4  # 2 epochs x 2 steps, every step printed
        assert len(drive_coclr_cycle.SELF_RE.findall(text)) == len(lines)
    port = drive_coclr_cycle
    assert port.parse_epochs(text) == jdrive.parse_epochs(text)
    assert port.parse_epochs(text)
    assert port.parse_retrieval(text) == jdrive.parse_retrieval(text) == {
        "R@1": 0.4167, "R@5": 0.75, "R@10": 1.0}
    assert port.SELF_RE.findall(text) == jdrive.SELF_RE.findall(text)
    assert port.SELF_RE.findall(text)


def test_parse_epochs_takes_epoch_averages():
    eps = drive_coclr_cycle.parse_epochs(LOG)
    assert [e["epoch"] for e in eps] == [0, 1]
    assert eps[0]["loss"] == 4.8561 and eps[0]["acc1"] == 0.0898
    assert eps[1]["loss"] == 5.6176


# ------------------------------------------------------------ phase graph

JAX_CLI = {"main_nce.py": "main_nce", "main_coclr.py": "main_coclr",
           "eval/main_classifier.py": "main_classifier",
           "eval/merge_2stream_prob.py": "merge_2stream_prob",
           "eval/feature_linear_probe.py": "feature_linear_probe"}
GRAPH_ARGS = {
    "default": [],
    "cycles2": ["--cycles", "2"],
    "priority_rgb": ["--priority", "rgb"],
    "finetune": ["--downstream_train_what", "ft", "--tta_max_windows", "1"],
    "skip_tta": ["--skip_tta"],
    "skip_downstream": ["--skip_downstream"],
    "retrieval_last_cycle_only": ["--retrieval_last_cycle_only",
                                  "--cycles", "2"],
    "schedule_nce": ["--schedule_nce", "4"],
    "accept_partial_nce": ["--accept_partial_nce"],
}


def _stage_placeholders(wd, ext):
    """What the drives find on disk instead of running their phases: the
    two LMDBs (no staging), each classifier's best checkpoint and its
    ten-crop probabilities."""
    os.makedirs(os.path.join(wd, "data", "UCF101"))
    for db in ("ucf101_frame.lmdb", "ucf101_tvl1_frame.lmdb"):
        open(os.path.join(wd, "data", "UCF101", db), "w").close()
    for cls in ("cycp", "cycft"):
        for mod in ("rgb", "flow"):
            d = os.path.join(wd, f"log-eval-{cls}_{mod}", "exp", "model")
            os.makedirs(d)
            open(os.path.join(d, "model_best_epoch3" + ext), "w").close()
            open(os.path.join(d, "x-prob-ten.json"), "w").close()


def _phase_graph(mod, main, wd, ext, monkeypatch):
    """(tag, CLI, argv, done marker, partial guard) of every phase main()
    runs, with run_cli and latest_ckpt stubbed; paths under wd -> <wd>."""
    calls = []

    def run_cli(tag, args_list, cwd, log_dir, done_marker=None,
                validate=None, partial_ok=None):
        assert cwd == wd and log_dir == os.path.join(wd, "drivelogs")
        calls.append((tag, list(args_list), done_marker,
                      partial_ok is not None))
        return LOG + RETR, 1.0

    monkeypatch.setattr(mod, "run_cli", run_cli)
    monkeypatch.setattr(mod, "latest_ckpt", lambda workdir, prefix: os.path.join(
        workdir, f"log-{prefix}", "exp", "model", "epoch1" + ext))
    main()
    out = []
    for tag, argv, marker, partial in calls:
        if argv[0] == "-m":
            cli, rest = argv[1][len("coclr_tpu_torch."):], argv[2:]
            # the port's additions: --device, and float32 on the CPU
            for flag in ("--device", "--compute_dtype"):
                if flag in rest:
                    i = rest.index(flag)
                    rest = rest[:i] + rest[i + 2:]
        else:
            cli, rest = JAX_CLI[os.path.relpath(argv[0], REPO)], argv[1:]
        rest = [re.sub(r"\.ckpt$", ".pth.tar", a.replace(wd, "<wd>"))
                for a in rest]
        out.append((tag, cli, rest, marker, partial))
    return out


@pytest.mark.parametrize("case", sorted(GRAPH_ARGS))
def test_phase_graph_matches_the_jax_drive(case, jdrive, tmp_path,
                                           monkeypatch):
    """Both drives' main() on the same flags run the same phases in the
    same order with the same CLI flags (script -> module, .ckpt ->
    .pth.tar, the port's --device and CPU float32 dropped) and the same
    resume markers."""
    monkeypatch.setenv("COCLR_META_ROOT", "unset")
    # the JAX drive ends in a subprocess of its summarizer
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(a, 0))
    extra = GRAPH_ARGS[case]
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    _stage_placeholders(jwd, ".ckpt")
    _stage_placeholders(pwd, ".pth.tar")
    monkeypatch.setattr(sys, "argv", ["drive", "--workdir", jwd,
                                      "--out_prefix", str(tmp_path / "J")]
                        + extra)
    want = _phase_graph(jdrive, jdrive.main, jwd, ".ckpt", monkeypatch)
    got = _phase_graph(
        drive_coclr_cycle,
        lambda: drive_coclr_cycle.main(["--workdir", pwd, "--device", "cpu"]
                                       + extra),
        pwd, drive_coclr_cycle.EXT, monkeypatch)
    assert [c[0] for c in got] == [c[0] for c in want]
    assert got == want
    assert len(got) >= 8
    # the port's report lands under its workdir and names the device
    with open(os.path.join(pwd, "DRIVE_coclr_cycle.json")) as f:
        assert json.load(f)["config"]["card"] == "cpu"


def test_drive_raises_without_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is taken")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drive_coclr_cycle.main(["--workdir", str(tmp_path / "wd")])
    assert not (tmp_path / "wd").exists()


# ------------------------------------------------------------ checkpoints


def test_checkpoint_search_never_takes_the_preemption_file(tmp_path):
    """latest_ckpt takes the newest epoch<N>.pth.tar at any depth under
    log-<prefix>*, never preempt.pth.tar or a model_best file."""
    d = tmp_path / "log-cyc_cf" / "exp" / "model"
    d.mkdir(parents=True)
    for i, name in enumerate(("epoch1.pth.tar", "epoch0.pth.tar",
                              "model_best_epoch1.pth.tar",
                              "preempt.pth.tar")):
        (d / name).write_text("x")
        os.utime(d / name, (1000 + i, 1000 + i))
    assert drive_coclr_cycle.latest_ckpt(str(tmp_path), "cyc_cf") == str(
        d / "epoch0.pth.tar")
    deep = tmp_path / "log-cyc_cr" / "a" / "b" / "model"
    deep.mkdir(parents=True)
    (deep / "epoch4.pth.tar").write_text("x")
    (deep / "preempt.pth.tar").write_text("x")
    assert drive_coclr_cycle.latest_ckpt(str(tmp_path), "cyc_cr") == str(
        deep / "epoch4.pth.tar")
    with pytest.raises(RuntimeError, match="no checkpoint"):
        drive_coclr_cycle.latest_ckpt(str(tmp_path), "cyc2_cf")


def test_card_run_classifier_directory_fits_a_file_name(tmp_path,
                                                        monkeypatch):
    """The classifier's experiment directory embeds the pretrained path
    ('/' -> '-') in one component: at the card drive's deepest checkpoint
    (cycle 2 FlowMining, epoch 11, --workdir /tmp/cyc) it must stay under
    255 bytes, or the downstream chain fails with 'File name too long'."""
    from coclr_tpu_torch.config import EvalConfig, PretrainConfig
    from coclr_tpu_torch.evalsuite import driver
    from coclr_tpu_torch.train import pretrain

    monkeypatch.chdir(tmp_path)
    longest = 0
    for name_prefix, prefix, reverse in (("Cycle2-FlowMining_", "cyc2_cf",
                                          False),
                                         ("Cycle2-RGBMining_", "cyc2_cr",
                                          True)):
        cfg = PretrainConfig(net="s3d", model="coclr", topk=5,
                             reverse=reverse, moco_k=128,
                             dataset="ucf101-2stream-2clip", seq_len=32,
                             img_dim=128, batch_size=32,
                             name_prefix=name_prefix, prefix=prefix)
        exp = pretrain.set_path(cfg)[2]
        ckpt = os.path.join("/tmp/cyc", exp, "model", "epoch11.pth.tar")
        for tw, cls in (("last", "cycp"), ("ft", "cycft")):
            ecfg = EvalConfig(net="s3d", dataset="ucf101-f", seq_len=32,
                              img_dim=128, batch_size=32, train_what=tw,
                              pretrain=ckpt, prefix=f"{cls}_flow")
            path = driver.set_path(ecfg)[2]  # makes the directories
            longest = max(longest, len(os.path.basename(path)))
    assert 200 < longest < 255


# ------------------------------------------------------------ summarizers


def _logs_from_report(rep, logs):
    """The phase logs whose parse gives `rep` back (the grammar of the
    port's CLIs)."""
    logs.mkdir(parents=True)
    for tag, ph in rep["phases"].items():
        lines = []
        for e in ph.get("epochs") or []:
            selfacc = (f"\tSelf-acc@1 0.0000 ({ph['self_acc1_final']:.4f})"
                       if "self_acc1_final" in ph else "")
            lines.append(f"Epoch:[{e['epoch']}][ 9/10]\tTime 1.0 (1.0)\t"
                         f"Data 0.1 (0.1)\tLoss 1.0 ({e['loss']:.4f})\t"
                         f"acc@1 0.5 ({e['acc1']:.4f})\tacc@5 1.0 (1.0)"
                         + selfacc)
        lines += [f"{k[2:]}NN acc = {v:.4f}" for k, v in ph.items()
                  if k.startswith("R@")]
        if "best_val_top1" in ph:
            lines += [f"val epoch {i}: loss 1.0 top1 "
                      f"{ph['best_val_top1'] if i == 1 else 0.0:.4f}"
                      for i in range(ph["epochs_run"])]
        if lines:
            (logs / f"{tag}.log").write_text("\n".join(lines) + "\n")
        if "tencrop_top1" in ph:
            (logs / f"{tag}_tencrop.log").write_text(
                f"Mean: Acc@1: {ph['tencrop_top1']:.4f} Acc@5: "
                f"{ph['tencrop_top5']:.4f}\n")
        if tag == "merge_2stream":
            (logs / f"{tag}.log").write_text(
                "merged accuracy: %.6f + %.6f => %.6f\n"
                % (ph["top1_rgb"], ph["top1_flow"], ph["top1_fused"]))
        if tag == "feature_probe_rgb":
            (logs / f"{tag}.log").write_text(
                f"Final best acc: {ph['best_acc']:.4f}\n")


@pytest.mark.parametrize("artifact", [os.path.basename(p) for p in DRIVES])
def test_summarizer_matches_the_jax_one(artifact, tmp_path, monkeypatch):
    """The same drive logs and prior report through both summarizers: equal
    reports, and the same numbers in the same order in the markdown."""
    with open(os.path.join(REPO, artifact)) as f:
        rep = json.load(f)
    _logs_from_report(rep, tmp_path / "drivelogs")
    out = {}
    for side in ("jax", "port"):
        prefix = tmp_path / side / "ART"
        prefix.parent.mkdir()
        prefix.with_suffix(".json").write_text(json.dumps(rep))
        argv = ["--workdir", str(tmp_path), "--chance",
                str(rep["chance_R@1"]), "--out_prefix", str(prefix)]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["summarize"] + argv)
            _load("summarize_coclr_drive").main()
        else:
            summarize_coclr_drive.main(argv)
        out[side] = (json.loads(prefix.with_suffix(".json").read_text()),
                     prefix.with_suffix(".md").read_text())
    assert out["port"][0] == out["jax"][0]
    for tag in ("retrieval_rgb_init", "retrieval_flow_coclr"):
        assert out["port"][0]["phases"][tag]["R@1"] == rep["phases"][tag]["R@1"]
    number = re.compile(r"[-+]?\d+\.\d+")
    assert number.findall(out["port"][1]) == number.findall(out["jax"][1])
    assert out["port"][1].startswith(
        "# CoCLR cycle drive — card not recorded,")


def test_summarizer_multi_cycle_writes_beside_the_report(tmp_path):
    logs = tmp_path / "drivelogs"
    logs.mkdir()
    (logs / "nce_rgb.log").write_text(LOG)
    r = {"init": (0.20, 0.10), "coclr": (0.30, 0.25),
         "cycle2": (0.28, 0.40), "cycle3": (0.26, 0.44)}
    for suf, (rgb, flow) in r.items():
        (logs / f"retrieval_rgb_{suf}.log").write_text(
            f"1NN acc = {rgb:.4f}\n5NN acc = 0.9\n")
        (logs / f"retrieval_flow_{suf}.log").write_text(
            f"1NN acc = {flow:.4f}\n5NN acc = 0.9\n")
    (tmp_path / "ART.json").write_text(json.dumps({"config": {
        "moco_k": 16, "seq_len": 8, "img_dim": 32, "seed": 1, "n_classes": 2,
        "test_groups": 2, "n_clips": 2, "card": "NVIDIA H100, 700.00 W"},
        "phases": {}}))
    summarize_coclr_drive.main(["--workdir", str(tmp_path), "--chance",
                                "0.25", "--out_prefix", "ART"])
    rep = json.loads((tmp_path / "ART.json").read_text())
    assert rep["phases"]["retrieval_flow_cycle3"]["R@1"] == 0.44
    md = (tmp_path / "ART.md").read_text()
    assert md.startswith("# CoCLR cycle drive — NVIDIA H100, 700.00 W,")
    assert "Mining cycle 2" in md and "Mining cycle 3" in md
    assert "rgb 0.300" in md and "flow 0.440" in md


def test_summarize_drives_matches_the_jax_one(tmp_path, monkeypatch,
                                              capsys):
    """The repository's three drive artifacts through both cross-seed
    tables: equal rows and counts and the same markdown; the port also
    finds the reports in drive workdirs below --root."""
    jax_tool = _load("summarize_drives")
    flat, nested = tmp_path / "flat", tmp_path / "nested"
    for i, path in enumerate(DRIVES):
        with open(path) as f:
            text = f.read()
        (nested / f"wd{i}").mkdir(parents=True)
        (nested / f"wd{i}" / os.path.basename(path)).write_text(text)
        flat.mkdir(exist_ok=True)
        (flat / os.path.basename(path)).write_text(text)
    want = jax_tool.summarize(jax_tool.load_drives(str(flat)), 72)
    assert want[1] == {"rgb": 3, "flow": 2} and len(want[0]) == 6
    for root in (flat, nested):
        got = summarize_drives.summarize(
            summarize_drives.load_drives(str(root)), 72)
        assert got == want

    monkeypatch.setattr(sys, "argv", ["s", "--root", str(flat),
                                      "--markdown"])
    jax_tool.main()
    jax_md = capsys.readouterr().out
    summarize_drives.main(["--root", str(nested), "--markdown"])
    assert capsys.readouterr().out == jax_md
    assert "best post-mining beats init in 3/3 seeds" in jax_md


def test_summarize_scale_drive_matches_the_jax_one(coclr_log, tmp_path):
    """The port's main_coclr output (and a K400-style synthetic log) give
    the JAX tool's numbers; the files go beside the log."""
    jax_tool = _load("summarize_scale_drive")
    lines = []
    for s in range(0, 100, 5):
        t = 60.0 if s == 0 else 2.0
        loss = 6.0 - s * 0.01
        lines.append(f"Epoch:[0][{s:3d}/100]\tTime {t:.4f} ({t:.4f})\t"
                     f"Data 0.0010 (0.0500)\tLoss {loss:.4f} ({loss:.4f})\t"
                     f"acc@1 0.1000 (0.1000)\tacc@5 0.3000 (0.3000)")
    for name, text, skip in (("k4", "\n".join(lines) + "\n", 10),
                             ("port", coclr_log, 1)):
        log = tmp_path / f"{name}.log"
        log.write_text(text)
        want = jax_tool.summarize(str(log), name, 4, 8, warmup_skip=skip)
        got = summarize_scale_drive.summarize(str(log), name, 4, 8,
                                              warmup_skip=skip)
        assert got == want
        assert summarize_scale_drive.to_markdown(got).replace(
            "coclr_tpu_torch.tools.summarize_scale_drive",
            "tools/summarize_scale_drive.py") == jax_tool.to_markdown(want)
    assert want["steps_per_epoch"] == 2
    summarize_scale_drive.main(["--log", str(tmp_path / "k4.log"), "--name",
                                "k4test", "--batch_size", "32", "--moco_k",
                                "1024"])
    with open(tmp_path / "DRIVE_k4test.json") as f:
        assert json.load(f)["clips_per_sec"] == 32.0
    assert (tmp_path / "DRIVE_k4test.md").exists()


# ------------------------------------------------------------ feature health


def _health_case(case):
    """(train, test) features of one failure the health reader must name."""
    rng = np.random.default_rng(11)
    if case == "constant":
        return np.full((20, 8), 3.0), np.full((6, 8), 3.0)
    if case == "one_nan_row":
        train = rng.standard_normal((20, 8))
        train[3] = np.nan
        return train, rng.standard_normal((6, 8))
    if case == "planted_hub":
        # 80 % of the queries lie along +u after centering; train row 7 is
        # the one train video along +u
        u = np.eye(16)[0]
        sign = np.where(np.arange(40) % 5 == 0, -1.0, 1.0)
        test = sign[:, None] * u + 0.05 * rng.standard_normal((40, 16))
        train = rng.standard_normal((60, 16))
        train[7] += 20.0 * u
        return train, test
    return rng.standard_normal((200, 16)), rng.standard_normal((50, 16))


@pytest.mark.parametrize("case", ["constant", "one_nan_row", "planted_hub",
                                  "healthy"])
def test_feature_health_names_each_case(case):
    """The reader's numbers on constant features (no spread, rank 0, one
    hub for every query), one NaN row (counted; every centered row NaN,
    so no other number), a planted hub, and healthy random features."""
    from coclr_tpu_torch.evalsuite.feature_health import feature_health
    from coclr_tpu_torch.evalsuite.retrieval import center_normalize

    train, test = _health_case(case)
    h = feature_health(train, test)
    assert (h["n_train"], h["n_test"], h["dim"]) == (
        len(train), len(test), train.shape[1])
    if case == "one_nan_row":
        assert np.isnan(center_normalize(train.astype(np.float32))).all()
        assert h["nonfinite"] == 8 and h["finite"] is False
        assert all(h[k] is None for k in ("std_min", "std_median",
                                          "effective_rank", "hub_share"))
        return
    assert h["nonfinite"] == 0 and h["finite"] is True
    if case == "constant":
        assert h["std_min"] == h["std_median"] == 0.0
        assert h["effective_rank"] == 0.0 and h["hub_share"] == 1.0
    elif case == "planted_hub":
        assert h["hub_share"] == 0.8 and h["hub_index"] == 7
    else:
        assert 0.9 < h["std_min"] <= h["std_median"] < 1.1
        assert 14.0 < h["effective_rank"] <= 16.0
        assert h["hub_share"] < 0.2


def test_drive_report_marks_nonfinite_features(tmp_path):
    """A retrieval whose feature cache holds one NaN row: the drive's
    report keys and the summarizer's report carry the count and the mark,
    and the markdown says its R@k means nothing; the finite retrieval
    beside it carries its health and no mark. nn_retrieval still prints
    the lines both packages' parsers read."""
    from coclr_tpu_torch.evalsuite.retrieval import (nn_retrieval,
                                                     save_feature_cache)

    bad, good = _health_case("one_nan_row"), _health_case("healthy")
    logs = tmp_path / "drivelogs"
    logs.mkdir()
    for tag, (train, test) in (("retrieval_rgb_init", bad),
                               ("retrieval_flow_init", good)):
        labels = lambda n: np.arange(n) % 4
        for split, f in (("train", train), ("test", test)):
            save_feature_cache(str(tmp_path / f"feat_{tag}"), "ucf101",
                               split, f.astype(np.float32), labels(len(f)),
                               [f"v{i}" for i in range(len(f))])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            for k, acc in nn_retrieval(test, labels(len(test)), train,
                                       labels(len(train))).items():
                print("%dNN acc = %.4f" % (k, acc))
        (logs / f"{tag}.log").write_text(out.getvalue())
        assert set(drive_coclr_cycle.parse_retrieval(out.getvalue())) == {
            "R@1", "R@5", "R@10", "R@20", "R@50"}

    marks = drive_coclr_cycle.feature_marks(
        str(tmp_path / "feat_retrieval_rgb_init"))
    assert marks["nonfinite_features"] is True
    assert marks["features"]["nonfinite"] == 8
    assert drive_coclr_cycle.feature_marks(str(tmp_path / "none")) == {}
    summarize_coclr_drive.main(["--workdir", str(tmp_path)])
    rep = json.loads((tmp_path / "DRIVE_coclr_cycle.json").read_text())
    assert rep["phases"]["retrieval_rgb_init"]["nonfinite_features"] is True
    assert rep["phases"]["retrieval_rgb_init"]["features"] == marks["features"]
    flow = rep["phases"]["retrieval_flow_init"]
    assert "nonfinite_features" not in flow and flow["features"]["finite"]
    md = (tmp_path / "DRIVE_coclr_cycle.md").read_text()
    assert re.search(r"\| rgb_init \|.*non-finite features: R@k means nothing",
                     md)
    assert re.search(r"\| rgb_init \| 8 \| - \| - \| - \| - \|", md)
    assert not re.search(r"\| flow_init \|.*R@k means nothing", md)


def test_collapse_probe_runs_draw_as_the_drive_and_keep_apart(tmp_path):
    """The collapse probe's own FlowMining runs train with the probe seed's
    (the first of --seeds) drive seed, not the drive parser's default,
    under prefixes that the
    drive's checkpoint search never takes for its own phases; and a
    retrieval counts as collapsed on non-finite features, a hub share
    above 0.5 or R@50 below 1."""
    import torch_collapse_probe as cp

    args = cp.build_parser().parse_args(["--out", str(tmp_path),
                                         "--seeds", "3", "4"])
    argv = cp.flowmining_argv(cp.probe_args(args), str(tmp_path),
                              cp.EPOCHS_PREFIX, "rgb.pth.tar", "flow.pth.tar",
                              2)
    assert argv[argv.index("--seed") + 1] == "3"
    assert argv[argv.index("--epochs") + 1] == "2"
    wd = tmp_path / "wd"
    for i, prefix in enumerate(["cyc_cf", cp.EPOCHS_PREFIX, cp.FP32_PREFIX]):
        ck = wd / f"log-{prefix}" / "exp" / "model" / "epoch5.pth.tar"
        ck.parent.mkdir(parents=True)
        ck.write_bytes(b"")
        os.utime(ck, (1000 + i, 1000 + i))  # the probe's are newer
    assert "log-cyc_cf/" in drive_coclr_cycle.latest_ckpt(str(wd), "cyc_cf")
    assert cp.collapsed({"R@50": 0.9})
    assert cp.collapsed({"R@50": 1.0, "features": {"hub_share": 0.6}})
    assert cp.collapsed({"nonfinite_features": True,
                         "features": {"hub_share": None}})
    assert not cp.collapsed({"R@50": 1.0, "features": {"hub_share": 0.5}})


def test_collapse_probe_drives_never_share_a_workdir(tmp_path, monkeypatch):
    """Without --workroot each probe gets a new directory under the
    temporary directory; a given --workroot that already holds a seed's
    workdir is refused, so that no drive resumes from another run's logs
    and checkpoints."""
    import torch_collapse_probe as cp

    monkeypatch.setattr(cp.tempfile, "tempdir", str(tmp_path))
    roots = []
    for _ in range(2):
        args = cp.build_parser().parse_args(["--out", str(tmp_path / "o")])
        assert cp.make_workroot(args)
        roots.append(args.workroot)
    assert roots[0] != roots[1]
    assert all(os.path.dirname(r) == str(tmp_path) for r in roots)
    given = tmp_path / "given"
    args = cp.build_parser().parse_args(
        ["--out", str(tmp_path / "o"), "--workroot", str(given),
         "--seeds", "3", "4"])
    assert not cp.make_workroot(args)
    (given / "cp4").mkdir(parents=True)
    with pytest.raises(SystemExit, match="cp4"):
        cp.make_workroot(args)


# ------------------------------------------------------------ resume rules


def test_run_cli_resume_skip(tmp_path):
    """A phase whose saved log shows completion is not re-run (wall None
    marks the resume), but a degenerate 0-progress 'finished' log fails
    the validator and does rerun (and fails here: no such module)."""
    drive = drive_coclr_cycle
    log_dir = tmp_path / "logs"
    log_dir.mkdir()
    (log_dir / "ph.log").write_text(LOG)
    ok = lambda t: bool(drive.parse_epochs(t))
    text, wall = drive.run_cli(
        "ph", ["-m", "definitely_no_such_module"], str(tmp_path),
        str(log_dir), done_marker="finished", validate=ok)
    assert wall is None and "finished" in text

    (log_dir / "ph0.log").write_text(
        "Epoch: [0][0] T-epoch:0.00\nTraining from ep 0 to ep 1 finished\n")
    with pytest.raises(RuntimeError, match="failed"):
        drive.run_cli("ph0", ["-m", "definitely_no_such_module"],
                      str(tmp_path), str(log_dir), done_marker="finished",
                      validate=ok)
    # partial_ok accepts an unfinished log
    (log_dir / "cut.log").write_text(LOG.replace("finished", ""))
    text, wall = drive.run_cli(
        "cut", ["-m", "definitely_no_such_module"], str(tmp_path),
        str(log_dir), done_marker="finished", validate=ok,
        partial_ok=lambda prev: bool(drive.parse_epochs(prev)))
    assert wall is None


def test_run_cli_runs_from_the_workdir_with_the_repo_prepended(tmp_path,
                                                               monkeypatch):
    """The subprocess runs with cwd = the workdir and finds the port from
    there: PYTHONPATH gets the repository prepended, not replaced."""
    monkeypatch.setenv("PYTHONPATH", "/some/site/hook")
    script = ("import os, sys, coclr_tpu_torch; print(os.getcwd()); "
              "print(os.environ['PYTHONPATH']); print('finished')")
    text, wall = drive_coclr_cycle.run_cli(
        "env", ["-c", script], str(tmp_path), str(tmp_path / "logs"),
        done_marker="finished")
    cwd, pythonpath = text.splitlines()[:2]
    assert wall is not None and cwd == str(tmp_path)
    assert pythonpath == REPO + ":/some/site/hook"


def test_launch_counts_reach_a_parent_through_the_environment(tmp_path):
    """With COCLR_KERNEL_COUNTS set, a process that loaded the kernel
    wrappers appends its argv and launch counts (0 on the CPU) at exit;
    without it, nothing is written."""
    from coclr_tpu_torch.kernels import build

    path = tmp_path / "counts.jsonl"
    code = "import coclr_tpu_torch.kernels.jitter, coclr_tpu_torch.kernels.pool"
    for env in ({build.COUNTS_ENV: str(path)}, {}):
        subprocess.run([sys.executable, "-c", code, "x"], cwd=REPO,
                       env=dict(os.environ, **env), check=True, timeout=120)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 1
    assert lines[0]["argv"] == ["-c", "x"]
    assert lines[0]["counts"] == {"jitter": 0, "pool1d_bwd": 0}


def test_seed_report_preserves_prior_artifact(tmp_path):
    drive = drive_coclr_cycle
    out = tmp_path / "ART.json"
    out.write_text(json.dumps({
        "config": {"cycles": 1},
        "phases": {"coclr_flowmining": {"wall_min": 52.0,
                                        "self_acc1_final": 0.0367,
                                        "epochs": []}},
        "total_wall_min": 223.8}))
    report, prior = drive.seed_report(str(out), {"cycles": 2})
    assert report["phases"]["coclr_flowmining"]["wall_min"] == 52.0
    assert report["config"] == {"cycles": 2}
    assert prior == 223.8
    report, prior = drive.seed_report(str(tmp_path / "none.json"), {})
    assert report["phases"] == {} and prior == 0.0
    out.write_text("{not json")
    report, prior = drive.seed_report(str(out), {})
    assert report["phases"] == {} and prior == 0.0


def test_partial_nce_requires_log_progress():
    assert drive_coclr_cycle.parse_epochs(LOG)
    degenerate = "Epoch: [0][0] T-epoch:0.00\nTraining finished\n"
    assert not drive_coclr_cycle.parse_epochs(degenerate)


def test_report_goes_under_the_workdir(tmp_path):
    wd = str(tmp_path / "wd")
    assert drive_coclr_cycle.report_path(wd, "DRIVE_x") == os.path.join(
        wd, "DRIVE_x.json")
    assert drive_coclr_cycle.report_path(wd, "/abs/R", ".md") == "/abs/R.md"


# ------------------------------------------------------------ staging

STAGING = {
    "in_memory": dict(n_classes=4, n_groups=3, n_clips=3, n_frames=12,
                      in_memory=True, seed=0),
    "frames_dir_short": dict(n_classes=2, n_groups=4, n_clips=3,
                             n_frames=12, short_frac=0.4, seed=1),
    "two_grating_code": dict(n_classes=12, n_groups=2, n_clips=2,
                             n_frames=10, in_memory=True, seed=2),
}


@pytest.mark.parametrize("case", sorted(STAGING))
def test_drive_staging_is_the_jax_packages_byte_for_byte(case, tmp_path):
    """The drive's learnable synthetic UCF (its groups rendered on threads
    in the port) equals coclr_tpu.data.synthetic's on the same arguments:
    the LMDB files and the split metadata, byte for byte."""
    import hashlib

    from coclr_tpu.data import synthetic as jsynth
    from coclr_tpu_torch.data import synthetic

    def digest(out):
        h = hashlib.sha256()
        for key in ("db_path", "db_path_flow", "root"):
            paths = ([out[key]] if os.path.isfile(out[key]) else
                     [os.path.join(d, f) for d, _, files in
                      sorted(os.walk(out[key])) for f in sorted(files)])
            for path in paths:
                if not path.endswith("-lock"):
                    with open(path, "rb") as fh:
                        h.update(os.path.basename(path).encode() + b"\0"
                                 + fh.read())
        return h.hexdigest()

    kw = dict(STAGING[case], size=(24, 32), flow=True, content="learnable",
              test_groups=1)
    got = synthetic.make_synthetic_ucf(str(tmp_path / "port"), **kw)
    want = jsynth.make_synthetic_ucf(str(tmp_path / "jax"), **kw)
    assert digest(got) == digest(want)


# ------------------------------------------------------------ host feed


def test_host_feed_tools_at_a_tiny_size(monkeypatch):
    """bench_loader and budget_host_feed on the port's loader: every plane
    the host has gives a positive rate; the pure-Python one always runs."""
    monkeypatch.delenv("COCLR_NO_NATIVE", raising=False)
    rep = bench_loader.main(["--seq_len", "4", "--img_dim", "16",
                             "--batch_size", "2", "--workers", "2",
                             "--steps", "2", "--frame_size", "24,32"])
    assert rep["python"] > 0 and rep["python_process"] > 0
    assert (rep["native"] is None) == (rep["native_process"] is None)
    budget = budget_host_feed.main(["--seq_len", "4", "--img_dim", "16",
                                    "--frame_size", "24,32"])
    py = budget["planes"]["python"]
    assert py["per_clip_ms"] > 0 and py["cores_per_card"] > 0
    assert set(budget["planes"]) == {"hybrid", "cpp", "python"}
    assert "COCLR_NO_NATIVE" not in os.environ


# ------------------------------------------------------------ end to end


@pytest.mark.slow
def test_cpu_drive_end_to_end_and_its_checkpoint_chain(tmp_path):
    """`python -m coclr_tpu_torch.tools.drive_coclr_cycle --device cpu` at
    S3D, seq_len 8, img_dim 32: 12 train videos make 6 steps of 2, and K =
    8 opens CoCLR's gate at step 5. Every phase exits 0 with progress
    lines, both CoCLR logs carry Self-acc@1, FlowMining's sampler is the
    flow init's encoder_q bit for bit and its encoder_q moved, RGBMining's
    (--reverse) sampler is FlowMining's encoder_q and its encoder_q moved,
    and all four retrievals give R@1 in [0, 1] over finite features."""
    wd = tmp_path / "cyc"
    out = subprocess.run(
        [sys.executable, "-m", "coclr_tpu_torch.tools.drive_coclr_cycle",
         "--device", "cpu", "--workdir", str(wd), "--seq_len", "8",
         "--img_dim", "32", "--batch_size", "2", "--moco_k", "8",
         "--n_classes", "2", "--n_groups", "3", "--n_clips", "3",
         "--test_groups", "1", "--epochs_nce", "1", "--epochs_coclr", "1",
         "--skip_downstream", "--workers", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    rep = json.loads((wd / "DRIVE_coclr_cycle.json").read_text())
    assert rep["config"]["card"] == "cpu"
    logs = {p.stem: p.read_text() for p in (wd / "drivelogs").iterdir()}
    for tag in ("nce_rgb", "nce_flow", "coclr_flowmining", "coclr_rgbmining"):
        steps = re.findall(r"Epoch:\[0\]\[\s*(\d+)/(\d+)\]", logs[tag])
        assert steps[-1] == ("5", "6"), tag
        assert rep["phases"][tag]["epochs"]
    for tag in ("coclr_flowmining", "coclr_rgbmining"):
        assert len(drive_coclr_cycle.SELF_RE.findall(logs[tag])) == 2
    retr = [t for t in rep["phases"] if t.startswith("retrieval_")]
    assert len(retr) == 4
    assert all(0.0 <= rep["phases"][t]["R@1"] <= 1.0 for t in retr)
    assert all(rep["phases"][t]["features"]["finite"] for t in retr)
    chain, paths = drive_coclr_cycle.checkpoint_chain(str(wd))
    assert chain == dict.fromkeys(chain, True) and len(chain) == 4
    assert "-R_" in paths["rgbmining"]  # the --reverse experiment
    assert (wd / "DRIVE_coclr_cycle.md").exists()
