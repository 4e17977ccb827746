"""A backbone enters the harness as new files only: a reference module in
nets/, and a configuration whose `net` names it. Here the modules are
written into a temporary nets/ directory, so nothing of the repository is
edited: the port's `tiny` backbone (two conv + BN + ReLU blocks, no pool)
through a whole dry run of a cell, and a toy token backbone (a linear
tubelet embedding, LayerNorm, one attention layer, its own pool over
tokens) through the reference and the counts."""

import json

import pytest
import torch

from gpubench import check, counts, run, trace
from gpubench.reference import models

CARD = {"name": "cpu dry run", "power_limit": None}

TINY = '''
"""The port's `tiny` backbone: two conv + BN + ReLU blocks, no pool."""
from torch import nn

from gpubench.reference.models import FP32, BasicConv3d


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = BasicConv3d(3, 16, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.c2 = BasicConv3d(16, 32, (3, 3, 3), (2, 2, 2), (1, 1, 1))

    def forward(self, x, prec=FP32):
        return self.c2(self.c1(x, prec), prec)


FEATURES = 32
STEM = "0.c1"


def pool(h):
    return h.mean(dim=(2, 3, 4))


def init_(backbone, gen):
    for mod in backbone.modules():
        if isinstance(mod, nn.Conv3d):
            nn.init.normal_(mod.weight, 0.0, 0.01, generator=gen)
        elif isinstance(mod, nn.BatchNorm3d):
            mod.reset_parameters()


def stem(backbone, x, prec=FP32):
    return backbone.c1(x, prec)
'''

TOKENS = '''
"""A toy token backbone on 8 x 32 x 32 clips: 2 x 8 x 8 tubelets embedded
by a Linear, a learned position table, one pre-norm attention layer."""
import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.models import FP32, default_init

WIDTH, TOKENS, TUBE = 32, 64, 3 * 2 * 8 * 8


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = nn.Linear(TUBE, WIDTH)
        self.pos = nn.Parameter(torch.empty(1, TOKENS, WIDTH))
        self.norm = nn.LayerNorm(WIDTH)
        self.qkv = nn.Linear(WIDTH, 3 * WIDTH)
        self.proj = nn.Linear(WIDTH, WIDTH)

    def embedded(self, x, prec):
        b, c, t, h, w = x.shape
        x = x.reshape(b, c, t // 2, 2, h // 8, 8, w // 8, 8)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, TOKENS, TUBE)
        return F.linear(prec.op(x), prec.op(self.embed.weight),
                        self.embed.bias)

    def forward(self, x, prec=FP32):
        h = self.embedded(x, prec) + self.pos
        q, k, v = F.linear(prec.op(self.norm(h)), prec.op(self.qkv.weight),
                           self.qkv.bias).chunk(3, -1)
        a = torch.softmax(prec.op(q) @ prec.op(k).transpose(1, 2)
                          / WIDTH ** 0.5, -1)
        return h + F.linear(prec.op(a @ v), prec.op(self.proj.weight),
                            self.proj.bias)


FEATURES = WIDTH
STEM = "0.embed"


def pool(h):
    return h.mean(dim=1)


def init_(backbone, gen):
    for mod in backbone.modules():
        if isinstance(mod, nn.Linear):
            default_init(mod, gen)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.normal_(mod.weight, 1.0, 0.02, generator=gen)
            nn.init.normal_(mod.bias, 0.0, 0.02, generator=gen)
    nn.init.normal_(backbone.pos, 0.0, 0.02, generator=gen)


def stem(backbone, x, prec=FP32):
    return backbone.embedded(x, prec)
'''


@pytest.fixture
def nets(tmp_path, monkeypatch):
    """A nets/ directory of its own, holding `tiny` and `tokens`."""
    (tmp_path / "tiny.py").write_text(TINY)
    (tmp_path / "tokens.py").write_text(TOKENS)
    monkeypatch.setattr(models, "NETS", str(tmp_path))
    return tmp_path


def _tiny_cell():
    """The s3d InfoNCE cell with `net: tiny`, rehearsed at 4 x 16 x 16
    (`cpu_sizes`), judged by the s3d cell's limits less `pool_bwd`."""
    base = run.resolve("s3d.infonce.resident")
    config = dict(base["config"], net="tiny",
                  cpu_sizes={"seq_len": 4, "img_dim": 16})
    limits = {k: v for k, v in base["limits"].items() if k != "pool_bwd"}
    return dict(base, name="tiny.infonce.resident", config=config,
                limits=limits)


def test_a_third_network_runs_a_cell(nets, monkeypatch):
    cell = run.shrink(_tiny_cell())
    assert (cell["config"]["seq_len"], cell["config"]["img_dim"]) == (4, 16)
    out = run.run_cell(cell, 2 ** 31 + 17, 1.0, True, device="cpu")
    assert "pool_bwd" not in out["values"]
    for traced in (False, True):
        line = run.result_line(cell, out, CARD, traced=traced)
        json.loads(json.dumps(line))
        assert line["correct"], line["checks"]
        assert "stem" in line["checks"] and "pool_bwd" not in line["checks"]
        assert set(line["checks"]) == set(cell["limits"])
    # a metric written as a new file reads the cell's shapes from ctx.cell
    metrics = nets / "metrics"
    metrics.mkdir()
    (metrics / "cell.clip_frames.py").write_text(
        "def read(ctx):\n    return ctx.cell['config']['seq_len']\n")
    monkeypatch.setattr(run, "HERE", str(nets))
    assert run.per_layer(dict(cell, per_layer=["cell.clip_frames"]),
                         out) == {"cell.clip_frames": 4}


def test_a_network_with_no_pool(nets):
    cell = _tiny_cell()
    work = run.work_counts(cell)
    assert work["pool_bytes"] == 0 and work["flops"] > 0
    # a traced window with device work and no pool-backward launch
    window = trace.Window([("kernel", "sm90_gemm", 0.0, 900.0),
                           ("cpu_op", "aten::mm", 0.0, 1000.0)], steps=1)
    ctx = run.Context(None, {}, window, work, cell)
    assert run.reader("pool_bwd.roofline_pct")(ctx) is None
    assert run.reader("step_mfu")(ctx) > 0


def test_a_limit_whose_number_was_not_read_fails():
    """Where the program launched no pool-backward kernel, `pool_bwd` is not
    read: a cell whose limits hold it is then not correct."""
    limits = run.resolve("s3d.infonce.resident")["limits"]
    values = {k: 0.0 for k in limits if k != "pool_bwd"}
    ok, shown = check.judge(values, limits)
    assert not ok and shown["pool_bwd"]["value"] is None
    assert check.judge(dict(values, pool_bwd=0.0), limits)[0]


def test_a_token_network_in_the_reference(nets):
    b, dim, K, width, tokens, tube = 2, 16, 32, 32, 64, 384
    x = torch.randn(b, 3, 8, 32, 32)
    encs = []
    for global_seed, seed in ((1, 7), (2, 7), (1, 8)):
        torch.manual_seed(global_seed)
        enc = models.Encoder("tokens", dim)
        models.init_(enc, torch.Generator().manual_seed(seed))
        encs.append(dict(enc.named_parameters()))
    # every weight is drawn from the generator alone, the Linear and
    # LayerNorm weights and the position table among them
    for name, p in encs[0].items():
        assert torch.equal(p, encs[1][name]), name
    for name in ("backbone.embed.weight", "backbone.qkv.weight",
                 "backbone.norm.weight", "backbone.norm.bias",
                 "backbone.pos", "fc1.weight"):
        assert not torch.equal(encs[0][name], encs[2][name]), name
    assert not torch.equal(encs[0]["backbone.norm.weight"],
                           torch.ones(width))
    with torch.no_grad():
        assert enc(x).shape == (b, dim)
        assert models.stem(enc, x).shape == (b, tokens, width)
    assert models.load_net("tokens").STEM == "0.embed"

    # the step's matmuls: the embedding, qkv, the scores, the weighted
    # values and the projection, then the head
    n = b * tokens
    fwd = 2 * n * (tube * width + width * 3 * width + 2 * tokens * width
                   + width * width)
    head = 2 * b * (width * width + width * dim)
    embed_in = 2 * n * tube * width  # the clips' gradient is never taken
    logits = 2 * b * dim * K
    want = (fwd + head) * 2 + (2 * (fwd + head) - embed_in) + logits * 2
    assert counts.step_flops("tokens", b, 8, 32, dim, K, "infonce") == want
    assert counts.pool_launches("tokens", b, 8, 32) == []


def test_a_missing_network_names_its_file(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError,
                       match=r"gpubench/reference/nets/vivit\.py"):
        models.Encoder("vivit", 16)
    monkeypatch.setattr(models, "NETS", str(tmp_path))
    (tmp_path / "half.py").write_text("FEATURES = 8\n")
    with pytest.raises(AttributeError, match="Backbone"):
        models.load_net("half")


@pytest.mark.parametrize("sizes,want", [(None, (8, 32)),
                                        ({"img_dim": 64}, (8, 64)),
                                        ({"seq_len": 16, "img_dim": 48},
                                         (16, 48))])
def test_cpu_sizes(sizes, want):
    cell = run.resolve("s3d.infonce.resident")
    if sizes is not None:
        cell["config"] = dict(cell["config"], cpu_sizes=sizes)
    c = run.shrink(cell)["config"]
    assert (c["seq_len"], c["img_dim"]) == want
    assert (c["batch_size"], c["moco_k"]) == (4, 16)
