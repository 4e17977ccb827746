"""The work counts against hand counts at small shapes."""

import torch
from torch import nn

from gpubench import counts
from gpubench.reference import models


def _conv_flops(enc, x):
    """2 x output elements x (in channels x kernel volume) of every
    convolution on the way, by forward hooks."""
    total = []

    def hook(mod, inp, out):
        total.append(2 * out.numel() * mod.in_channels
                     * mod.kernel_size[0] * mod.kernel_size[1]
                     * mod.kernel_size[2])

    orig = models.conv

    def conv(mod, x, prec):
        out = orig(mod, x, prec)
        hook(mod, (x,), out)
        return out

    models.conv = conv
    try:
        with torch.no_grad():
            enc.backbone(x)
    finally:
        models.conv = orig
    return sum(total)


def test_step_flops_by_hand():
    b, t, s, dim, k = 2, 8, 32, 16, 32
    enc = models.Encoder("s3d", dim)
    x = torch.randn(b, 3, t, s, s)
    fwd = _conv_flops(enc, x)
    stem = enc.backbone.Conv_1a.conv1
    stem_out = 2 * b * stem.out_channels * (t * (s // 2) * (s // 2)) \
        * 3 * 49  # its input gradient is never taken
    head = 2 * b * (1024 * 1024 + 1024 * dim)
    logits = 2 * b * dim * k
    # key forward, query forward, query backward (2 x, less the stem's
    # input gradient), the logits and their gradient to q
    want = (fwd + head) * 2 + (2 * (fwd + head) - stem_out) + logits * 2
    got = counts.step_flops("s3d", b, t, s, dim, k, "infonce")
    assert abs(got - want) / want < 1e-6, (got, want)


def test_pool_launches_s3d_and_r50():
    assert len(counts.pool_launches("s3d", 2, 8, 32)) == 37
    launches = counts.pool_launches("r50", 2, 8, 32)
    # the stem pool on [2, 64, 4, 16, 16]: H then W, k 3, s 2, pad 1
    assert launches == [(2 * 64 * 4, 16, 8, 16), (2 * 64 * 4 * 8, 16, 8, 1)]
    want = sum(2 * 2 * p * q * (n + m) for p, n, m, q in launches)
    assert counts.pool_bwd_bytes(launches) == want
    assert want == 2 * 2 * (512 * 16 * 24 + 4096 * 1 * 24)


def test_jitter_bytes():
    # 10 frames of 8 x 8: 192 uint8 in, 192 bf16 out each, 24 B of params
    assert counts.jitter_bytes(10, 8) == 10 * (192 * 3 + 24)
    assert counts.jitter_bytes(10, 8, itemsize=4) == 10 * (192 * 5 + 24)


def test_reference_matches_the_port_init():
    from coclr_tpu_torch.models.moco import MoCo

    from gpubench.reference.models import ref_name
    from gpubench.reference.step import RefMoCo

    seed = 2 ** 31 + 99
    for net in ("s3d", "r50"):
        port = MoCo(net, 16, 32, torch.float32,
                    gen=torch.Generator().manual_seed(seed), variant="coclr")
        ref = RefMoCo(net, 16, 32, seed, "coclr", "cpu")
        mine = dict(ref.enc_q.named_parameters())
        for name, p in port.encoder_q.named_parameters():
            assert torch.equal(p.detach(), mine[ref_name(name)].detach()), name
        assert torch.equal(port.queue, ref.queue)
        assert torch.equal(port.queue_second, ref.queue_second)
        assert isinstance(ref.enc_q.backbone, nn.Module)
