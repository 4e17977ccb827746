"""CoCLR co-training CLI of the port:
`python -m coclr_tpu_torch.main_coclr [flags]`.

Takes the flags of the repository's main_coclr.py: `--topk`, `--reverse`
and `--pretrain <to-train> <sampler>` (two `.pth.tar` files; `random random`
trains from scratch). The knobs the port does not act on (torch-distributed
launch flags, mesh, sequence-parallel, multihost, aug-backend and
checkpoint-format knobs) are accepted and ignored, as in main_nce.
`--device` picks the device: cuda (the default) or cpu.
"""

from coclr_tpu_torch.main_nce import build_parser, cfg_from_args


def parse_args(argv=None):
    return build_parser(coclr=True).parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from coclr_tpu_torch.train.pretrain import run_pretrain

    run_pretrain(cfg_from_args(args), device=args.device)


if __name__ == '__main__':
    main()
