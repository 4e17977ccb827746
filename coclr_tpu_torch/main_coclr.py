"""CoCLR co-training CLI of the port:
`python -m coclr_tpu_torch.main_coclr [flags]`, or on N cards
`torchrun --nproc_per_node N -m coclr_tpu_torch.main_coclr [flags]`.

Takes the flags of the repository's main_coclr.py: `--topk`, `--reverse`
and `--pretrain <to-train> <sampler>` (two `.pth.tar` files; `random random`
trains from scratch). The data-parallel flags (`--dist-backend`,
`--bn_shuffle`, `--num_devices`), the sequence-parallel `--sp_size` and
`--sph_size` (the RGB and flow chunks of a member, and the frozen
sampler's forward, are sharded alike) and `--profile_steps N` (a trace of
N steps into <exp>/trace) are acted on and the rest accepted and ignored,
as in main_nce (its docstring lists them). `--device` picks the device:
cuda (the default) or cpu.
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
