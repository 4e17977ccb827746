"""Two-stream fusion CLI of the port:
`python -m coclr_tpu_torch.merge_2stream_prob [flags]`.

Takes the flags of the repository's eval/merge_2stream_prob.py: `--mode c`
merges two N-crop (or feature-probe) probability jsons, `--class_ind` naming
ClassInd.txt; `--mode s` merges the RGB (`--prob1`) and flow (`--prob2`)
feature-cache directories. The fusion is host numpy; `--device` (cuda, the
default, or cpu) is resolved as every entry point of the port resolves it.
"""

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--prob1', default='', type=str)
    parser.add_argument('--prob2', default='', type=str)
    parser.add_argument('--dataset', default='ucf101', type=str)
    parser.add_argument('--mode', default='c', type=str)
    parser.add_argument('--class_ind', default='', type=str,
                        help="path to ClassInd.txt (replaces the reference's "
                             "hard-coded paths)")
    parser.add_argument('--device', default='cuda', type=str,
                        help='cuda (default) or cpu')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from coclr_tpu_torch.evalsuite.merge import merge_prob, merge_sim
    from coclr_tpu_torch.utils import prepare_run

    prepare_run(args.device)
    if args.mode == 'c':
        if not args.class_ind:
            raise SystemExit('--class_ind is required for mode c')
        with open(args.class_ind) as f:
            action_list = [line.strip() for line in f if line.strip()]
        if ',' in action_list[0]:
            action_list = [i.split(',')[-1] for i in action_list]
        return merge_prob(args.prob1, args.prob2, action_list,
                          k400_style=args.dataset == 'k400')
    if args.mode == 's':
        return merge_sim(args.prob1, args.prob2, args.dataset)
    raise SystemExit(f'unknown mode {args.mode!r}')


if __name__ == '__main__':
    main()
