"""Linear probe on cached features, CLI of the port:
`python -m coclr_tpu_torch.feature_linear_probe [flags]`.

Takes the flags of the repository's eval/feature_linear_probe.py: the
feature cache of `--test <ckpt> --retrieval` is read from
`dirname(--test)/--dirname`, and the best epoch's probabilities go to
`<cache>/<ckpt>-lp-<dataset>-prob.json`. `--device` picks the device: cuda
(the default) or cpu.
"""

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--test', default='', type=str)
    parser.add_argument('--dataset', default='ucf101', type=str)
    parser.add_argument('--dirname', default='feature', type=str)
    parser.add_argument('--batch_size', default=1024, type=int)
    parser.add_argument('--lr', default=1.0, type=float)
    parser.add_argument('--wd', default=1e-3, type=float)
    parser.add_argument('--epochs', default=100, type=int)
    parser.add_argument('--eval_freq', default=5, type=int)
    parser.add_argument('--verbose', default=0, type=int)
    parser.add_argument('--schedule', default=[60, 80], nargs='*', type=int)
    parser.add_argument('--normalize', action='store_true')
    parser.add_argument('--final_bn', action='store_true')
    parser.add_argument('--device', default='cuda', type=str,
                        help='cuda (default) or cpu')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from coclr_tpu_torch.evalsuite.feature_probe import run_feature_probe
    from coclr_tpu_torch.evalsuite.retrieval import load_feature_cache
    from coclr_tpu_torch.utils import prepare_run

    device = prepare_run(args.device)
    cache_dir = os.path.join(os.path.dirname(args.test), args.dirname)
    if not os.path.exists(os.path.join(
            cache_dir, f"{args.dataset}_train_feature.pth.tar")):
        print('feature path does not exist')
        return None
    train_f, train_l, _ = load_feature_cache(cache_dir, args.dataset, "train")
    test_f, test_l, test_v = load_feature_cache(cache_dir, args.dataset, "test")
    prob_json = os.path.join(
        cache_dir, '%s-lp-%s-prob.json' % (os.path.basename(args.test),
                                           args.dataset))
    return run_feature_probe(
        train_f, train_l, test_f, test_l, test_vname=test_v, lr=args.lr,
        wd=args.wd, epochs=args.epochs, batch_size=args.batch_size,
        schedule=tuple(args.schedule), normalize=args.normalize,
        final_bn=args.final_bn, eval_freq=args.eval_freq,
        prob_json_path=prob_json, device=device)


if __name__ == '__main__':
    main()
