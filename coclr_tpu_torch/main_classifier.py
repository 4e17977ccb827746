"""Finetune / linear-probe / retrieval / N-crop test CLI of the port:
`python -m coclr_tpu_torch.main_classifier [flags]`.

Takes the flags of the repository's eval/main_classifier.py (the
reference's eval/main_classifier.py flags plus the JAX package's knobs).
`--device` picks the device: cuda (the default; cuda:LOCAL_RANK under
torchrun) or cpu. Training also runs on N cards, one process each:

    torchrun --nproc_per_node N -m coclr_tpu_torch.main_classifier \
        --train_what ft|last|all [--sp_size S] [--sph_size H] [flags]

with `--batch_size` per data shard, `--dist-backend` (nccl, or gloo when
asked; the CPU is always gloo), `--num_devices` (when set, it must equal
WORLD_SIZE) and sequence parallelism acted on: `--sp_size S` /
`--sph_size H` shard each clip's T / H axis over S x H ranks (which must
divide the launch) in training and validation (ops/seqpar.py), the
global batch being batch_size x WORLD_SIZE / (S x H). The --test paths
run in one process, unsharded, as they do in the JAX package, and refuse
a launch of several; a one-process --test with --sp_size runs unsharded.
Accepted and ignored: `--gpu`, `--ckpt_format` and reference flags with
no effect there (`--num_seq`, `--num_fc`, `--eval_freq`, `--reset_lr`,
`--cos`).

  train:      --train_what last|ft|all [--pretrain <pretrain .pth.tar>]
  retrieval:  --test <pretrain .pth.tar> --retrieval [--dirname feature]
  N-crop:     --test <classifier .pth.tar> --center_crop|--five_crop|--ten_crop
"""

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--net', default='s3d', type=str)
    parser.add_argument('--model', default='lincls', type=str)
    parser.add_argument('--dataset', default='ucf101', type=str)
    parser.add_argument('--which_split', default=1, type=int)
    parser.add_argument('--seq_len', default=32, type=int)
    parser.add_argument('--ds', default=1, type=int)
    parser.add_argument('--batch_size', default=32, type=int)
    parser.add_argument('--optim', default='adam', type=str)
    parser.add_argument('--lr', default=1e-3, type=float)
    parser.add_argument('--schedule', default=[60, 80], nargs='*', type=int)
    parser.add_argument('--wd', default=1e-3, type=float)
    parser.add_argument('--dropout', default=0.9, type=float)
    parser.add_argument('--epochs', default=10, type=int)
    parser.add_argument('--start_epoch', default=0, type=int)
    parser.add_argument('--train_what', default='last', type=str)
    parser.add_argument('--img_dim', default=128, type=int)
    parser.add_argument('--print_freq', default=5, type=int)
    parser.add_argument('--prefix', default='linclr', type=str)
    parser.add_argument('-j', '--workers', default=8, type=int)
    parser.add_argument('--resume', default='', type=str)
    parser.add_argument('--pretrain', default='', type=str)
    parser.add_argument('--test', default='', type=str)
    parser.add_argument('--retrieval', action='store_true')
    parser.add_argument('--dirname', default=None, type=str)
    parser.add_argument('--center_crop', action='store_true')
    parser.add_argument('--five_crop', action='store_true')
    parser.add_argument('--ten_crop', action='store_true')
    parser.add_argument('--max_windows', default=0, type=int,
                        help='>0: eval datasets decode only the center '
                             'max_windows windows per video (0 = every '
                             'window, the reference protocol)')
    # accepted for CLI compatibility and ignored
    parser.add_argument('--num_seq', default=1, type=int)
    parser.add_argument('--num_fc', default=1, type=int)
    parser.add_argument('--gpu', default=None, type=str)
    parser.add_argument('--eval_freq', default=1, type=int)
    parser.add_argument('--reset_lr', action='store_true')
    parser.add_argument('--cos', action='store_true')
    parser.add_argument('--ckpt_format', default='flax', type=str)
    # acted on by the port
    parser.add_argument('--sp_size', default=1, type=int,
                        help='ranks that share each clip along T (training '
                             'and validation; the test paths run unsharded)')
    parser.add_argument('--sph_size', default=1, type=int,
                        help='ranks that share each clip along H')
    parser.add_argument('--dist-backend', default='nccl', type=str,
                        choices=['nccl', 'gloo'])
    parser.add_argument('--num_devices', default=0, type=int,
                        help='0, or the number of ranks (WORLD_SIZE)')
    parser.add_argument('--compute_dtype', default='bfloat16', type=str,
                        choices=['bfloat16', 'float32'])
    parser.add_argument('--data_root', default='', type=str)
    parser.add_argument('--worker_mode', default='thread', type=str,
                        choices=['thread', 'process'])
    parser.add_argument('--device', default='cuda', type=str,
                        help='cuda (default) or cpu')
    return parser.parse_args(argv)


def cfg_from_args(args):
    from coclr_tpu_torch.config import EvalConfig

    return EvalConfig(
        net=args.net, model=args.model, dataset=args.dataset,
        which_split=args.which_split, seq_len=args.seq_len, ds=args.ds,
        batch_size=args.batch_size, lr=args.lr,
        schedule=tuple(args.schedule), wd=args.wd, dropout=args.dropout,
        epochs=args.epochs, start_epoch=args.start_epoch,
        img_dim=args.img_dim, print_freq=args.print_freq, optim=args.optim,
        train_what=args.train_what, workers=args.workers,
        resume=args.resume, pretrain=args.pretrain, test=args.test,
        retrieval=args.retrieval, ten_crop=args.ten_crop,
        center_crop=args.center_crop, five_crop=args.five_crop,
        prefix=args.prefix, max_windows=args.max_windows,
        compute_dtype=args.compute_dtype, data_root=args.data_root,
        worker_mode=args.worker_mode, dist_backend=args.dist_backend,
        num_devices=args.num_devices, sp_size=args.sp_size,
        sph_size=args.sph_size)


def run_test(cfg, device, dirname=None):
    """--test: retrieval from a pretraining checkpoint, or the N-crop test
    of a classifier checkpoint, in one process and unsharded (cfg.sp_size
    and cfg.sph_size do not apply)."""
    from coclr_tpu_torch.data import hostaug
    from coclr_tpu_torch.evalsuite import driver, ncrop, retrieval
    from coclr_tpu_torch.parallel import dist
    from coclr_tpu_torch.utils import prepare_run
    from coclr_tpu_torch.utils.checkpoint import load_checkpoint

    if dist.launched() and int(os.environ["WORLD_SIZE"]) > 1:
        raise RuntimeError(
            "--test (retrieval, N-crop) runs in one process: launch it "
            "without torchrun, or with --nproc_per_node 1")

    device = prepare_run(device)
    model = driver.build_model(cfg)
    out_dir = os.path.dirname(cfg.test)
    if cfg.retrieval:
        driver.load_pretrained_backbone(model, cfg.test)
        model.to(device)
        policy = hostaug.EvalClipPolicy(img_dim=cfg.img_dim, mode="test",
                                        crop_where=5)
        train_ds = driver.build_eval_dataset(cfg, "train", policy=policy)
        test_ds = driver.build_eval_dataset(cfg, "test", policy=policy)
        return retrieval.run_retrieval(
            model, cfg, train_ds, test_ds,
            os.path.join(out_dir, dirname or "feature"))
    if cfg.center_crop or cfg.five_crop or cfg.ten_crop:
        model.load_state_dict(load_checkpoint(cfg.test)["state_dict"])
        model.to(device)
        return ncrop.run_ncrop_test(
            model, cfg,
            lambda policy: driver.build_eval_dataset(cfg, "test", policy=policy),
            out_dir, os.path.basename(cfg.test))
    # the reference's test() also rejects --test without a mode flag
    raise NotImplementedError("--test needs --retrieval or a crop flag")


def main(argv=None):
    args = parse_args(argv)
    cfg = cfg_from_args(args)
    if cfg.test:
        return run_test(cfg, args.device, args.dirname)
    from coclr_tpu_torch.evalsuite.driver import run_classifier_train

    return run_classifier_train(cfg, device=args.device)


if __name__ == '__main__':
    main()
