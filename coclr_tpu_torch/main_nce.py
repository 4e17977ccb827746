"""InfoNCE / UberNCE pretraining CLI of the port:
`python -m coclr_tpu_torch.main_nce [flags]` (`--model infonce` or
`ubernce`), on one card, or on N cards with one process each:

    torchrun --nproc_per_node N -m coclr_tpu_torch.main_nce [flags]

Takes the flags of the repository's main_nce.py (the reference's
main_nce.py flags plus the JAX package's knobs). `--device` picks the
device: cuda (the default; cuda:LOCAL_RANK under torchrun) or cpu. Under a
launcher these are acted on: `--batch_size` (per card: the global batch is
batch_size x ranks), `--dist-backend` (nccl, or gloo when asked; the CPU is
always gloo), `--bn_shuffle` (gather, alltoall or none) and
`--num_devices` (when set, it must equal WORLD_SIZE); `--profile_steps N`
traces N steps of the first epoch into <exp>/trace (a gzipped Chrome trace
per rank; train/pretrain.py). `--sp_size S` and `--sph_size H` shard each
clip's T axis over S ranks and its H axis over H ranks (sequence
parallelism, ops/seqpar.py): S x H must divide the ranks, and the global
batch is then batch_size x ranks / (S x H):

    torchrun --nproc_per_node N -m coclr_tpu_torch.main_nce --sp_size S \
        [--sph_size H] [flags]

Accepted and ignored:
`--gpu`, `--world-size`, `--rank`, `--dist-url`,
`--multiprocessing-distributed`, `--local_rank` (torchrun's environment
gives them), the mesh knob `--dcn_size`, `--multihost` and its flags,
`--aug_backend`, `--aug_order`, `--ckpt_format` and `--reset_lr`.
`build_parser(coclr=True)` gives the flags of main_coclr.py
(coclr_tpu_torch/main_coclr.py).
"""

import argparse


def build_parser(coclr: bool = False):
    parser = argparse.ArgumentParser()
    parser.add_argument('--net', default='s3d', type=str)
    parser.add_argument('--model', default='coclr' if coclr else 'infonce',
                        type=str)
    if coclr:
        parser.add_argument('--topk', default=5, type=int)
        parser.add_argument('--reverse', action='store_true')
    parser.add_argument('--dataset', type=str,
                        default='ucf101-2stream-2clip' if coclr else 'ucf101-2clip')
    parser.add_argument('--seq_len', default=32, type=int,
                        help='number of frames in each video block')
    parser.add_argument('--num_seq', default=2, type=int)
    parser.add_argument('--ds', default=1, type=int,
                        help='frame down sampling rate')
    parser.add_argument('--batch_size', default=32, type=int,
                        help='per-device batch size')
    parser.add_argument('--lr', default=1e-3, type=float)
    parser.add_argument('--schedule', default=[120, 160], nargs='*', type=int)
    parser.add_argument('--wd', default=1e-5, type=float)
    parser.add_argument('--resume', default='', type=str)
    if coclr:
        parser.add_argument('--pretrain', default=['random', 'random'],
                            nargs=2, type=str,
                            help='paths: [to-train, oracle/sampler]')
    else:
        parser.add_argument('--pretrain', default='', type=str)
    parser.add_argument('--test', default='', type=str)
    parser.add_argument('--epochs', default=10, type=int)
    parser.add_argument('--start_epoch', default=0, type=int)
    parser.add_argument('--print_freq', default=5, type=int)
    parser.add_argument('--save_freq', default=1, type=int)
    parser.add_argument('--img_dim', default=128, type=int)
    parser.add_argument('--prefix', default='pretrain', type=str)
    parser.add_argument('--name_prefix', default='', type=str)
    parser.add_argument('-j', '--workers', default=16, type=int)
    parser.add_argument('--seed', default=0, type=int)
    # data parallelism, acted on by the port (parallel/dist.py)
    parser.add_argument('--dist-backend', default='nccl', type=str,
                        choices=['nccl', 'gloo'])
    parser.add_argument('--bn_shuffle', default='gather', type=str,
                        choices=['gather', 'none', 'alltoall'])
    parser.add_argument('--num_devices', default=0, type=int,
                        help='0, or the number of ranks (WORLD_SIZE)')
    # sequence parallelism, acted on by the port (ops/seqpar.py)
    parser.add_argument('--sp_size', default=1, type=int,
                        help='ranks that share each clip\'s T axis')
    parser.add_argument('--sph_size', default=1, type=int,
                        help='ranks that share each clip\'s H axis')
    # accepted for CLI compatibility and ignored
    parser.add_argument('--gpu', default=None)
    parser.add_argument('--world-size', default=-1, type=int)
    parser.add_argument('--rank', default=-1, type=int)
    parser.add_argument('--dist-url', default='env://', type=str)
    parser.add_argument('--multiprocessing-distributed', action='store_true')
    parser.add_argument('--local_rank', default=-1, type=int)
    parser.add_argument('--reset_lr', action='store_true')
    parser.add_argument('--aug_backend', default='auto', type=str)
    parser.add_argument('--aug_order', default='shuffle', type=str)
    parser.add_argument('--dcn_size', default=1, type=int)
    parser.add_argument('--ckpt_format', default='flax', type=str)
    parser.add_argument('--multihost', action='store_true')
    parser.add_argument('--coordinator', default='', type=str)
    parser.add_argument('--num_processes', default=0, type=int)
    parser.add_argument('--process_id', default=-1, type=int)
    # moco
    parser.add_argument('--moco-dim', default=128, type=int)
    parser.add_argument('--moco-k', default=2048, type=int)
    parser.add_argument('--moco-m', default=0.999, type=float)
    parser.add_argument('--moco-t', default=0.07, type=float)
    parser.add_argument('--cos', action='store_true')
    # acted on by the port
    parser.add_argument('--compute_dtype', default='bfloat16', type=str,
                        choices=['bfloat16', 'float32'])
    parser.add_argument('--data_root', default='', type=str)
    parser.add_argument('--worker_mode', default='thread', type=str,
                        choices=['thread', 'process'])
    parser.add_argument('--device', default='cuda', type=str,
                        help='cuda (default) or cpu')
    parser.add_argument('--profile_steps', default=0, type=int,
                        help='>0: trace N steps of the first epoch into '
                             '<exp>/trace')
    return parser


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def cfg_from_args(args):
    from coclr_tpu_torch.config import PretrainConfig

    return PretrainConfig(
        net=args.net, model=args.model, dataset=args.dataset,
        seq_len=args.seq_len, num_seq=2, ds=args.ds,
        batch_size=args.batch_size, lr=args.lr,
        schedule=tuple(args.schedule), wd=args.wd, epochs=args.epochs,
        start_epoch=args.start_epoch, print_freq=args.print_freq,
        save_freq=args.save_freq, img_dim=args.img_dim, prefix=args.prefix,
        name_prefix=args.name_prefix, workers=args.workers, seed=args.seed,
        resume=args.resume, test=args.test,
        pretrain=(tuple(args.pretrain) if isinstance(args.pretrain, list)
                  else args.pretrain),
        moco_dim=args.moco_dim, moco_k=args.moco_k, moco_m=args.moco_m,
        moco_t=args.moco_t, cos=args.cos, topk=getattr(args, 'topk', 5),
        reverse=getattr(args, 'reverse', False),
        compute_dtype=args.compute_dtype,
        data_root=args.data_root, worker_mode=args.worker_mode,
        bn_shuffle=args.bn_shuffle, dist_backend=args.dist_backend,
        num_devices=args.num_devices, profile_steps=args.profile_steps,
        sp_size=args.sp_size, sph_size=args.sph_size)


def main(argv=None):
    args = parse_args(argv)
    from coclr_tpu_torch.train.pretrain import run_pretrain

    run_pretrain(cfg_from_args(args), device=args.device)


if __name__ == '__main__':
    main()
