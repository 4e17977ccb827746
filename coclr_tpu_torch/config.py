"""Typed configuration of the port. Field names mirror the reference CLI
flags (main_nce.py, main_coclr.py, eval/main_classifier.py) and
coclr_tpu/config.py's PretrainConfig and EvalConfig; only the fields the
port acts on are kept, and the dtype is a string."""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class PretrainConfig:
    net: str = "s3d"
    model: str = "infonce"
    dataset: str = "ucf101-2clip"
    seq_len: int = 32
    num_seq: int = 2
    ds: int = 1
    batch_size: int = 32
    lr: float = 1e-3
    schedule: Tuple[int, ...] = (120, 160)
    wd: float = 1e-5
    epochs: int = 10
    start_epoch: int = 0
    print_freq: int = 5
    save_freq: int = 1
    img_dim: int = 128
    prefix: str = "pretrain"
    name_prefix: str = ""
    workers: int = 16
    seed: int = 0
    resume: str = ""
    # one path (main_nce), or CoCLR's pair (to-train, sampler)
    pretrain: Union[str, Tuple[str, str]] = ""
    test: str = ""

    moco_dim: int = 128
    moco_k: int = 2048
    moco_m: float = 0.999
    moco_t: float = 0.07
    cos: bool = False

    # coclr (main_coclr.py)
    topk: int = 5
    reverse: bool = False

    compute_dtype: str = "bfloat16"
    data_root: str = ""
    worker_mode: str = "thread"
    profile_steps: int = 0              # >0: trace N steps of the first epoch

    # data parallelism across ranks (parallel/dist.py)
    bn_shuffle: str = "gather"          # gather | alltoall | none
    dist_backend: str = "nccl"          # nccl | gloo (the CPU is always gloo)
    num_devices: int = 0                # 0, or the launcher's WORLD_SIZE
    # sequence parallelism (ops/seqpar.py): ranks that share a clip's T / H
    sp_size: int = 1
    sph_size: int = 1

    @property
    def dtype(self):
        return DTYPES[self.compute_dtype]


@dataclasses.dataclass
class EvalConfig:
    """Finetune, linear probe, retrieval and N-crop test
    (eval/main_classifier.py flags)."""

    net: str = "s3d"
    model: str = "lincls"
    dataset: str = "ucf101"
    which_split: int = 1
    seq_len: int = 32
    ds: int = 1
    batch_size: int = 32
    lr: float = 1e-3
    schedule: Tuple[int, ...] = (60, 80)
    wd: float = 1e-3
    dropout: float = 0.9
    epochs: int = 10
    start_epoch: int = 0
    img_dim: int = 128
    print_freq: int = 5
    optim: str = "sgd"
    train_what: str = "last"            # last | ft | all
    seed: int = 0
    workers: int = 16
    resume: str = ""
    pretrain: str = ""
    test: str = ""
    retrieval: bool = False
    ten_crop: bool = False
    center_crop: bool = False
    five_crop: bool = False
    prefix: str = "linclr"
    max_windows: int = 0                # >0: eval datasets decode only the
                                        # CENTER max_windows windows per video
    compute_dtype: str = "bfloat16"
    data_root: str = ""
    worker_mode: str = "thread"
    dist_backend: str = "nccl"
    num_devices: int = 0
    # sequence parallelism of the classifier's training and validation
    # (ops/seqpar.py); the --test paths run unsharded
    sp_size: int = 1
    sph_size: int = 1

    @property
    def dtype(self):
        return DTYPES[self.compute_dtype]
