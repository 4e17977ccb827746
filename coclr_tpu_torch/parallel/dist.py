"""Data parallelism over torch.distributed: one process per card, the port's
counterpart of coclr_tpu/parallel/mesh.py (the `data` axis) and
coclr_tpu/parallel/multihost.py.

A launcher such as `torchrun --nproc_per_node N -m coclr_tpu_torch.main_nce`
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; with them,
`maybe_initialize` starts the process group and returns this rank's
`World`. Without them it returns None and every caller runs as one process,
exactly as before.

- Backend: `nccl` for a card by default; `gloo` only when the caller asks
  for it, and always for the CPU. There is no fallback: when NCCL does not
  start, the error stands.
- Device: `cuda:LOCAL_RANK` (utils.resolve_device).
- A second group, always gloo, carries host decisions (the per-step
  preemption flag), so that agreeing on them never waits for the card.

The collectives the steps use: `gather_rows` (the rank-ordered, tiled
all_gather of coclr_tpu/models/moco.py::_gather), `all_to_all_rows` (the
alltoall shuffle's shard exchange), `all_mean`, `all_sum`,
`from_primary` (rank 0's model, optimizer state and loop position on
every rank), `agree_flag`, `setup_print` and `wrap`
(DistributedDataParallel:
a bucketed all-reduce of the gradients, overlapped with the backward, in
place of the JAX step's pmean). Each rank keeps its own BatchNorm running
statistics (broadcast_buffers off), as each device of the JAX mesh does;
rank 0's are the ones checkpointed.
"""

from __future__ import annotations

import builtins
import dataclasses
import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks: `group` carries the tensors
    of the steps (on the device), `host_group` (gloo) the host decisions."""

    rank: int
    size: int
    device: torch.device
    group: Any
    host_group: Any

    @property
    def primary(self) -> bool:
        return self.rank == 0


_WORLD: Optional[World] = None


def launched() -> bool:
    """True in a process a distributed launcher started (RANK and
    WORLD_SIZE set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def pick_backend(device: torch.device, backend: str) -> str:
    """`backend` for a card, gloo for the CPU; raises on anything else."""
    if backend not in BACKENDS:
        raise ValueError(f"--dist-backend {backend!r}: use one of {BACKENDS}")
    return "gloo" if device.type == "cpu" else backend


def initialize(device: torch.device, backend: str, rank: int, size: int,
               init_method: str = "env://") -> World:
    """Start the process group (once per process) and return this rank's
    World. A first all-reduce on the device makes the backend connect
    here, so a backend that cannot start raises now, not at the first
    step."""
    global _WORLD
    if _WORLD is not None:
        if (_WORLD.rank, _WORLD.size) != (rank, size):
            raise RuntimeError(f"process group already started as rank "
                               f"{_WORLD.rank} of {_WORLD.size}")
        return _WORLD
    backend = pick_backend(device, backend)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(minutes=30))
    host = dist.new_group(backend="gloo")
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != size:
        raise RuntimeError(f"{backend} all_reduce over {size} ranks gave "
                           f"{probe.item()}")
    _WORLD = World(rank=rank, size=size, device=device,
                   group=dist.group.WORLD, host_group=host)
    setup_print(rank == 0)
    print(f"=> data parallel: {size} rank(s) over {backend}, this is rank "
          f"{rank} on {device}", flush=True)
    return _WORLD


def maybe_initialize(device: torch.device, backend: str = "nccl",
                     num_devices: int = 0) -> Optional[World]:
    """The World of a launched process (see launched), or None for one
    plain process. `num_devices`, when set, must equal the world size (1
    without a launcher)."""
    if _WORLD is not None:
        size = _WORLD.size
    else:
        size = int(os.environ["WORLD_SIZE"]) if launched() else 1
    if num_devices and num_devices != size:
        raise ValueError(f"--num_devices {num_devices} but the launcher "
                         f"started {size} process(es): one process drives "
                         "one card; set torchrun --nproc_per_node instead")
    if _WORLD is not None:
        return _WORLD
    if not launched():
        pick_backend(device, backend)
        return None
    return initialize(device, backend, int(os.environ["RANK"]), size)


def size_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[b, ...] on every rank -> [size * b, ...], rank 0's rows first."""
    n = size_of(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[b, ...] on every rank, b % size == 0: rows [j * b / size, (j + 1) *
    b / size) go to rank j, and the result holds the shards received,
    rank 0's first (the JAX package's untiled all_to_all over the data
    axis)."""
    if size_of(group) == 1:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    if size_of(group) == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    n = size_of(group)
    return x if n == 1 else all_sum(x, group) / n


def all_mean_dict(metrics, group):
    """{name: 0-d tensor} averaged over the ranks in one all-reduce."""
    if size_of(group) == 1:
        return metrics
    names = list(metrics)
    mean = all_mean(torch.stack([metrics[k].to(torch.float32) for k in names]),
                    group)
    return {k: mean[i] for i, k in enumerate(names)}


def from_primary(model: torch.nn.Module, optimizer, values: List[Any],
                 world: Optional[World]) -> List[Any]:
    """Rank 0's model (every parameter and buffer), optimizer state
    (moments, step counts, groups) and picklable `values` on every rank,
    returned as `values`: what follows an init that rank 0 alone read from
    files (the JAX package's broadcast_from_primary). The tensors go in one
    broadcast per dtype over world.group; the optimizer state and values
    once through the host group."""
    if world is None or world.size == 1:
        return values
    tensors = list(model.parameters()) + list(model.buffers())
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for same in by_kind.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src=0, group=world.group)
        offset = 0
        with torch.no_grad():
            for t in same:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    state = optimizer.state_dict()
    box = [{"state": {k: {n: (v.cpu() if torch.is_tensor(v) else v)
                          for n, v in s.items()}
                      for k, s in state["state"].items()},
            "param_groups": state["param_groups"]}, values]
    dist.broadcast_object_list(box, src=0, group=world.host_group)
    optimizer.load_state_dict(box[0])
    return box[1]


def agree_flag(flag: bool, world: Optional[World]) -> bool:
    """True on every rank when `flag` is True on any (host group; one
    4-byte all-reduce on the host, so it never waits for the card)."""
    if world is None or world.size == 1:
        return flag
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=world.host_group)
    return bool(t.item())


def wrap(module: torch.nn.Module, world: World):
    """`module` in DistributedDataParallel over world.group: its gradients
    are averaged over the ranks in the backward. Only parameters that take
    gradients take part (a frozen backbone does not)."""
    import inspect

    from torch.nn.parallel import DistributedDataParallel

    ids = [world.device.index] if world.device.type == "cuda" else None
    # no buffer sync before each forward (the option's newer name where the
    # installed torch has it)
    sync = ("forward_sync_buffers" if "forward_sync_buffers" in
            inspect.signature(DistributedDataParallel).parameters
            else "broadcast_buffers")
    return DistributedDataParallel(module, device_ids=ids,
                                   process_group=world.group, **{sync: False})


def setup_print(primary: bool) -> None:
    """The reference's setup_for_distributed: print only on rank 0;
    `print(..., force=True)` prints on every rank."""
    original = builtins.print

    def print_rank0(*args, **kwargs):
        if kwargs.pop("force", False) or primary:
            original(*args, **kwargs)

    builtins.print = print_rank0
