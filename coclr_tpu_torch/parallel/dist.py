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

Sequence parallelism (`--sp_size`, `--sph_size`; ops/seqpar.py): the ranks
form a (data, sp, sph) grid, sph innermost, as the JAX package's mesh
(coclr_tpu/parallel/mesh.py): world rank (d * sp + t) * sph + h. The World
then carries a group per role, built in the same order on every rank
(`with_seqpar`):

- the sp group (d, *, h): the temporal halos;
- the sph group (d, t, *): the spatial halos and gather_h;
- the sequence group (d, *, *): sp_pmean over both axes;
- the data group (*, t, h): the key shuffle and the gathered enqueue, over
  the members that hold the same T and H chunk of different clips;
- `group`, the world: the gradient all-reduce and the metrics.

With sp = sph = 1 no group is made and the data group is the world.
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
    # sequence parallelism (with_seqpar); a group of one rank is None
    sp: int = 1
    sph: int = 1
    data_group: Any = None
    sp_group: Any = None
    sph_group: Any = None
    seq_group: Any = None

    @property
    def primary(self) -> bool:
        return self.rank == 0

    @property
    def data_rank(self) -> int:
        """d: which data shard this rank's clips belong to."""
        return self.rank // (self.sp * self.sph)

    @property
    def n_data(self) -> int:
        return self.size // (self.sp * self.sph)

    @property
    def sp_rank(self) -> int:
        """t: which T chunk of its clips this rank holds."""
        return self.rank // self.sph % self.sp

    @property
    def sph_rank(self) -> int:
        """h: which H chunk of its clips this rank holds."""
        return self.rank % self.sph

    @property
    def seqpar(self):
        """The backbones' ops/seqpar.py spec, or None without sequence
        parallelism."""
        from coclr_tpu_torch.ops.seqpar import SPAxes

        if self.sp_group is None and self.sph_group is None:
            return None
        return SPAxes(t=self.sp_group, h=self.sph_group, both=self.seq_group)


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
                   group=dist.group.WORLD, host_group=host,
                   data_group=dist.group.WORLD)
    setup_print(rank == 0)
    print(f"=> data parallel: {size} rank(s) over {backend}, this is rank "
          f"{rank} on {device}", flush=True)
    return _WORLD


def maybe_initialize(device: torch.device, backend: str = "nccl",
                     num_devices: int = 0, sp_size: int = 1,
                     sph_size: int = 1) -> Optional[World]:
    """The World of a launched process (see launched), or None for one
    plain process. `num_devices`, when set, must equal the world size (1
    without a launcher); sp_size x sph_size must divide it, and the World
    then carries the sequence-parallel groups (with_seqpar)."""
    if _WORLD is not None:
        size = _WORLD.size
    else:
        size = int(os.environ["WORLD_SIZE"]) if launched() else 1
    if num_devices and num_devices != size:
        raise ValueError(f"--num_devices {num_devices} but the launcher "
                         f"started {size} process(es): one process drives "
                         "one card; set torchrun --nproc_per_node instead")
    sp_size, sph_size = sp_size or 1, sph_size or 1
    if sp_size < 1 or sph_size < 1 or size % (sp_size * sph_size):
        raise ValueError(f"--sp_size {sp_size} x --sph_size {sph_size} does "
                         f"not divide the {size} process(es) of the launch")
    if _WORLD is None and not launched():
        pick_backend(device, backend)
        return None
    world = _WORLD if _WORLD is not None else initialize(
        device, backend, int(os.environ["RANK"]), size)
    return with_seqpar(world, sp_size, sph_size)


_SEQPAR = {}


def with_seqpar(world: World, sp: int, sph: int) -> World:
    """`world` with the groups of a (data, sp, sph) grid (module
    docstring); `world` itself for sp = sph = 1. Every rank must make the
    same calls in the same order (each new group is a collective over the
    world); the groups of a grid are made once and kept."""
    if sp * sph == 1:
        return world
    if world.size % (sp * sph):
        raise ValueError(f"sp {sp} x sph {sph} does not divide the world "
                         f"of {world.size}")
    key = (world.rank, world.size, sp, sph)
    if key not in _SEQPAR:
        n_data = world.size // (sp * sph)
        at = lambda d, t, h: (d * sp + t) * sph + h
        layouts = {
            "sp_group": [[at(d, t, h) for t in range(sp)]
                         for d in range(n_data) for h in range(sph)],
            "sph_group": [[at(d, t, h) for h in range(sph)]
                          for d in range(n_data) for t in range(sp)],
            "seq_group": [[at(d, t, h) for t in range(sp) for h in range(sph)]
                          for d in range(n_data)],
            "data_group": [[at(d, t, h) for d in range(n_data)]
                           for t in range(sp) for h in range(sph)],
        }
        if sp == 1 or sph == 1:  # sp_pmean reduces over the one axis
            del layouts["seq_group"]
        backend = dist.get_backend(world.group)
        groups = dict(sp_group=None, sph_group=None, seq_group=None)
        for role, lists in layouts.items():
            # an axis of one rank needs no group (the identity); the data
            # group keeps its group of one, so that the step never takes
            # the world for it
            if len(lists[0]) == 1 and role != "data_group":
                continue
            for ranks in lists:
                g = dist.new_group(ranks, backend=backend)
                if world.rank in ranks:
                    groups[role] = g
        _SEQPAR[key] = dataclasses.replace(world, sp=sp, sph=sph, **groups)
    return _SEQPAR[key]


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
