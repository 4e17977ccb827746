import ctypes as _ctypes


def pin_malloc_mmap_threshold(threshold: int = 1 << 20) -> bool:
    """Pin glibc's M_MMAP_THRESHOLD (disables its dynamic adaptation).

    When a >=128 KB mmap'd block is freed, glibc raises the mmap threshold to
    that size (up to 32 MB), so later batch-sized allocations come from
    thread arenas, interleaved with long-lived small ones; the freed space
    fragments and is never returned to the OS. A video train loop frees
    multi-MB decode and collate buffers every step, so host RSS then grows by
    about one uint8 batch per step with no plateau (a long drive of the JAX
    package reached 129 GB after 1,293 steps). Pinning the threshold at 1 MiB
    keeps small-object churn in the arenas and sends every batch-scale block
    back to mmap/munmap. Called at every training entry point; a no-op
    returning False off glibc. Copied from coclr_tpu/utils/__init__.py."""
    try:
        libc = _ctypes.CDLL(None, use_errno=True)
    except OSError:
        return False
    if not hasattr(libc, "mallopt"):
        return False
    return bool(libc.mallopt(-3, int(threshold)))  # M_MMAP_THRESHOLD


def malloc_trim() -> bool:
    """Release free heap memory back to the OS (glibc malloc_trim(0)); the
    epoch-boundary companion of pin_malloc_mmap_threshold."""
    try:
        libc = _ctypes.CDLL(None, use_errno=True)
    except OSError:
        return False
    if not hasattr(libc, "malloc_trim"):
        return False
    return bool(libc.malloc_trim(0))


def resolve_device(device):
    """torch.device for an entry point: raises when CUDA is asked for and is
    not there (the port never carries on on the CPU unless asked to). In a
    process a distributed launcher started (RANK and WORLD_SIZE set),
    'cuda' is cuda:LOCAL_RANK, made the current device."""
    import torch

    from coclr_tpu_torch.parallel import dist

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    if dev.type == "cuda" and dev.index is None and dist.launched():
        dev = torch.device("cuda", dist.local_rank())
        torch.cuda.set_device(dev)
    return dev


def prepare_run(device):
    """What every entry point of the port does first: the torch.device
    (resolve_device), the malloc pin, and float32 matmuls and convolutions
    kept in float32 (no TF32; the bfloat16 convolutions are unaffected)."""
    import torch

    dev = resolve_device(device)
    pin_malloc_mmap_threshold()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
