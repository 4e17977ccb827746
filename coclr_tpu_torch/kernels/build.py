"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc into
`build/kernels/lib<name>-<key>.so` at the repository root (a plain C
interface, no PyTorch headers, so a build takes seconds) and loaded with
ctypes. The key hashes the source, the local headers it includes and the
nvcc flags, so a change to any of them builds a new library. Nothing is
built or loaded at import time: the first launch builds its library, and
`build_all` builds every library at once with one nvcc process per source,
all started together.

With COCLR_KERNEL_COUNTS=<file> in its environment, a process appends its
launch counts to that file as one JSON line when it exits (`write_counts`):
how a parent reads the launches of the entry points it runs as
subprocesses.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
from typing import Dict, List, Sequence

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_REPO, "coclr_tpu_torch", "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_headers(source: str) -> List[str]:
    """The files that `source` includes with #include "...", found beside
    the including file, and theirs in turn (sorted paths)."""
    found, todo = set(), [source]
    while todo:
        path = todo.pop()
        with open(path) as f:
            text = f.read()
        for name in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(path), name)
            if os.path.exists(dep) and dep not in found:
                found.add(dep)
                todo.append(dep)
    return sorted(found)


def build_key(source: str, flags: Sequence[str]) -> str:
    """Hash of the source, its local headers and the nvcc flags."""
    h = hashlib.sha256("\0".join(flags).encode())
    for path in [source] + local_headers(source):
        with open(path, "rb") as f:
            h.update(b"\0" + os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class CudaKernel:
    """One kernel library: its build, its C entry point and its launch count.

    `launches` counts successful launches made through `launch` and nothing
    else; callers reset it to 0 to count the launches of one run.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    @property
    def source(self) -> str:
        return os.path.join(CSRC, self.name + ".cu")

    @property
    def library(self) -> str:
        return os.path.join(BUILD_DIR, "lib%s-%s.so"
                            % (self.name, build_key(self.source, NVCC_FLAGS)))

    def start_build(self):
        """Start nvcc for this library unless it is built; returns
        (process, temporary output, library) or None."""
        library = self.library
        if os.path.exists(library):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (library, os.getpid())
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, library

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, library = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (self.source, log))
        os.replace(tmp, library)

    def _load(self):
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.library)
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.coclr_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the stream it is given)
        and raise if the launch was refused."""
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError("CUDA kernel %s failed to launch: %s (%d)"
                               % (self.name, self._err(rc).decode(), rc))
        self.launches += 1


KERNELS: Dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all() -> None:
    """Build every registered kernel library, all nvcc processes at once."""
    # importing the wrappers registers their kernels
    from coclr_tpu_torch.kernels import jitter, pool  # noqa: F401

    started = [(k, k.start_build()) for k in KERNELS.values()]
    errors = []
    for kernel, proc in started:
        try:
            kernel.finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for kernel in KERNELS.values():
        kernel._load()


def reset_counts() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def write_counts(path: str) -> None:
    """Append {"argv", "counts"} of this process to `path`."""
    line = json.dumps({"argv": sys.argv, "counts": {
        name: k.launches for name, k in KERNELS.items()}})
    with open(path, "a") as f:
        f.write(line + "\n")


COUNTS_ENV = "COCLR_KERNEL_COUNTS"
if os.environ.get(COUNTS_ENV):
    atexit.register(write_counts, os.environ[COUNTS_ENV])
