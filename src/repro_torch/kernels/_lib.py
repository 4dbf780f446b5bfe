"""Build, load and launch the port's hand-written CUDA kernels.

The ``csrc/*.cu`` sources compile with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and link into ONE
shared library with a plain C interface under ``build/kernels/`` at the
repository root.  The library's file name carries a hash of the sources
and flags, so an edited source rebuilds at its next first use and a
stale library is never loaded.  It is loaded with ``ctypes``: pointers
and the stream go in as ``c_void_p``, int64 scalars as ``c_longlong``,
and every C entry point returns ``cudaGetLastError()`` — non-zero raises.
The library is loaded as a ``PyDLL``, so a launch keeps the interpreter
lock: an enqueue takes microseconds, and releasing the lock around it
made every launch a lock hand-off between the STM's threads.

Nothing here runs at import time: ``nvcc``, the toolkit and the card are
reached only from ``library()``, which the wrappers call when they are
handed a CUDA tensor.

The one-stream rule.  The STM's soundness arguments (the pre/heap/post
gathers of a bulk read, the seqlock bracket of the version mirror, the
lock gate before mirror rows) rely on device operations running in the
order the host threads issued them.  That holds only while every thread
enqueues on the same stream, so ``launch`` refuses to run on any stream
but the device's default one.

Also here: the bounds contract shared by every gather/scatter
(``check_addr_bounds``), the host-address to device-index conversion, and
the per-kernel launch counter.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gather_read.cu", "scatter_write.cu", "validate.cu",
           "version_select.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_longlong
#: argument types of each C entry point (the stream is always last)
SIGNATURES = {
    "gather_read_i64": (_P, _I, _P, _I, _P, _P),
    "scatter_write_i64": (_P, _I, _P, _P, _I, _P),
    "validate_readset_i64": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "version_select_i64": (_P, _P, _I, _I, _I, _P, _P, _P),
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


class LaunchCounter:
    """Kernel launches since the last ``reset`` — one per wrapper call
    that enqueued the kernel, never for the plain version."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources (in parallel) and link the library, unless the
    library for exactly these sources already exists.  A file lock keeps
    concurrent processes from building over each other."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if out.exists():
            return out
        nvcc = _nvcc()
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            objs = [tmp / (s[:-3] + ".o") for s in SOURCES]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for s, o in zip(SOURCES, objs)]
            errs = []
            for s, p in zip(SOURCES, procs):
                log = p.communicate()[0].decode(errors="replace")
                if p.returncode:
                    errs.append(f"{s}:\n{log}")
            if errs:
                raise RuntimeError("nvcc failed:\n" + "\n".join(errs))
            so = tmp / out.name
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
                 str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            if res.returncode:
                raise RuntimeError("nvcc link failed:\n"
                                   + res.stdout.decode(errors="replace"))
            os.replace(so, out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.PyDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s default stream; raise
    if the launch reported an error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if stream != torch.cuda.default_stream(device):
            raise RuntimeError(
                f"{name}: the STM's device state must be driven from the "
                "default stream (one-stream rule), not a side stream")
        err = getattr(lib, name)(*args, stream.cuda_stream)
    if err:
        msg = lib.cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def device_kind(t: torch.Tensor) -> str:
    """``"cuda"`` (launch the kernel) or ``"cpu"`` (plain version); any
    other device raises."""
    kind = t.device.type
    if kind not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {t.device}")
    return kind


def check_addr_bounds(idx: np.ndarray, n: int) -> None:
    """Raise unless every address lands in ``[0, n)`` — the bounds
    contract every bulk gather/scatter shares, failing loudly at BOTH
    ends: past the frontier (matching the scalar accessors) AND
    negative, which would wrap under numpy/torch indexing and silently
    hit a word near the end of the buffer."""
    if not idx.size:
        return
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or hi >= n:
        raise IndexError(lo if lo < 0 else hi)


def host_index(idx) -> np.ndarray:
    """Addresses as a host int64[N] array (lists, ranges, numpy, CPU
    tensors).  Addresses live on the host; a CUDA tensor is refused."""
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        raise TypeError("addresses are host arrays; got a "
                        f"{idx.device} tensor")
    a = np.asarray(idx, np.int64).reshape(-1)
    return a


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host int64 array as a tensor on ``device``.

    To a card the copy goes through pinned memory and does not wait:
    torch's pinned-memory cache keeps the staging buffer until the copy
    has run, ``a`` itself is free as soon as this returns, and the copy
    is ordered before every later launch on the one stream.  (A blocking
    copy from pageable memory would wait for the whole stream — a stall
    in which the STM's other threads take the interpreter lock.)  On the
    CPU the tensor shares ``a``'s memory."""
    a = np.ascontiguousarray(a, np.int64)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(tensors) -> list:
    """Copy several integer device tensors back in ONE transfer (one
    wait for the stream); returns int64 numpy arrays of the same
    shapes."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def check_row(row: torch.Tensor) -> None:
    """The rows the gather/scatter kernels take: 1-D contiguous int64."""
    if row.dtype != torch.int64 or row.dim() != 1 \
            or not row.is_contiguous():
        raise ValueError("expected a contiguous 1-D int64 row, got "
                         f"{row.dtype} {tuple(row.shape)}")
