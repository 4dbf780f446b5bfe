"""Build, load and launch the port's hand-written CUDA kernels.

The ``csrc/*.cu`` sources compile with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and link into ONE
shared library with a plain C interface under ``build/kernels/`` at the
repository root.  The library's file name carries a hash of the sources
and flags, so an edited source rebuilds at its next first use and a
stale library is never loaded.  It is loaded with ``ctypes``: pointers
and the stream go in as ``c_void_p``, int64 scalars as ``c_longlong``,
floats as ``c_double``,
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
(``check_addr_bounds``), the host-address to device-index conversion and
its pinned staging blocks (``to_device``, ``StagingPool``), the 0-d bool
verdicts the kernels write in place (``fresh_ok``), the per-kernel
launch counter, and the hook through which a wrapper reports its
kernel's work to ``launch.roofline.count()`` (``counted``).
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
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
           "version_select.cu", "commit_fused.cu", "snapshot_select.cu",
           "flash_attention.cu", "fused_adamw.cu", "ssd_scan.cu",
           "staging.cu")
#: headers the sources include (hashed with them, not compiled alone)
HEADERS = ("copy_bytes.cuh", "mma_bf16.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_I64 = np.dtype(np.int64)
_P = ctypes.c_void_p
_I = ctypes.c_longlong
_D = ctypes.c_double
#: argument types of each C entry point (the stream is always last)
SIGNATURES = {
    "gather_read_i64": (_P, _I, _P, _I, _P, _P),
    "gather_read_i32": (_P, _I, _P, _I, _P, _P),
    "scatter_write_i64": (_P, _I, _P, _P, _I, _P),
    "validate_readset_i64": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "validate_words_i64": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                           _P),
    "version_select_i64": (_P, _P, _I, _I, _I, _P, _P, _P),
    "mirror_select_i64": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I,
                          _P, _P),
    "scatter_pairs_i64": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    "gather_bracketed_i64": (_P, _I, _P, _I, _P, _P, _I, _P, _P),
    "commit_fused_i64": (_P, _P),
    "commit_rows_i64": (_P, _P),
    "stage_copy": (_P, _P, _I, _P, _P),
    "snapshot_select_rows": (_P, _I, _I, _P, _I, _P, _P, _P),
    "flash_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _D,
                            _I, _P),
}
SIGNATURES["flash_attention_bf16"] = SIGNATURES["flash_attention_f32"]
for _name in ("fused_adamw_f32_f32", "fused_adamw_f32_bf16",
              "fused_adamw_bf16_f32", "fused_adamw_bf16_bf16"):
    SIGNATURES[_name] = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _D, _D, _D, _D,
                         _P)
SIGNATURES["commit_fused_i32"] = SIGNATURES["commit_fused_i64"]
SIGNATURES["commit_rows_i32"] = SIGNATURES["commit_rows_i64"]
SIGNATURES["ssd_scan_f32"] = (_P,) * 11 + (_I,) * 7 + (_P,)
SIGNATURES["ssd_scan_bf16"] = SIGNATURES["ssd_scan_f32"]

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


#: the ``launch.roofline.count()`` dispatch modes open in this process;
#: while there is none, a counted wrapper costs one test of this list
COUNTERS: list = []


def _active_counter():
    """The innermost open ``count()`` on this thread's dispatch mode stack
    (the autograd threads inherit the caller's), or None."""
    from torch.utils._python_dispatch import \
        _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if any(mode is c for c in COUNTERS):
            return mode
    return None


def counted(name: str, work):
    """Decorator of a kernel wrapper: while a ``launch.roofline.count()``
    is open, the call runs with the counter's dispatch counting
    suspended and ``work(*args, **kwargs)`` — the kernel's ``(flops,
    bytes)`` — is added to it under ``name`` instead, on both routes,
    so the plain version on the CPU and the kernel on the card count the
    same.  The flops are what ``FlopCounterMode`` counts over the plain
    version; the bytes are what the kernel's bound counts (each input
    read once, each output written once).  A counted wrapper called
    inside another adds nothing of its own.  The route is untouched."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not COUNTERS:
                return fn(*args, **kwargs)
            sink = _active_counter()
            if sink is None or sink.suspended:
                return fn(*args, **kwargs)
            with sink.suspend():
                out = fn(*args, **kwargs)
                flops, nbytes = work(*args, **kwargs)
            sink.add_kernel(name, flops, nbytes)
            return out
        return call
    return wrap


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
    for s in SOURCES + HEADERS:
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build_log(source: str) -> Path:
    """The compiler's output for ``source`` (``ptxas -v``: registers,
    shared memory and spills of each kernel) from the library's build."""
    return BUILD_DIR / f"{library_path().stem}.{source[:-3]}.log"


def build() -> Path:
    """Compile the sources (in parallel) and link the library, unless the
    library for exactly these sources already exists.  A file lock keeps
    concurrent processes from building over each other.  Each source's
    compiler output is kept beside the library (``build_log``)."""
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
                (BUILD_DIR / f"{out.stem}.{s[:-3]}.log").write_text(log)
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
            lib.staging_event_create.argtypes = [ctypes.POINTER(_P)]
            lib.staging_event_query.argtypes = [_P]
            for fn in (lib.staging_event_create, lib.staging_event_query):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


#: the raw handle of each device's default stream, by device index
_DEFAULT_STREAMS: dict = {}


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s default stream; raise
    if the launch reported an error.  The one-stream check compares raw
    stream handles, and the device is made current only when it is not
    already: no stream objects or device context at every call
    (``PERF.md`` splits a call's host time)."""
    index = device.index
    current = torch._C._cuda_getDevice()
    if index is not None and index != current:
        with torch.cuda.device(index):
            return launch(name, device, *args)
    lib = _lib if _lib is not None else library()
    stream = torch._C._cuda_getCurrentRawStream(current)
    default = _DEFAULT_STREAMS.get(current)
    if default is None:
        default = _DEFAULT_STREAMS[current] = \
            torch.cuda.default_stream(current).cuda_stream
    if stream != default:
        raise RuntimeError(
            f"{name}: the STM's device state must be driven from the "
            "default stream (one-stream rule), not a side stream")
    _raise_if(getattr(lib, name)(*args, stream), name)


_CUDA_NOT_READY = 600        # cudaErrorNotReady
#: bytes at the head of a staging block for a call's arguments
#: (commit_fused's ``CommitCall``); the staged columns follow
STAGING_HEAD = 256


class PinnedStaging:
    """One pinned host block for a host->device copy, and the event
    recorded right behind its copy on the stream.

    ``take(nbytes)`` grows the block when it is too small and returns
    ``(head, u8, i64)``: int64 words for a call's arguments, and the
    column region after them as uint8 and int64 views (its address is
    ``ptr + STAGING_HEAD``).  A block is written only while no copy out
    of it is pending (``StagingPool`` checks), so growing drops nothing
    in flight.

    ``scratch(nbytes)`` is the block's device scratch, for a C call that
    copies the block there, runs its kernel over the copy and records
    the block's event behind the kernel (``scatter_pairs_i64``): the
    scratch is free whenever the block is, so it is allocated only when
    it grows."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host: Optional[torch.Tensor] = None
        self.head = self.u8 = self.i64 = None
        self.dev: Optional[torch.Tensor] = None
        self.ptr = 0
        self.busy = False
        ev = _P()
        with torch.cuda.device(device):
            _raise_if(library().staging_event_create(ctypes.byref(ev)),
                      "staging_event_create")
        self.event: int = ev.value

    def done(self) -> bool:
        """Whether every copy recorded on the block's event has run."""
        err = _lib.staging_event_query(self.event)
        if err == _CUDA_NOT_READY:
            return False
        _raise_if(err, "staging_event_query")
        return True

    def take(self, nbytes: int):
        if self.host is None or self.u8.size < nbytes:
            old = 0 if self.u8 is None else self.u8.size
            size = max(-(-nbytes // 8) * 8, 2 * old, 1 << 16)
            self.host = torch.empty(STAGING_HEAD + size, dtype=torch.uint8,
                                    pin_memory=True)
            whole = self.host.numpy()
            self.head = whole[:STAGING_HEAD].view(np.int64)
            self.u8 = whole[STAGING_HEAD:]
            self.i64 = self.u8.view(np.int64)
            self.ptr = self.host.data_ptr()
        return self.head, self.u8, self.i64

    def scratch(self, nbytes: int) -> int:
        """The device address of at least ``nbytes`` of the block's
        device scratch."""
        if self.dev is None or self.dev.numel() < nbytes:
            old = 0 if self.dev is None else self.dev.numel()
            self.dev = torch.empty(max(-(-nbytes // 16) * 16, 2 * old,
                                       1 << 16),
                                   dtype=torch.uint8, device=self.device)
        return self.dev.data_ptr()


class StagingPool:
    """The pinned staging blocks of one device.  ``acquire`` hands out a
    block that no other call holds and whose last copy has run (the
    next such block in turn, or a new one when every block is held or
    still copying), so a call never waits for the card; ``release``
    returns it once the call has enqueued its copy.  In steady state the
    first block tried is free: the pool grows only as deep as the
    stream's backlog of staged copies.  (``pin_memory()``, which this
    replaces on the hot paths, takes a block from torch's pinned cache
    at every call and allocates one on a miss.)"""

    def __init__(self, device: torch.device):
        self.device = device
        self.blocks: list = []
        self.next = 0
        self.lock = threading.Lock()

    def acquire(self) -> PinnedStaging:
        with self.lock:
            n = len(self.blocks)
            for k in range(n):
                st = self.blocks[(self.next + k) % n]
                if not st.busy and st.done():
                    st.busy = True
                    self.next = (self.next + k + 1) % n
                    return st
            st = PinnedStaging(self.device)
            st.busy = True
            self.blocks.append(st)
            return st

    @staticmethod
    def release(st: PinnedStaging) -> None:
        st.busy = False


_POOLS: dict = {}
_pools_lock = threading.Lock()


def staging(device: torch.device) -> StagingPool:
    """The staging pool of CUDA ``device`` (made at first use)."""
    pool = _POOLS.get(device.index)
    if pool is None:
        with _pools_lock:
            pool = _POOLS.get(device.index)
            if pool is None:
                pool = _POOLS[device.index] = StagingPool(device)
    return pool


OK_BLOCK = 1024      # 0-d ``ok`` results cut from one allocation
_ok_views: dict = {}  # device -> iterator over a block's unused elements
_ok_lock = threading.Lock()


def fresh_ok(device: torch.device) -> torch.Tensor:
    """A 0-d bool tensor on ``device`` that no other call is handed: the
    next element of a block of ``OK_BLOCK`` allocated, and cut into 0-d
    views, at once, so a call takes a view made in bulk where it took an
    allocation.  No element is handed out twice; a block's memory goes
    when its last element does."""
    it = _ok_views.get(device)
    ok = next(it, None) if it is not None else None
    if ok is None:
        with _ok_lock:
            it = _ok_views.get(device)
            ok = next(it, None) if it is not None else None
            if ok is None:
                block = torch.empty(OK_BLOCK, dtype=torch.bool,
                                    device=device)
                it = _ok_views[device] = iter(block.unbind(0))
                ok = next(it)
    return ok


def _raise_if(err: int, name: str) -> None:
    if err:
        msg = library().cuda_error_string(err).decode(errors="replace")
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
    a = idx if idx.dtype == np.int64 else idx.astype(np.int64)
    # one pass: as uint64 a negative address is past any frontier too
    if int(a.view(np.uint64).max()) >= n:
        lo, hi = int(a.min()), int(a.max())
        raise IndexError(lo if lo < 0 else hi)


def host_index(idx) -> np.ndarray:
    """Addresses as a host int64[N] array (lists, ranges, numpy, CPU
    tensors).  Addresses live on the host; a CUDA tensor is refused."""
    if type(idx) is np.ndarray and idx.dtype is _I64 and idx.ndim == 1:
        return idx
    if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
        raise TypeError("addresses are host arrays; got a "
                        f"{idx.device} tensor")
    return np.asarray(idx, np.int64).reshape(-1)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host int64 array as a tensor of its shape on ``device``.

    To a card the copy goes through a pinned staging block
    (``StagingPool``) and does not wait: the block is not written again
    until its copy has run, ``a`` itself is free as soon as this
    returns, and the copy is ordered before every later launch on the
    one stream.  (A blocking copy from pageable memory would wait for
    the whole stream — a stall in which the STM's other threads take
    the interpreter lock.)  On the CPU the tensor shares ``a``'s
    memory."""
    a = np.ascontiguousarray(a, np.int64)
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(a if a.flags.writeable else a.copy())
    if device.type != "cuda":
        raise RuntimeError(f"unsupported device {device}")
    out = torch.empty(a.shape, dtype=torch.int64, device=device)
    if a.size:
        pool = staging(device)
        st = pool.acquire()
        try:
            _, _, i64 = st.take(8 * a.size)
            i64[:a.size] = a.reshape(-1)
            launch("stage_copy", device, out.data_ptr(),
                   st.ptr + STAGING_HEAD, 8 * a.size, st.event)
        finally:
            pool.release(st)
    return out


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


def check_row(row: torch.Tensor, dtypes=(torch.int64,)) -> None:
    """The rows the gather/scatter kernels take: 1-D contiguous, of one
    of ``dtypes`` (int64 unless the kernel has more instantiations)."""
    if row.dtype not in dtypes or row.dim() != 1 \
            or not row.is_contiguous():
        raise ValueError("expected a contiguous 1-D row of "
                         f"{[str(d) for d in dtypes]}, got "
                         f"{row.dtype} {tuple(row.shape)}")
