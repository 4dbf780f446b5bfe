"""Device-resident heap + lock table: the engine's vectorizable substrate.

Two heap flavors behind one three-method interface (``alloc`` /
``__getitem__`` / ``__setitem__``):

  * ``ObjectHeap`` — a Python list on the host; holds arbitrary objects,
    the default for every backend;
  * ``ArrayHeap``  — words in one contiguous int64 tensor ON THE DEVICE
    with capacity doubling.  ``gather`` / ``scatter`` launch the
    ``gather_read`` / ``scatter_write`` kernels; numeric words only.

``ArrayLockTable`` packs each versioned lock word ``(locked, version,
tid, flag)`` into ONE int64 element of a device tensor::

    bits 18..63  version        (commit clock)
    bits  2..17  tid + 2        (supports the -2 background/-1 none tids)
    bit   1      locked
    bit   0      flag           (versioning-in-progress)

A single packed word makes the bulk path sound: ``gather(idxs)`` reads
the row ONCE, so each gathered element is a consistent (locked, version,
tid, flag) tuple — gathering parallel arrays field by field could tear a
word between fields, which the scalar path never does.

Where state lives.  The words (heap and locks) live on the device; the
addresses, lock indices (the uint64 Fibonacci hash in ``index_bulk``),
the bounds checks and the striped host locks that emulate CAS stay on
the host, and addresses are copied to the device only as kernel
arguments.  Every device operation is issued on the one default stream
(``kernels/_lib.py``), so the device applies them in the order the host
threads issued them: a write enqueued while a stripe is held is ordered
before any read enqueued after the stripe is released, which is the
linearization the host-memory reference got from the interpreter lock.
Scalar reads (``read``, ``__getitem__``) copy one word back and wait for
it; scalar writes enqueue one element write before the stripe (or the
heap lock) is released.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.clock import Striped
from repro_torch.core.locks import _GOLDEN, LockState, LockTable
from repro_torch.kernels import gather_read as GR
from repro_torch.kernels import scatter_write as SW
from repro_torch.kernels._lib import check_addr_bounds, host_index

__all__ = ["ArrayHeap", "ArrayLockTable", "ObjectHeap", "check_addr_bounds",
           "pack_lock", "resolve_device", "unpack_lock"]

_TID_BIAS = 2                    # stored tid = tid + 2 (tid >= -2)
_TID_BITS = 16
_TID_MASK = (1 << _TID_BITS) - 1
_VER_SHIFT = 2 + _TID_BITS


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    There is no silent CPU fallback: asking for CUDA (explicitly or by
    default) without a usable card raises; the CPU runs only when the
    caller names it, as the tests do.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def pack_lock(st: LockState) -> int:
    return ((st.version << _VER_SHIFT)
            | ((st.tid + _TID_BIAS) & _TID_MASK) << 2
            | (1 << 1 if st.locked else 0)
            | (1 if st.flag else 0))


def unpack_lock(word: int) -> LockState:
    return LockState(bool(word & 2), word >> _VER_SHIFT,
                     ((word >> 2) & _TID_MASK) - _TID_BIAS, bool(word & 1))


_UNLOCKED_WORD = pack_lock(LockState(False, 0, -1, False))


def _split(w):
    """Packed words -> (version, owner tid, meta) — works on numpy
    arrays and torch tensors alike; meta bit0 = locked, bit1 = flag."""
    return (w >> _VER_SHIFT, ((w >> 2) & _TID_MASK) - _TID_BIAS,
            ((w >> 1) & 1) | ((w & 1) << 1))


class ObjectHeap:
    """Plain Python-list heap: any value, no vectorization."""

    def __init__(self):
        self._cells: List[Any] = []
        self._lock = threading.Lock()

    def alloc(self, n: int, init: Any = None) -> int:
        with self._lock:
            base = len(self._cells)
            self._cells.extend([init] * n)
            return base

    def __getitem__(self, addr: int) -> Any:
        return self._cells[addr]

    def __setitem__(self, addr: int, value: Any) -> None:
        self._cells[addr] = value

    def __len__(self) -> int:
        return len(self._cells)

    def gather(self, addrs) -> List[Any]:
        """Batched read: one pass over arbitrary objects."""
        cells = self._cells
        return [cells[int(a)] for a in addrs]

    def scatter(self, addrs, values) -> None:
        """Batched write-back: one pass over arbitrary objects (the list
        analogue of ``ArrayHeap.scatter``)."""
        cells = self._cells
        if isinstance(values, torch.Tensor):
            values = values.tolist()
        for a, v in zip(addrs, values):
            cells[int(a)] = v


class ArrayHeap:
    """Numeric word heap in one int64 device tensor (doubling growth).

    ``len()`` is the allocated frontier, not the capacity; accesses
    beyond it raise like the list heap does.
    """

    def __init__(self, capacity: int = 1024, device=None):
        self.device = resolve_device(device)
        self._buf = torch.zeros(max(capacity, 1), dtype=torch.int64,
                                device=self.device)
        self._len = 0
        self._live = self._buf[:0]       # the allocated words, a view
        self._lock = threading.Lock()

    def alloc(self, n: int, init: Any = None) -> int:
        fill = 0 if init is None else int(init)
        with self._lock:
            base = self._len
            need = base + n
            if need > self._buf.shape[0]:
                cap = self._buf.shape[0]
                while cap < need:
                    cap *= 2
                grown = torch.zeros(cap, dtype=torch.int64,
                                    device=self.device)
                grown[:base] = self._buf[:base]
                self._buf = grown
            self._buf[base:need] = fill
            self._install(self._buf, need)
            return base

    def _install(self, buf: torch.Tensor, n: int) -> None:
        """Make ``buf`` the buffer with ``n`` words allocated (the caller
        holds the heap lock)."""
        self._buf, self._len, self._live = buf, n, buf[:n]

    def __getitem__(self, addr: int) -> int:
        # both ends: a negative address would wrap to the end of the
        # buffer, same contract as the bulk paths
        if addr < 0 or addr >= self._len:
            raise IndexError(addr)
        return int(self._buf[addr])

    def __setitem__(self, addr: int, value: Any) -> None:
        if addr < 0 or addr >= self._len:
            raise IndexError(addr)
        # under the lock: a concurrent alloc() may be copying into a grown
        # buffer, and a write that raced the copy would land in the
        # discarded old buffer and silently vanish
        v = int(value)
        with self._lock:
            self._buf[addr] = v

    def __len__(self) -> int:
        return self._len

    def live(self) -> torch.Tensor:
        """The allocated words (a view of the device buffer)."""
        return self._live

    def gather(self, addrs) -> torch.Tensor:
        """Batched read: one ``gather_read`` launch over the live words,
        returning a new int64 device tensor.  Enqueued under the heap
        lock, so a concurrent ``alloc`` cannot swap the buffer out from
        under it; bounds are checked against the allocation frontier."""
        a = host_index(addrs)
        with self._lock:
            return GR.gather_read(self._live, a)

    def gather_bracketed(self, words: torch.Tensor, idxs, addrs, **kw):
        """A bulk read's bracketed gather, ``out`` [4, N]:
        ``words[idxs]`` before and after, the live ``heap[addrs]`` and
        the lock indices in one ``gather_read`` launch
        (``GR.gather_bracketed``, which takes ``kw``: more rows, the
        staged indices), enqueued under the heap lock like ``gather``;
        ``words`` is the lock table's row (``ArrayLockTable.row``)."""
        with self._lock:
            return GR.gather_bracketed(words, self._live, idxs, addrs, **kw)

    def scatter(self, addrs, values) -> None:
        """Batched write-back: one in-place ``scatter_write`` call under
        the heap lock (host values: one C call and one launch).  Bounds
        are checked against the frontier; values coerce through int64
        like the scalar ``int(value)``.  Addresses must be unique (write
        sets are dict-keyed)."""
        a = host_index(addrs)
        with self._lock:
            SW.scatter_write(self._live, a, values)


class ArrayLockTable(LockTable):
    """``LockTable`` semantics over a packed int64 device tensor.

    Inherits ``validate``/``try_lock``/``index`` (written against
    ``read``/``cas``) and overrides the storage layer, adding the bulk
    operations the vectorized hot path needs.  The bulk sweeps read the
    word row with ``gather_read`` and write it with ``scatter_write``;
    the claim/release bit arithmetic runs on the host over the gathered
    words, exactly as in the reference.
    """

    def __init__(self, bits: int, device=None):
        self.bits = bits
        self.size = 1 << bits
        self.device = resolve_device(device)
        self._words = torch.full((self.size,), _UNLOCKED_WORD,
                                 dtype=torch.int64, device=self.device)
        # 128 stripes: a bulk sweep acquires every DISTINCT stripe its
        # batch covers, so the stripe count bounds the per-sweep host
        # lock traffic while scalar CAS contention stays negligible
        self._stripes = Striped(128)

    @property
    def row(self) -> torch.Tensor:
        """The packed words themselves, for the bracketed bulk gather."""
        return self._words

    # -- storage ops -------------------------------------------------------
    def _word(self, idx: int) -> int:
        return int(self._words[idx])

    def read(self, idx: int) -> LockState:
        return unpack_lock(self._word(idx))

    def read_wait_unflagged(self, idx: int) -> LockState:
        # one device read per spin
        while True:
            w = self._word(idx)
            if not (w & 1):
                return unpack_lock(w)

    def cas(self, idx: int, expect: LockState, new: LockState) -> bool:
        with self._stripes.for_index(idx):
            if self._word(idx) != pack_lock(expect):
                return False
            # enqueued before the stripe is released
            self._words[idx] = pack_lock(new)
            return True

    def store(self, idx: int, new: LockState) -> None:
        with self._stripes.for_index(idx):
            self._words[idx] = pack_lock(new)

    def lock_and_flag(self, idx: int, tid: int) -> LockState:
        while True:
            st = self.read(idx)
            if not st.locked and not st.flag:
                if self.cas(idx, st, LockState(True, st.version, tid, True)):
                    return st

    def unlock(self, idx: int, version: Optional[int] = None) -> None:
        with self._stripes.for_index(idx):
            # the current word matters only when its version is kept
            v = version if version is not None else self.read(idx).version
            self._words[idx] = pack_lock(LockState(False, v, -1, False))

    # -- bulk ops ----------------------------------------------------------
    def index_bulk(self, addrs) -> np.ndarray:
        """Vectorized ``index``: the Fibonacci hash of many addresses at
        once, on the host (uint64 arithmetic wraps mod 2**64 exactly like
        the scalar Python path masks it)."""
        a = np.asarray(addrs, np.uint64) * np.uint64(_GOLDEN)
        return (a >> np.uint64(64 - self.bits)).astype(np.int64)

    def words_at(self, idxs, dev_idx=None, out=None) -> torch.Tensor:
        """Raw packed words, one ``gather_read`` launch (a device tensor;
        into ``out`` when given).  ``dev_idx``: the same indices already
        on the device."""
        return GR.gather_read(self._words, host_index(idxs), dev_idx, out)

    def _host_words(self, idxs: np.ndarray) -> np.ndarray:
        return self.words_at(idxs).cpu().numpy()

    def gather(self, idxs) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
        """One consistent snapshot of many lock words.

        Returns device tensors ``(version int64[N], owner int32[N],
        meta int32[N])`` with meta bit0 = locked, bit1 = flag — the
        layout the ``validate`` kernel consumes.
        """
        ver, own, meta = _split(self.words_at(idxs))   # one gather_read
        return ver, own.to(torch.int32), meta.to(torch.int32)

    @staticmethod
    def host_fields(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        """``gather``'s field split over packed words already copied to
        the host: ``(version int64, owner int32, meta int32)`` arrays."""
        ver, own, meta = _split(np.asarray(w, np.int64))
        return ver, own.astype(np.int32), meta.astype(np.int32)

    def held_by(self, tid: int) -> np.ndarray:
        """Indices currently write-locked by ``tid`` (exhaustion cleanup)."""
        w = self._words
        mask = ((w & 2) != 0) & ((((w >> 2) & _TID_MASK) - _TID_BIAS) == tid)
        return torch.nonzero(mask).reshape(-1).cpu().numpy()

    def try_lock_bulk(self, idxs, tid: int,
                      max_version: Optional[int] = None
                      ) -> Optional[np.ndarray]:
        """All-or-nothing bulk claim: one CAS sweep over many indices.

        Deduplicates ``idxs`` (colliding addresses share a lock word),
        then — holding every covering stripe, acquired in ascending
        order — checks the whole batch with ONE gather and, only if
        every word is claimable, claims the free ones with ONE scatter.
        Claimable means: free and unflagged (a word locked or flagged by
        someone else conflicts; a word locked by ``tid`` passes
        untouched), and — when ``max_version`` is given — free words
        must also carry ``version < max_version``, checked under the
        same stripes the claim holds.

        On ANY conflict nothing is mutated and ``None`` returns.
        Returns the NEWLY-ACQUIRED unique indices (ascending int64[n]) —
        words already held by ``tid`` are excluded, so an unwinding
        caller releases exactly what this call took.  Per-word claim
        semantics match ``try_lock``: version preserved, flag cleared.
        """
        uniq = np.unique(np.asarray(idxs, np.int64))

        def conflicts(w):
            locked = (w & 2) != 0
            flagged = (w & 1) != 0
            own = locked & ((((w >> 2) & _TID_MASK) - _TID_BIAS) == tid)
            c = (locked | flagged) & ~own
            if max_version is not None:
                c |= ~locked & ((w >> _VER_SHIFT) >= max_version)
            return c

        # test-and-test-and-set: a conflict visible in a plain gather is
        # authoritative for FAILING, so the common doomed sweep skips the
        # stripe dance
        if bool(conflicts(self._host_words(uniq)).any()):
            return None
        stripes = self._stripes.for_indices(uniq)
        for s in stripes:
            s.acquire()
        try:
            w = self._host_words(uniq)
            if bool(conflicts(w).any()):
                return None
            free = (w & 2) == 0
            new = ((w >> _VER_SHIFT) << _VER_SHIFT) \
                | (((tid + _TID_BIAS) & _TID_MASK) << 2) | 2
            SW.scatter_write(self._words, uniq[free], new[free])
            return uniq[free]
        finally:
            for s in stripes:
                s.release()

    def striped(self, idxs):
        """Context manager holding every stripe covering ``idxs``
        (acquired ascending, like the bulk sweeps).  Pair with
        ``words_at``/``store_words``; do NOT call the self-locking ops
        inside."""
        from contextlib import contextmanager

        stripes = self._stripes.for_indices(np.asarray(idxs, np.int64))

        @contextmanager
        def _hold():
            for s in stripes:
                s.acquire()
            try:
                yield
            finally:
                for s in stripes:
                    s.release()

        return _hold()

    def store_words(self, idxs, words) -> None:
        """Raw word scatter (one ``scatter_write`` call and launch).
        Caller MUST hold ``striped(idxs)`` (or the words must be claim
        words only this thread may release)."""
        SW.scatter_write(self._words, host_index(idxs), words)

    def claim_words(self, words: np.ndarray, tids) -> np.ndarray:
        """Locked spellings of host ``words`` claimed by per-entry
        ``tids`` (version preserved, flag cleared)."""
        words = np.asarray(words, np.int64)
        return ((words >> _VER_SHIFT) << _VER_SHIFT) \
            | (((np.asarray(tids, np.int64) + _TID_BIAS) & _TID_MASK) << 2) \
            | 2

    def unlock_bulk(self, idxs, version: Optional[int] = None) -> None:
        """Release many locks in one sweep (commit publish / rollback).

        ``version`` republishes every word at that clock; ``None``
        preserves each word's current version.  Duplicate indices are
        safe WITHIN the sweep: every occurrence stores the same unlocked
        word while the stripes are held.
        """
        arr = np.asarray(idxs, np.int64)
        stripes = self._stripes.for_indices(arr)
        for s in stripes:
            s.acquire()
        try:
            if version is None:
                w = self._host_words(arr)
                new = ((w >> _VER_SHIFT) << _VER_SHIFT) | _UNLOCKED_WORD
                SW.scatter_write(self._words, arr, new)
            else:
                # every word the same: the fill form, indices alone
                SW.scatter_fill(self._words, arr, (version << _VER_SHIFT)
                                | _UNLOCKED_WORD)
        finally:
            for s in stripes:
                s.release()
