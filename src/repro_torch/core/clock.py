"""Global clock + atomic primitives for the Layer-A STM.

CPython has no std::atomic; CAS/fetch-add are emulated with striped host
locks.  This changes constant factors, never the algorithm: every lock
protects exactly one CAS/load/store linearization point (DESIGN.md SS2,
honesty note).
"""
from __future__ import annotations

import threading


class AtomicInt:
    __slots__ = ("_v", "_lock")

    def __init__(self, v: int = 0):
        self._v = v
        self._lock = threading.Lock()

    def load(self) -> int:
        return self._v  # aligned word read (GIL-atomic in CPython)

    def store(self, v: int) -> None:
        with self._lock:
            self._v = v

    def increment(self) -> int:
        """fetch-add(1) + 1 — returns the NEW value (paper: gClock.increment)."""
        with self._lock:
            self._v += 1
            return self._v

    def cas(self, expect: int, new: int) -> bool:
        with self._lock:
            if self._v != expect:
                return False
            self._v = new
            return True


class GlobalClock(AtomicInt):
    """DCTL-style deferred clock: read at txn begin/commit; incremented by
    aborting writers (paper Alg. 1 line 30)."""


class Striped:
    """Stripe of host locks for per-address CAS emulation."""

    def __init__(self, n: int = 256):
        self._locks = [threading.Lock() for _ in range(n)]
        self._mask = n - 1

    def for_index(self, idx: int) -> threading.Lock:
        return self._locks[idx & self._mask]

    def for_indices(self, idxs) -> list:
        """The DISTINCT stripe locks covering ``idxs``, ascending.

        The bulk lock-table operations hold every stripe their index
        batch touches for the whole compare-and-sweep; ascending
        acquisition order keeps two concurrent bulk sweeps deadlock-free
        (scalar CAS holds a single stripe, so it can never close a
        cycle).
        """
        import numpy as np

        hit = np.bincount(np.asarray(idxs, np.int64) & self._mask,
                          minlength=self._mask + 1)
        locks = self._locks
        return [locks[int(i)] for i in np.nonzero(hit)[0]]
