"""Versioned lock table (paper SS3, Alg. 2).

A lock word is the tuple (locked, version, tid, flag):
  locked  — held by an updater (encounter-time locking)
  version — commit clock of the last writer to any address in this bucket
  tid     — current holder (lets a transaction revalidate its own locks)
  flag    — 'versioning in progress': readers/writers must wait, the holder
            is only installing a version list, not changing data

The lock table, bloom-filter table and VLT are identically sized and share
one address->index map, so an address's lock also protects its version list
(paper SS3.1).  CAS is emulated with striped host locks (clock.Striped).
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

from repro_torch.core.clock import Striped


class LockState(NamedTuple):
    locked: bool
    version: int
    tid: int
    flag: bool


UNLOCKED = LockState(False, 0, -1, False)

# Fibonacci hashing; all three tables use this same map (paper SS3.1).
_GOLDEN = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def addr_index(addr: int, bits: int) -> int:
    return ((addr * _GOLDEN) & _MASK64) >> (64 - bits)


class LockTable:
    def __init__(self, bits: int):
        self.bits = bits
        self.size = 1 << bits
        self._words = [UNLOCKED] * self.size
        self._stripes = Striped(1024)

    def index(self, addr: int) -> int:
        return addr_index(addr, self.bits)

    # -- raw word ops -----------------------------------------------------
    def read(self, idx: int) -> LockState:
        return self._words[idx]

    def read_wait_unflagged(self, idx: int) -> LockState:
        """Reread the lock until flag is false (paper Alg. 3 line 2)."""
        while True:
            st = self._words[idx]
            if not st.flag:
                return st

    def cas(self, idx: int, expect: LockState, new: LockState) -> bool:
        with self._stripes.for_index(idx):
            if self._words[idx] != expect:
                return False
            self._words[idx] = new
            return True

    def store(self, idx: int, new: LockState) -> None:
        with self._stripes.for_index(idx):
            self._words[idx] = new

    # -- paper operations ---------------------------------------------------
    def validate(self, st: LockState, r_clock: int, tid: int) -> bool:
        """validateLock (Alg. 2): own locks pass; held locks conflict;
        versions must predate the read clock."""
        if st.tid == tid and st.locked:
            return True
        if st.locked or st.flag:
            return False
        return st.version < r_clock

    def try_lock(self, idx: int, st: LockState, tid: int) -> bool:
        """Claim for writing (encounter-time)."""
        if st.locked:
            return st.tid == tid
        return self.cas(idx, st, LockState(True, st.version, tid, False))

    def lock_and_flag(self, idx: int, tid: int) -> LockState:
        """Spin until the lock is claimed with the versioning flag set
        (paper Alg. 4 versionThenRead); returns the pre-claim state."""
        while True:
            st = self._words[idx]
            if not st.locked and not st.flag:
                if self.cas(idx, st, LockState(True, st.version, tid, True)):
                    return st

    def unlock(self, idx: int, version: Optional[int] = None) -> None:
        """Release, optionally publishing a new version."""
        with self._stripes.for_index(idx):
            st = self._words[idx]
            v = version if version is not None else st.version
            self._words[idx] = LockState(False, v, -1, False)
