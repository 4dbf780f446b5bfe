"""Heuristics K1/K2/K3/S/L/P + shared announcements (paper SS4.2-SS4.4).

Shared between the Layer-A STM (core/stm.py) and the Layer-B MVStore
controller (core/mvcontroller.py): both adapt versioning with exactly these
rules, at word vs parameter-block granularity.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from repro_torch.configs.paper_stm import MultiverseParams


class ThreadAnnouncement:
    """Per-thread shared slots the background thread inspects (Alg. 1/5)."""

    __slots__ = ("local_mode_counter", "sticky_mode_u", "commit_ts_delta",
                 "active_versioned", "small_txn_read_cnt",
                 "consec_small_txns")

    def __init__(self):
        self.local_mode_counter = 0
        self.sticky_mode_u = False
        self.commit_ts_delta: Optional[int] = None
        self.active_versioned = False
        self.small_txn_read_cnt: Optional[int] = None
        self.consec_small_txns = 0


class MinModeUReadCount:
    """Global minimum reads of committed Mode-U versioned txns (SS4.2)."""

    def __init__(self):
        self._v: Optional[int] = None
        self._lock = threading.Lock()

    def update(self, read_cnt: int) -> None:
        with self._lock:
            if self._v is None or read_cnt < self._v:
                self._v = read_cnt

    def get(self) -> Optional[int]:
        return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = None


def should_go_versioned(params: MultiverseParams, attempts: int) -> bool:
    """K1: an unversioned read-only txn switches to the versioned path
    after K1 failed attempts (SS4.1)."""
    return attempts >= params.k1


def should_attempt_mode_cas(params: MultiverseParams, *, versioned: bool,
                            attempts: int, read_cnt: int,
                            min_mode_u_reads: Optional[int]) -> bool:
    """K2/K3: when a read-only txn should CAS the TM from Q to QtoU
    (SS4.3).  Versioned txns always try after K3 attempts; any read-only
    txn tries after K2 attempts iff its read count reaches the minimum
    Mode-U read count observed so far."""
    if versioned and attempts >= params.k3:
        return True
    if attempts >= params.k2:
        if min_mode_u_reads is None:
            return versioned  # no Mode-U history yet: only versioned txns
        return read_cnt >= min_mode_u_reads
    return False


def sticky_cleared(params: MultiverseParams, ann: ThreadAnnouncement,
                   read_cnt: int) -> bool:
    """S: the sticky Mode-U bit clears after S consecutive 'small'
    transactions; small = readCnt <= (1/S) * size of the first txn
    committed after the last CAS attempt (SS4.3)."""
    if ann.small_txn_read_cnt is None:
        ann.small_txn_read_cnt = max(1, read_cnt // max(params.s, 1))
        ann.consec_small_txns = 0
        return False
    if read_cnt <= ann.small_txn_read_cnt:
        ann.consec_small_txns += 1
    else:
        ann.consec_small_txns = 0
    if ann.consec_small_txns >= params.s:
        ann.small_txn_read_cnt = None
        ann.consec_small_txns = 0
        return True
    return False


class UnversionThreshold:
    """L/P: the background thread averages commit-timestamp deltas into a
    list of length L, sorts descending, and averages the first P fraction;
    buckets older than that delta get unversioned (SS4.4)."""

    def __init__(self, params: MultiverseParams):
        self.params = params
        self._deltas: List[float] = []

    def observe_round(self, deltas: List[int]) -> None:
        if deltas:
            self._deltas.append(sum(deltas) / len(deltas))
            if len(self._deltas) > self.params.l:
                self._deltas.pop(0)

    def threshold(self) -> Optional[float]:
        if len(self._deltas) < self.params.l:
            return None
        s = sorted(self._deltas, reverse=True)
        n = max(1, int(len(s) * self.params.p))
        return sum(s[:n]) / n
