"""Epoch-based reclamation tied to transaction commit/abort (paper SS4.5).

The paper's key memory-management points, reproduced here:
  * retires issued during a transaction are buffered and REVOCABLE — an
    aborted update revokes the retire of the previous version it displaced,
    and instead retires the version it had added;
  * a retired node is only freed when every thread has passed the retire
    epoch (so a non-revalidating reader can never dereference freed memory
    — the TL2/DCTL segfault race of SS4.5);
  * freeing sets a poison bit so tests can PROVE absence of use-after-free.
"""
from __future__ import annotations

import threading
from typing import List


class EBR:
    GRACE = 2

    def __init__(self, n_threads: int):
        self.global_epoch = 0
        self._lock = threading.Lock()
        self._thread_epochs = [-1] * n_threads   # -1 = quiescent
        self._limbo: List[tuple] = []            # (epoch, node)
        self.freed_count = 0

    def pin(self, tid: int) -> None:
        self._thread_epochs[tid] = self.global_epoch

    def unpin(self, tid: int) -> None:
        self._thread_epochs[tid] = -1

    def retire(self, node) -> None:
        with self._lock:
            self._limbo.append((self.global_epoch, node))

    def retire_all(self, nodes) -> None:
        with self._lock:
            e = self.global_epoch
            self._limbo.extend((e, n) for n in nodes)

    def advance_and_reclaim(self) -> int:
        """Background-thread duty: bump the epoch and free safe nodes."""
        with self._lock:
            self.global_epoch += 1
            min_pinned = min((e for e in self._thread_epochs if e >= 0),
                             default=self.global_epoch)
            keep, freed = [], 0
            for e, node in self._limbo:
                if e + self.GRACE <= min_pinned:
                    node.freed = True           # poison: tests assert on it
                    freed += 1
                else:
                    keep.append((e, node))
            self._limbo = keep
            self.freed_count += freed
            return freed

    @property
    def limbo_size(self) -> int:
        return len(self._limbo)


class TxRetireBuffer:
    """Per-transaction revocable retires (paper SS4.5)."""

    def __init__(self, ebr: EBR):
        self._ebr = ebr
        self._pending = []        # retired iff the txn commits
        self._on_abort = []       # retired iff the txn aborts

    def retire_on_commit(self, node) -> None:
        self._pending.append(node)

    def retire_on_abort(self, node) -> None:
        self._on_abort.append(node)

    def commit(self) -> None:
        self._ebr.retire_all(self._pending)
        self._pending.clear()
        self._on_abort.clear()

    def abort(self) -> None:
        """Revoke pending retires; retire the aborted txn's own additions."""
        self._pending.clear()
        self._ebr.retire_all(self._on_abort)
        self._on_abort.clear()
