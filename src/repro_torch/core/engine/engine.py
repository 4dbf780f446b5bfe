"""``TransactionEngine`` — one runtime, pluggable TM policies.

The engine owns everything the five word-level backends used to each
re-implement: the heap, the global clock, the (array-backed) lock table,
per-thread transaction descriptors, begin/commit/abort orchestration,
transactional allocation rollback, stats aggregation, and the retry-
exhaustion safety net.  A ``TMPolicy`` supplies only the algorithm
(read/write/validate/commit/rollback), so a backend is the ~50 lines
that differ from the textbook, not the ~200 that don't.

Lifecycle contract (what ``repro_torch.api`` drives):

  * ``begin(tid)`` resets the descriptor, runs ``policy.on_begin`` and
    returns a ``_Tx`` handle;
  * ``_try_commit(d)`` routes read-only descriptors (no write footprint)
    to ``policy.commit_read_only`` and everything else to
    ``policy.commit_update``; commit counters and ``active`` are engine
    business;
  * ``_abort(d)`` is IDEMPOTENT and does not raise: rollback via the
    policy, free txn-local allocations, count, run ``policy.on_abort``.
    Policy code that needs to abort-and-longjmp calls ``abort_txn``;
  * ``release_thread_locks(tid)`` / ``on_retries_exhausted(tid)`` force-
    release anything a capped transaction still holds so one starved
    thread can never wedge later writers (paper SS5's retry cap).
"""
from __future__ import annotations

from typing import Any, List, Optional

from repro_torch.core.clock import GlobalClock
from repro_torch.core.engine import bulkread as B
from repro_torch.core.engine import validation as V
from repro_torch.core.engine.arrayheap import (
    ArrayLockTable,
    ObjectHeap,
    resolve_device,
)
from repro_torch.core.engine.descriptor import COUNTER_KEYS, TxnDescriptor
from repro_torch.core.engine.errors import AbortTx
from repro_torch.core.stats_schema import RECOVERY_STAT_KEYS, base_stats


class TMBase:
    """Shared heap + allocation interface (structures build on this)."""

    def __init__(self, n_threads: int, heap=None):
        self.n_threads = n_threads
        self.heap = heap if heap is not None else ObjectHeap()
        self.name = type(self).__name__

    # heap ---------------------------------------------------------------
    def alloc(self, n: int, init: Any = None) -> int:
        return self.heap.alloc(n, init)

    def peek(self, addr: int) -> Any:
        """Non-transactional read (test/debug only)."""
        return self.heap[addr]

    @property
    def _heap(self):
        # historical name: pre-engine code indexed the raw list directly
        return self.heap

    def stop(self) -> None:  # pragma: no cover - overridden
        pass


class _Tx:
    """Handle passed to user transaction bodies."""

    __slots__ = ("_tm", "_ctx")

    def __init__(self, tm: "TransactionEngine", ctx: TxnDescriptor):
        self._tm = tm
        self._ctx = ctx

    def read(self, addr: int) -> Any:
        return self._tm.tm_read(self._ctx, addr)

    def read_bulk(self, addrs) -> Any:
        return self._tm.tm_read_bulk(self._ctx, addrs)

    def traverse_bulk(self, roots, expand, *, limit: Optional[int] = None):
        """Frontier-at-a-time traversal (see ``engine/traverse.py``)."""
        from repro_torch.core.engine.traverse import traverse_bulk
        return traverse_bulk(self, roots, expand, limit=limit)

    def chase_bulk(self, cursors, advance) -> int:
        """Vectorized single-word pointer chase (``engine/traverse.py``)."""
        from repro_torch.core.engine.traverse import chase_bulk
        return chase_bulk(self, cursors, advance)

    def write(self, addr: int, value: Any) -> None:
        self._tm.tm_write(self._ctx, addr, value)

    def write_bulk(self, addrs, values) -> None:
        self._tm.tm_write_bulk(self._ctx, addrs, values)

    def alloc(self, n: int, init: Any = None) -> int:
        return self._tm.tx_alloc(self._ctx, n, init)

    @property
    def read_count(self) -> int:
        return self._ctx.read_cnt


class TransactionEngine(TMBase):
    def __init__(self, policy, n_threads: int, lock_bits: int = 16,
                 heap=None, device=None):
        super().__init__(n_threads, heap=heap)
        self.policy = policy
        self.name = policy.name
        self.clock = GlobalClock(0)
        #: where the lock table (and an array heap, and the version
        #: mirror) live; ``None`` means the card
        self.device = resolve_device(device)
        self.locks = ArrayLockTable(lock_bits, self.device)
        self._descs = [TxnDescriptor(t) for t in range(n_threads)]
        # durable commit log (reliability/wal.attach_wal sets it): the
        # hooks in engine/commit.py journal every update commit; the
        # recovery counters keep the shared stats schema whole
        self.wal = None
        self.recovery_counters = {k: 0 for k in RECOVERY_STAT_KEYS}
        policy.setup(self)

    # ------------------------------------------------------------------
    # transaction lifecycle
    # ------------------------------------------------------------------
    def ctx(self, tid: int) -> TxnDescriptor:
        return self._descs[tid]

    def begin_operation(self, tid: int) -> None:
        """A NEW logical operation (fresh retry loop) starts on ``tid``."""
        self.policy.on_operation_start(self, self._descs[tid])

    def begin(self, tid: int) -> _Tx:
        d = self._descs[tid]
        d.reset()
        self.policy.on_begin(self, d)
        d.active = True
        return _Tx(self, d)

    def _try_commit(self, d: TxnDescriptor) -> None:
        if d.read_only and not d.has_writes:
            self.policy.commit_read_only(self, d)
            d.stats["ro_commits"] += 1
        else:
            self.policy.commit_update(self, d)
            d.stats["commits"] += 1
            if self.wal is not None and d.wal_lsn is not None:
                # publish finished: buffered COMPLETE marker (replay is
                # idempotent without it; recovery uses it to report
                # decided-but-unpublished as rolled forward)
                self.wal.append_complete(d.wal_lsn)
                d.wal_lsn = None
        d.active = False
        self.policy.on_finish(self, d)

    def _abort(self, d: TxnDescriptor) -> None:
        """Roll back an attempt.  Idempotent; does NOT raise."""
        if not d.active:
            return
        self.policy.rollback(self, d)
        # free txn-local allocations (nobody else can have seen them: the
        # addresses were only reachable via this txn's unpublished writes)
        blank = None if isinstance(self.heap, ObjectHeap) else 0
        for base, n in d.alloc_log:
            for i in range(n):
                self.heap[base + i] = blank
        d.alloc_log.clear()
        d.stats["aborts"] += 1
        d.active = False
        self.policy.on_abort(self, d)

    def abort_txn(self, d: TxnDescriptor) -> None:
        """Abort + longjmp (policy-internal conflict path)."""
        self._abort(d)
        raise AbortTx()

    # ------------------------------------------------------------------
    # accesses
    # ------------------------------------------------------------------
    def tm_read(self, d: TxnDescriptor, addr: int) -> Any:
        d.read_cnt += 1
        return self.policy.read(self, d, addr)

    def tm_read_bulk(self, d: TxnDescriptor, addrs) -> Any:
        """Batched read: the whole address batch in one policy call.

        Counts as ``len(addrs)`` reads (heuristics like K1/K2/K3 and the
        paper's MinModeUReadCount are calibrated on words read, and a
        bulk scan reads just as many words as a scalar one).
        """
        a = B.as_addr_array(addrs)
        d.read_cnt += a.size
        return self.policy.read_bulk(self, d, a)

    def tm_write(self, d: TxnDescriptor, addr: int, value: Any) -> None:
        self.policy.write(self, d, addr, value)

    def tm_write_bulk(self, d: TxnDescriptor, addrs, values) -> None:
        """Batched write: the whole (addrs, values) batch in one policy
        call — buffered policies fold it into the write map in one dict
        update; encounter-time policies claim the locks in one
        ``try_lock_bulk`` sweep (see each policy's ``write_bulk``)."""
        self.policy.write_bulk(self, d, B.as_addr_array(addrs), values)

    def tx_alloc(self, d: TxnDescriptor, n: int, init: Any = None) -> int:
        base = self.alloc(n, init)
        d.alloc_log.append((base, n))
        return base

    # ------------------------------------------------------------------
    # validation (scalar below BULK_MIN, vectorized above)
    # ------------------------------------------------------------------
    def revalidate(self, d: TxnDescriptor, mode: Optional[int] = None,
                   r_clock: Optional[int] = None) -> bool:
        return V.revalidate(
            self.locks, d.read_set,
            d.r_clock if r_clock is None else r_clock, d.tid,
            self.policy.validate_mode if mode is None else mode)

    def validate_ctx(self, d: TxnDescriptor) -> bool:
        """``Txn.validate_bulk`` lands here via the substrate adapter."""
        return self.policy.validate(self, d)

    # ------------------------------------------------------------------
    # retry-cap safety net
    # ------------------------------------------------------------------
    def release_thread_locks(self, tid: int) -> int:
        """Force-release every lock still held by ``tid``.

        Released locks are republished at a bumped clock so any reader
        that validated against a half-done write revalidates and aborts —
        the same deferred-clock rule the abort path uses.
        """
        held = self._held_by(tid)
        if len(held) == 0:
            return 0
        nxt = self.clock.increment()
        for idx in held:
            self.locks.unlock(int(idx), nxt)
        return len(held)

    def _held_by(self, tid: int) -> List[int]:
        held_by = getattr(self.locks, "held_by", None)
        if held_by is not None:
            return list(held_by(tid))
        return [i for i in range(self.locks.size)
                if (st := self.locks.read(i)).locked and st.tid == tid]

    def on_retries_exhausted(self, tid: int) -> None:
        """Called by ``repro_torch.api.run`` before raising MaxRetriesExceeded."""
        d = self._descs[tid]
        self._abort(d)                    # no-op unless an attempt is live
        self.release_thread_locks(tid)
        self.policy.on_retries_exhausted(self, tid)

    # ------------------------------------------------------------------
    # stats / teardown
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        out = base_stats(backend=self.name,
                         mode=self.policy.mode_name(self))
        for d in self._descs:
            for k in COUNTER_KEYS:
                out[k] += d.stats[k]
        for k, v in self.recovery_counters.items():
            out[k] += v
        self.policy.extra_stats(self, out)
        return out

    def stop(self) -> None:
        self.policy.stop(self)
