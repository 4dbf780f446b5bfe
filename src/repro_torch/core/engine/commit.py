"""Commit pipeline steps for encounter-time policies over the device heap.

The begin/read/write/commit scaffolding lives here as policy-agnostic
steps over an engine:

  * encounter-time (DCTL-style) commits: locks are already held, so the
    pipeline is revalidate + ``release_locks`` at the commit clock;
  * encounter-time aborts: ``rollback_inplace`` restores the undo log and
    releases the held locks at a bumped clock (the deferred-clock abort
    increment that keeps readers from missing the rollback);
  * batched writes: ``merge_undo`` records pre-images with one
    ``gather_read`` launch and ``heap_scatter`` publishes with one
    in-place ``scatter_write`` launch.

Every step is BATCHED at write sets >= ``BULK_MIN``: lock claims are one
``ArrayLockTable.try_lock_bulk`` sweep (all-or-nothing), write-back and
undo-restore one heap ``scatter``, lock release one ``unlock_bulk``
sweep.  Below the threshold the exact scalar loops run.

The reference's heap write-back never reached its scatter kernel (its
heap was a host numpy array); here the heap lives on the device, so the
write-back IS the kernel launch.

LOCK-INDEX NORMALIZATION: every release path deals in DEDUPED lock
indices, never raw heap addresses.  Two addresses can collide into one
lock word, and releasing per-address unlocks that word TWICE — after the
first release another thread can legitimately claim it, and the second
release stomps their lock.  ``held_write_indices`` is the single home of
the address->index normalization.

The durable-log hooks are kept as inert code: the write-ahead log is not
ported yet, so ``eng.wal`` is always ``None`` here.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core.engine.validation import BULK_MIN
from repro_torch.reliability import faultpoints as FP


def addr_lock_indices(eng, addrs: Iterable[int]) -> np.ndarray:
    """Heap addresses -> DEDUPED ascending lock indices (host int64)."""
    if not hasattr(addrs, "__len__"):
        addrs = list(addrs)
    a = np.fromiter((int(x) for x in addrs), np.int64, len(addrs))
    index_bulk = getattr(eng.locks, "index_bulk", None)
    if index_bulk is not None:
        return np.unique(index_bulk(a))
    return np.unique(np.fromiter((eng.locks.index(int(x)) for x in a),
                                 np.int64, a.size))


def held_write_indices(eng, d) -> np.ndarray:
    """Every lock index this attempt's writes hold, deduplicated: the
    undo log's addresses (normalized via ``locks.index``) plus the
    policy's explicit encounter-time index set."""
    idxs = set(int(i) for i in getattr(d, "locked_idxs", ()))
    if d.undo:
        idxs.update(int(i) for i in addr_lock_indices(eng, d.undo))
    return np.fromiter(sorted(idxs), np.int64, len(idxs))


def dedup_last_wins(addrs: np.ndarray, values):
    """Collapse duplicate addresses in a write batch, LAST write winning.

    ``Txn.write_bulk`` promises ``for a, v: write(a, v)`` semantics; a
    heap scatter with duplicate indices keeps an unspecified writer, so
    the encounter-time bulk paths route through here first.  The common
    duplicate-free batch pays one vectorized uniqueness check.
    """
    if np.unique(addrs).size == addrs.size:
        return addrs, values
    vals = values.tolist() if isinstance(values, torch.Tensor) \
        else list(values)
    m = dict(zip(addrs.tolist(), vals))
    return np.fromiter(m.keys(), np.int64, len(m)), list(m.values())


def extend_and_relock(eng, d, idxs: np.ndarray):
    """Snapshot extension for a version-blocked bulk write claim.

    Under the deferred clock, a writer's own previous commit leaves its
    lock words at version == the CURRENT clock, so the next
    transaction's claim (which requires ``version < r_clock``) fails
    even though nothing conflicts.  If no word is foreign-locked or
    flagged and the read set still revalidates RIGHT NOW, the
    transaction can serialize at a later snapshot: advance the snapshot
    past the current clock, revalidate, and retry the claim once.
    Returns the newly-claimed indices or ``None``.

    ORDER MATTERS: the clock is bumped BEFORE revalidating, and the
    revalidation runs at the OLD ``r_clock``; only on success does the
    snapshot advance to the bumped value.  Any foreign commit that
    completes after the bump publishes at >= the new snapshot and fails
    the final commit's V_LT; any foreign commit before it is caught by
    the revalidation here.
    """
    ver, own, meta = eng.locks.gather(idxs)
    foreign = ((meta & 1) != 0) & (own != d.tid)
    flagged = (meta & 2) != 0
    if bool((foreign | flagged).any()):
        return None
    candidate = eng.clock.increment()
    if not eng.revalidate(d):
        return None
    d.r_clock = candidate
    return eng.locks.try_lock_bulk(idxs, d.tid, max_version=d.r_clock)


def extend_snapshot(eng, d) -> bool:
    """Scalar twin of ``extend_and_relock``'s clock step (same ordering
    pin: bump, revalidate at the OLD ``r_clock``, then advance).
    Returns True iff the snapshot advanced; False means abort."""
    candidate = eng.clock.increment()
    if not eng.revalidate(d):
        return False
    d.r_clock = candidate
    return True


def merge_undo(eng, d, addrs: np.ndarray) -> None:
    """Record pre-images for a write batch in one heap gather.

    First write wins: entries already in the undo log are the true
    pre-images, so the fresh gather only fills the gaps.
    """
    from repro_torch.core.engine.bulkread import heap_gather
    olds = heap_gather(eng.heap, addrs)
    if isinstance(olds, torch.Tensor):
        olds = olds.tolist()
    merged = dict(zip(addrs.tolist(), olds))
    merged.update(d.undo)
    d.undo = merged


def heap_scatter(heap, addrs, values, tid: int = -1) -> None:
    """``heap[addrs] = values`` in one pass (the write-back twin of
    ``bulkread.heap_gather``): one in-place ``scatter_write`` launch on
    ``ArrayHeap``, one list pass on ``ObjectHeap``, scalar stores on
    anything else.

    When a fault schedule is installed the sweep splits into two
    launches around the ``mid_scatter`` point — a crash there leaves a
    PARTIAL-LANE heap image (half the lanes scattered, the rest not).
    """
    sc = getattr(heap, "scatter", None)
    if sc is None:
        def sc(a, v):  # noqa: E731 - scalar-store fallback
            for ai, vi in zip(a, v):
                heap[int(ai)] = vi
    n = len(values) if hasattr(values, "__len__") else 0
    if FP.ACTIVE is not None and n > 1:
        h = n // 2
        sc(addrs[:h], values[:h])
        FP.fire("mid_scatter", tid)
        sc(addrs[h:], values[h:])
        return
    sc(addrs, values)


def wal_log_decide_encounter(eng, d) -> None:
    """PREPARE + DECIDE for encounter-time policies at their decide
    point (revalidation passed, locks still held).  Inert until the
    write-ahead log is ported: ``eng.wal`` is ``None``."""
    wal = eng.wal
    if wal is None or not d.undo:
        return
    addrs = np.fromiter(d.undo.keys(), np.int64, len(d.undo))
    vals = eng.heap.gather(addrs)
    d.wal_lsn = wal.append_prepare(
        d.tid, addrs, vals, clocks=(eng.clock.load(),))
    wal.append_decide(d.wal_lsn)


def release_locks(eng, idxs: Iterable[int],
                  version: Optional[int] = None,
                  bulk_min: Optional[int] = None) -> None:
    """Release lock INDICES (never raw addresses), optionally publishing
    ``version``; one ``unlock_bulk`` sweep at batches >= ``bulk_min``."""
    bm = BULK_MIN if bulk_min is None else bulk_min
    arr = idxs if isinstance(idxs, np.ndarray) else None
    n = arr.size if arr is not None else len(idxs)  # type: ignore[arg-type]
    unlock_bulk = getattr(eng.locks, "unlock_bulk", None)
    if unlock_bulk is not None and n >= bm:
        if arr is None:
            arr = np.fromiter(idxs, np.int64, n)
        unlock_bulk(arr, version)
        return
    for idx in idxs:
        eng.locks.unlock(int(idx), version)


def rollback_inplace(eng, d, bump_clock: bool = True,
                     bulk_min: Optional[int] = None) -> None:
    """Undo encounter-time in-place writes and release the held locks.

    ``bump_clock`` implements the deferred clock's abort increment: the
    released locks are republished at a FRESH version so any reader that
    validated against the uncommitted value must revalidate and abort.
    The undo restore is one heap ``scatter`` at >= ``bulk_min`` entries,
    and the release set is ``held_write_indices``.
    """
    bm = BULK_MIN if bulk_min is None else bulk_min
    undo = d.undo
    if len(undo) >= bm and getattr(eng.heap, "scatter", None) is not None:
        addrs = np.fromiter(undo.keys(), np.int64, len(undo))
        heap_scatter(eng.heap, addrs, list(undo.values()), tid=d.tid)
    else:
        for addr, old in undo.items():
            eng.heap[addr] = old
    nxt = eng.clock.increment() if bump_clock else None
    release_locks(eng, held_write_indices(eng, d), nxt, bulk_min=bm)
