"""Commit pipeline steps over the device heap.

The begin/read/write/commit scaffolding lives here as policy-agnostic
steps over an engine:

  * buffered (TL2-style) commits: ``acquire_write_locks`` then
    ``write_back`` then ``release_locks`` at the new write version;
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
sweep.  Below the threshold the exact scalar loops run.  ``scatter_row``
is the out-of-place spelling for a row that readers may still hold.

The reference's heap write-back never reached its scatter kernel (its
heap was a host numpy array); here the heap lives on the device, so the
write-back IS the kernel launch.

LOCK-INDEX NORMALIZATION: every release path deals in DEDUPED lock
indices, never raw heap addresses.  Two addresses can collide into one
lock word, and releasing per-address unlocks that word TWICE — after the
first release another thread can legitimately claim it, and the second
release stomps their lock.  ``held_write_indices`` is the single home of
the address->index normalization.

The durable-log hooks (``wal_log_*``) journal to ``eng.wal`` when a
``reliability/wal.WriteAheadLog`` is attached (``attach_wal``).
"""
from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.engine.validation import BULK_MIN
from repro_torch.kernels import _lib
from repro_torch.kernels import scatter_write as SW
from repro_torch.reliability import faultpoints as FP


@contextlib.contextmanager
def acquire_ascending(locks):
    """Hold several commit locks at once, released in reverse order.

    The caller passes the locks already sorted by a global total order,
    so two commits with overlapping footprints can never deadlock.
    Unwind (a simulated crash included) releases whatever was acquired.
    """
    held = []
    try:
        for lk in locks:
            lk.acquire()
            held.append(lk)
        yield
    finally:
        for lk in reversed(held):
            lk.release()


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


def as_value_list(values) -> list:
    """A write batch's values as host Python values: a tensor (any
    device) comes back in one copy, anything else is listed as is —
    what the buffered write maps store."""
    if isinstance(values, torch.Tensor):
        return values.reshape(-1).tolist()
    return list(values)


def scatter_row(row: torch.Tensor, addrs, values) -> torch.Tensor:
    """``row`` with ``values`` scattered at ``addrs``, OUT OF PLACE: a
    new tensor (seeded by a copy) receives one ``scatter_write`` launch,
    so a reader still holding ``row`` keeps a whole old row.  Addresses
    must lie in ``[0, len(row))`` at both ends (``IndexError``); values
    are exact int64."""
    a = _lib.host_index(addrs)
    _lib.check_addr_bounds(a, row.shape[0])
    out = row.clone()
    SW.scatter_write(out, a, values)
    return out


# ---------------------------------------------------------------------------
# durable commit log hooks (reliability/wal.py)
# ---------------------------------------------------------------------------
#
# Protocol (the append-before-claim invariant): a PREPARE frame carrying
# the full redo image is buffered-appended BEFORE the claim/scatter
# phase; the fsync'd DECIDE marker lands at the exact instant
# ``publish_started`` flips True, before the first heap mutation is
# enqueued — file appends are sequential, so the one DECIDE fsync also
# makes the PREPARE durable.  An abandoned prepare (abort, or crash
# before DECIDE) is never replayed: rollback is free.


def wal_log_prepare(eng, d) -> None:
    """Buffered PREPARE from the buffered write map (before the claim)."""
    wal = eng.wal
    if wal is None or not d.write_map:
        return
    wm = d.write_map
    d.wal_lsn = wal.append_prepare(
        d.tid, np.fromiter(wm.keys(), np.int64, len(wm)),
        list(wm.values()), clocks=(eng.clock.load(),))


def wal_log_decide(eng, d) -> None:
    """fsync'd DECIDE at the publish_started flip (buffered path)."""
    wal = eng.wal
    if wal is None or d.wal_lsn is None:
        return
    wal.append_decide(d.wal_lsn)


def wal_log_decide_encounter(eng, d) -> None:
    """PREPARE + DECIDE for encounter-time policies, at their decide
    point (revalidation passed, locks still held).

    In-place backends scattered their values during execution, so the
    redo image is gathered FROM THE HEAP at the undo log's addresses —
    the locks guarantee those words still hold this transaction's
    values (on an array heap one ``gather_read`` launch, brought home
    once by the log).  There is no earlier correct hook: before
    revalidation the commit may still abort (and the undo restore would
    un-publish the prepared image), so prepare and decide collapse into
    one append + one fsync here.
    """
    wal = eng.wal
    if wal is None or not d.undo:
        return
    addrs = np.fromiter(d.undo.keys(), np.int64, len(d.undo))
    vals = eng.heap.gather(addrs)
    d.wal_lsn = wal.append_prepare(
        d.tid, addrs, vals, clocks=(eng.clock.load(),))
    wal.append_decide(d.wal_lsn)


def acquire_write_locks(eng, d,
                        bulk_min: Optional[int] = None) -> List[int]:
    """Claim every buffered write's lock (commit-time locking).

    On conflict, aborts the transaction with no locks held: the scalar
    loop releases whatever it had acquired (versions untouched); the
    bulk sweep (write sets >= ``bulk_min``) is all-or-nothing.  Returns
    the locked indices, deduplicated (ascending on the bulk path,
    acquisition order on the scalar path).
    """
    bm = BULK_MIN if bulk_min is None else bulk_min
    wal_log_prepare(eng, d)
    if FP.ACTIVE is not None:
        FP.fire("pre_claim", d.tid)
    try_bulk = getattr(eng.locks, "try_lock_bulk", None)
    if try_bulk is not None and len(d.write_map) >= bm:
        claimed = try_bulk(addr_lock_indices(eng, d.write_map), d.tid)
        if claimed is None:
            eng.abort_txn(d)
        locked = claimed.tolist()
    else:
        locked: List[int] = []
        for addr in d.write_map:
            idx = eng.locks.index(addr)
            st = eng.locks.read(idx)
            if not eng.locks.try_lock(idx, st, d.tid):
                release_locks(eng, locked)
                eng.abort_txn(d)
            if idx not in locked:
                locked.append(idx)
    if FP.ACTIVE is not None:
        try:
            FP.fire("post_claim", d.tid)
        except BaseException as e:
            # an injected recoverable error must not leak the claim the
            # caller never saw; a simulated crash must leave it held
            if not FP.is_simulated_crash(e):
                release_locks(eng, locked)
            raise
    return locked


def write_back(eng, d, bulk_min: Optional[int] = None) -> None:
    """Publish buffered writes to the heap (caller holds the locks):
    one in-place heap scatter at write sets >= ``bulk_min`` (write maps
    are dict-keyed, so the addresses are unique), the scalar store loop
    below it."""
    bm = BULK_MIN if bulk_min is None else bulk_min
    wm = d.write_map
    if FP.ACTIVE is not None:
        FP.fire("pre_scatter", d.tid)
    if d.wal_lsn is None:
        wal_log_prepare(eng, d)
    # commit record: from here the decision is publish
    wal_log_decide(eng, d)
    d.publish_started = True
    if len(wm) >= bm and getattr(eng.heap, "scatter", None) is not None:
        addrs = np.fromiter(wm.keys(), np.int64, len(wm))
        heap_scatter(eng.heap, addrs, list(wm.values()), tid=d.tid)
        if FP.ACTIVE is not None:
            FP.fire("post_scatter", d.tid)
        return
    if FP.ACTIVE is not None and len(wm) > 1:
        # same partial-lane split as heap_scatter, for the scalar path
        items = list(wm.items())
        h = len(items) // 2
        for addr, value in items[:h]:
            eng.heap[addr] = value
        FP.fire("mid_scatter", d.tid)
        for addr, value in items[h:]:
            eng.heap[addr] = value
        FP.fire("post_scatter", d.tid)
        return
    for addr, value in wm.items():
        eng.heap[addr] = value
    if FP.ACTIVE is not None:
        FP.fire("post_scatter", d.tid)


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
