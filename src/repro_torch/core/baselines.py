"""Baseline STMs the paper compares against (SS5/SS6), as ``TMPolicy``s.

  TL2     — commit-time locking, buffered writes, GV-style global clock.
  DCTL    — encounter-time locking, in-place writes, deferred clock
            (incremented by aborts), irrevocable fallback after N aborts.
  NOrec   — single global seqlock, buffered writes, value validation.
  TinySTM — encounter-time locking + snapshot (timestamp) extension.

Each baseline is a policy object over ``repro_torch.core.engine`` — the shared
``TransactionEngine`` owns the heap, clock, lock table, descriptors and
abort/alloc bookkeeping, so what remains here is exactly the algorithmic
difference: the read/write access rules and the commit pipeline.  All
read-set revalidation routes through ``engine.revalidate`` (scalar loop
below ``BULK_MIN`` reads, one lock-word gather plus the ``validate``
kernel above it).  On an array heap the heap and lock words live on the
engine's device (``device=``, ``None`` = the card); buffered write maps
and value logs hold host Python values, so a tensor write batch comes
back to the host once (``commit.as_value_list``).

None of these keep versions: a long read-only transaction aborts whenever
a concurrent commit advances a lock version past its read clock — the
behavior Multiverse's versioned path removes (paper Figs. 1/6/7).
"""
from __future__ import annotations

import threading
import time
from typing import Any

import torch

from repro_torch.core.clock import AtomicInt
from repro_torch.core.engine import (
    PolicyBase,
    TransactionEngine,
    V_EQ,
    V_LE,
    V_LT,
)
from repro_torch.core.engine import bulkread as B
from repro_torch.core.engine import commit as C
from repro_torch.core.engine import validation as V
from repro_torch.reliability import faultpoints as FP


# ---------------------------------------------------------------------------
# TL2
# ---------------------------------------------------------------------------


class TL2Policy(PolicyBase):
    """Deferred (commit-time) locking, buffered writes, GV4-style clock."""

    name = "tl2"
    validate_mode = V_LE
    group_commit = "buffered"     # CommitBatcher: claim+validate+scatter+stamp

    def read(self, eng, d, addr: int) -> Any:
        if addr in d.write_map:
            return d.write_map[addr]
        idx = eng.locks.index(addr)
        st1 = eng.locks.read(idx)
        data = eng.heap[addr]
        st2 = eng.locks.read(idx)
        if st1.locked or st2.locked or st1.version != st2.version or \
                st1.version > d.r_clock:
            eng.abort_txn(d)
        d.read_set.append((idx, st1.version))
        return data

    def read_bulk(self, eng, d, addrs) -> Any:
        # buffered writes make the overlay ambiguous — the rare
        # read-own-writes batch takes the exact scalar loop instead
        if d.write_map:
            return [self.read(eng, d, int(a)) for a in addrs]
        vals, ok, _ = B.bulk_read_lockver(eng, d, addrs, inclusive=True)
        return B.finish_with_scalar(eng, d, addrs, vals, ok, self.read)

    def write(self, eng, d, addr: int, value: Any) -> None:
        d.read_only = False
        d.write_map[addr] = value

    def write_bulk(self, eng, d, addrs, values) -> None:
        d.read_only = False
        d.write_map.update(zip((int(a) for a in addrs),
                               C.as_value_list(values)))

    def commit_update(self, eng, d) -> None:
        locked = C.acquire_write_locks(eng, d)    # aborts on conflict
        try:
            # inside the guard: an injected FaultError here must release
            # the claim like any other mid-commit exception
            if FP.ACTIVE is not None:
                FP.fire("pre_clock_tick", d.tid)
            wv = eng.clock.increment()            # GV4-ish: one fetch-add
            if not eng.revalidate(d):
                eng.abort_txn(d)
            C.write_back(eng, d)
            if FP.ACTIVE is not None:
                FP.fire("pre_release", d.tid)
            C.release_locks(eng, locked, wv)
            locked.clear()
        except BaseException as e:
            # abort or ANY mid-commit exception: commit-time locks are
            # invisible to rollback (TL2 holds none at encounter time),
            # so they must be released here or they leak forever — EXCEPT
            # a simulated crash, which must leave the crash image (held
            # locks, partial heap) intact for recovery to find
            if not FP.is_simulated_crash(e):
                if d.publish_started:
                    # the commit record is written and the buffered data
                    # already scattered (no undo exists to take it back):
                    # the decision stands, so finish publication at wv
                    # before letting the fault propagate
                    C.release_locks(eng, locked, wv)
                    d.stats["commits"] += 1
                    d.active = False
                    self.on_finish(eng, d)
                else:
                    C.release_locks(eng, locked)
            raise


# ---------------------------------------------------------------------------
# DCTL
# ---------------------------------------------------------------------------


class DCTLPolicy(PolicyBase):
    """Encounter-time locking, in-place writes, deferred clock (bumped on
    abort), single-token irrevocable mode after ``irrevocable_after``
    aborts (the paper uses 100)."""

    name = "dctl"
    validate_mode = V_LT
    group_commit = "encounter"    # CommitBatcher: fused validate + release

    def __init__(self, irrevocable_after: int = 100):
        self.irrevocable_after = irrevocable_after
        self._irrevocable_token = threading.Lock()

    def on_begin(self, eng, d) -> None:
        if d.attempts >= self.irrevocable_after and not d.irrevocable:
            self._irrevocable_token.acquire()
            d.irrevocable = True
        d.r_clock = eng.clock.load()

    def read(self, eng, d, addr: int) -> Any:
        idx = eng.locks.index(addr)
        if addr in d.undo or (d.irrevocable and self._lock_for(eng, d, idx)):
            return eng.heap[addr]
        data = eng.heap[addr]
        st = eng.locks.read(idx)
        if not eng.locks.validate(st, d.r_clock, d.tid):
            eng.abort_txn(d)
        d.read_set.append((idx, st.version))
        return data

    def read_bulk(self, eng, d, addrs) -> Any:
        # irrevocable transactions lock even their reads — scalar only
        if d.irrevocable:
            return [self.read(eng, d, int(a)) for a in addrs]
        vals, ok, _ = B.bulk_read_lockver(eng, d, addrs, inclusive=False)
        return B.finish_with_scalar(eng, d, addrs, vals, ok, self.read)

    def _lock_for(self, eng, d, idx: int) -> bool:
        """Irrevocable path: claim locks even for reads; spin, never abort."""
        while True:
            st = eng.locks.read(idx)
            if st.locked and st.tid == d.tid:
                return True
            if not st.locked and eng.locks.try_lock(idx, st, d.tid):
                d.locked_idxs.add(idx)           # remember to release
                return True

    def write(self, eng, d, addr: int, value: Any) -> None:
        d.read_only = False
        idx = eng.locks.index(addr)
        if d.irrevocable:
            self._lock_for(eng, d, idx)
        else:
            st = eng.locks.read(idx)
            if not eng.locks.validate(st, d.r_clock, d.tid):
                # version-blocked but conflict-free word: snapshot-extend
                # past the deferred clock instead of aborting (the abort
                # would replay to exactly this state — commit.py note)
                if st.locked or st.flag or not C.extend_snapshot(eng, d):
                    eng.abort_txn(d)
                st = eng.locks.read(idx)
                if not eng.locks.validate(st, d.r_clock, d.tid):
                    eng.abort_txn(d)
            if not eng.locks.try_lock(idx, st, d.tid):
                eng.abort_txn(d)
            d.locked_idxs.add(idx)
        if addr not in d.undo:
            d.undo[addr] = eng.heap[addr]
        eng.heap[addr] = value

    def write_bulk(self, eng, d, addrs, values) -> None:
        """Encounter-time batched write: validate + claim every lock in
        ONE ``try_lock_bulk`` sweep (version checked under the same
        stripes as the claim — the atomic validate-then-lock), then one
        undo gather and one heap scatter.  A conflicting batch aborts
        with NOTHING acquired or written, where the scalar loop would
        have locked and written a prefix first — the same end state
        (abort, deferred-clock bump) without the partial work to roll
        back.  Irrevocable transactions and sub-``BULK_MIN`` batches
        take the exact scalar loop.
        """
        from repro_torch.core.engine.validation import BULK_MIN
        try_bulk = getattr(eng.locks, "try_lock_bulk", None)
        if d.irrevocable or try_bulk is None or addrs.size < BULK_MIN:
            for a, v in zip(addrs, values):
                self.write(eng, d, int(a), v)
            return
        d.read_only = False
        addrs, values = C.dedup_last_wins(addrs, values)
        idxs = eng.locks.index_bulk(addrs)
        if FP.ACTIVE is not None:
            FP.fire("pre_claim", d.tid)
        new = try_bulk(idxs, d.tid, max_version=d.r_clock)
        if new is None:
            new = C.extend_and_relock(eng, d, idxs)
        if new is None:
            eng.abort_txn(d)
        d.locked_idxs.update(new.tolist())
        if FP.ACTIVE is not None:
            FP.fire("post_claim", d.tid)
        C.merge_undo(eng, d, addrs)
        if FP.ACTIVE is not None:
            FP.fire("pre_scatter", d.tid)
        C.heap_scatter(eng.heap, addrs, values, tid=d.tid)
        if FP.ACTIVE is not None:
            FP.fire("post_scatter", d.tid)

    def rollback(self, eng, d) -> None:
        C.rollback_inplace(eng, d)               # undo + deferred-clock bump

    def commit_update(self, eng, d) -> None:
        if not d.irrevocable and not eng.revalidate(d):
            eng.abort_txn(d)
        if FP.ACTIVE is not None:
            FP.fire("pre_clock_tick", d.tid)
        cv = eng.clock.load()
        # encounter-time commit record: the heap already holds the final
        # values, so past this point recovery rolls FORWARD (release at a
        # fresh tick) rather than restoring the undo log; the durable
        # DECIDE (redo image gathered from the locked heap words) lands
        # at the same instant
        C.wal_log_decide_encounter(eng, d)
        d.publish_started = True
        if FP.ACTIVE is not None:
            try:
                FP.fire("pre_release", d.tid)
            except BaseException as e:
                if not FP.is_simulated_crash(e):
                    # decided: an injected recoverable error cannot abort
                    # any more — finish the release so the outer abort
                    # path (a no-op on an inactive descriptor) cannot
                    # restore the undo log over committed data
                    C.release_locks(eng, d.locked_idxs, cv)
                    d.undo.clear()
                    d.stats["commits"] += 1
                    d.active = False
                    self.on_finish(eng, d)
                raise
        C.release_locks(eng, d.locked_idxs, cv)

    def on_finish(self, eng, d) -> None:
        if d.irrevocable:
            d.irrevocable = False
            self._irrevocable_token.release()
        d.attempts = 0


# ---------------------------------------------------------------------------
# NOrec
# ---------------------------------------------------------------------------


class NOrecPolicy(PolicyBase):
    """No ownership records: one global seqlock + value validation."""

    name = "norec"

    def __init__(self):
        self.seq = AtomicInt(0)

    # While a writer holds the seqlock (odd), a waiting thread yields the
    # interpreter lock: the writer's write-back on a tensor heap releases
    # it at every device operation, and a spin that kept it would hold it
    # for a whole switch interval before the writer could go on.  The
    # writer yields it too once it has released the seqlock (``_release``):
    # a scalar read keeps the lock (``ArrayHeap``), so a writer that went
    # straight on to its next transaction would take the seqlock again
    # before any waiter ran, and the waiters would only ever see it odd.
    def on_begin(self, eng, d) -> None:
        while True:
            s = self.seq.load()
            if s % 2 == 0:
                d.r_clock = s
                break
            time.sleep(0)

    def _validate_values(self, eng, d) -> int:
        while True:
            s = self.seq.load()
            if s % 2 == 1:
                time.sleep(0)
                continue
            if not V.validate_values(eng.heap, d.read_vals):
                eng.abort_txn(d)
            if self.seq.load() == s:
                return s

    def read(self, eng, d, addr: int) -> Any:
        if addr in d.write_map:
            return d.write_map[addr]
        val = eng.heap[addr]
        while self.seq.load() != d.r_clock:
            d.r_clock = self._validate_values(eng, d)
            val = eng.heap[addr]
        d.read_vals.append((addr, val))
        return val

    def read_bulk(self, eng, d, addrs) -> Any:
        """Batched NOrec read: gather under an unchanged seqlock.

        The scalar read's invariant — "value observed while ``seq`` was
        even and equal to ``r_clock``" — holds for the whole batch when
        the seqlock is unchanged across the gather (writers bump it odd
        before touching the heap), so one gather + two seq loads replace
        N validate-and-reread loops.
        """
        if d.write_map:
            return [self.read(eng, d, int(a)) for a in addrs]
        while True:
            if self.seq.load() != d.r_clock:
                d.r_clock = self._validate_values(eng, d)
            vals = B.heap_gather(eng.heap, addrs)
            if self.seq.load() == d.r_clock:
                break
        # the value log keeps host values: one copy of the batch back
        host = vals.tolist() if isinstance(vals, torch.Tensor) else vals
        pairs = zip((int(a) for a in addrs), host)
        if d.dedup_read_set:
            # traversal dedup, value-log flavor: within one NOrec txn an
            # address's observed value can never legally change (value
            # validation would have aborted), so keeping the first
            # (addr, value) entry is exact
            seen = d.read_set_seen
            rv = d.read_vals
            for p in pairs:
                if p[0] not in seen:
                    seen.add(p[0])
                    rv.append(p)
        else:
            d.read_vals.extend(pairs)
        return vals

    def write(self, eng, d, addr: int, value: Any) -> None:
        d.read_only = False
        d.write_map[addr] = value

    def write_bulk(self, eng, d, addrs, values) -> None:
        d.read_only = False
        d.write_map.update(zip((int(a) for a in addrs),
                               C.as_value_list(values)))

    def commit_update(self, eng, d) -> None:
        while True:
            s = d.r_clock
            if self.seq.cas(s, s + 1):
                break
            d.r_clock = self._validate_values(eng, d)
        if not V.validate_values(eng.heap, d.read_vals):
            self._release(s)
            eng.abort_txn(d)
        C.write_back(eng, d)
        self._release(s)

    def _release(self, s: int) -> None:
        self.seq.store(s + 2)
        time.sleep(0)

    def validate(self, eng, d) -> bool:
        return V.validate_values(eng.heap, d.read_vals)


# ---------------------------------------------------------------------------
# TinySTM (encounter-time locking + snapshot extension)
# ---------------------------------------------------------------------------


class TinySTMPolicy(DCTLPolicy):
    """TinySTM-style: DCTL's ETL write path, but the clock advances on every
    commit and readers EXTEND their snapshot instead of aborting when they
    hit a newer-but-consistent version."""

    name = "tinystm"
    validate_mode = V_EQ

    def __init__(self):
        super().__init__(irrevocable_after=1 << 30)  # no irrevocable mode

    def read(self, eng, d, addr: int) -> Any:
        if addr in d.undo:
            return eng.heap[addr]
        idx = eng.locks.index(addr)
        while True:
            st = eng.locks.read(idx)
            if st.locked:
                if st.tid != d.tid:
                    eng.abort_txn(d)
                # lock held by THIS txn (a written address sharing the
                # lock index): the word is stable under our own lock —
                # spinning on it would self-livelock forever.  V_EQ
                # revalidation passes while we still hold it.
                d.read_set.append((idx, st.version))
                return eng.heap[addr]
            data = eng.heap[addr]
            st2 = eng.locks.read(idx)
            if st2.locked or st2.version != st.version:
                continue                      # raced a writer: reread
            if st.version > d.r_clock:
                # snapshot extension: revalidate at the new clock, then
                # loop to re-read the value under the extended snapshot
                now = eng.clock.load()
                if not eng.revalidate(d):
                    eng.abort_txn(d)
                d.r_clock = now
                continue
            d.read_set.append((idx, st.version))
            return data

    def read_bulk(self, eng, d, addrs) -> Any:
        # commit-bumped clock: versions AT r_clock are still consistent;
        # entries needing snapshot extension fall back to the scalar read
        vals, ok, _ = B.bulk_read_lockver(eng, d, addrs, inclusive=True)
        return B.finish_with_scalar(eng, d, addrs, vals, ok, self.read)

    def commit_update(self, eng, d) -> None:
        if not eng.revalidate(d):
            eng.abort_txn(d)
        if FP.ACTIVE is not None:
            FP.fire("pre_clock_tick", d.tid)
        wv = eng.clock.increment()
        C.wal_log_decide_encounter(eng, d)
        d.publish_started = True
        if FP.ACTIVE is not None:
            try:
                FP.fire("pre_release", d.tid)
            except BaseException as e:
                if not FP.is_simulated_crash(e):
                    # decided: roll forward (see DCTL.commit_update)
                    C.release_locks(eng, d.locked_idxs, wv)
                    d.undo.clear()
                    d.stats["commits"] += 1
                    d.active = False
                    self.on_finish(eng, d)
                raise
        C.release_locks(eng, d.locked_idxs, wv)


# ---------------------------------------------------------------------------
# engine-backed classes (``device=None`` puts the lock table — and an
# array heap passed in — on the card)
# ---------------------------------------------------------------------------


class TL2(TransactionEngine):
    def __init__(self, n_threads: int, lock_bits: int = 16, heap=None,
                 device=None):
        super().__init__(TL2Policy(), n_threads, lock_bits=lock_bits,
                         heap=heap, device=device)
        self.name = type(self).__name__


class DCTL(TransactionEngine):
    def __init__(self, n_threads: int, lock_bits: int = 16,
                 irrevocable_after: int = 100, heap=None, device=None):
        super().__init__(DCTLPolicy(irrevocable_after), n_threads,
                         lock_bits=lock_bits, heap=heap, device=device)
        self.name = type(self).__name__


class NOrec(TransactionEngine):
    def __init__(self, n_threads: int, lock_bits: int = 16, heap=None,
                 device=None):
        super().__init__(NOrecPolicy(), n_threads, lock_bits=lock_bits,
                         heap=heap, device=device)
        self.name = type(self).__name__

    @property
    def seq(self) -> AtomicInt:
        return self.policy.seq


class TinySTM(TransactionEngine):
    def __init__(self, n_threads: int, lock_bits: int = 16, heap=None,
                 device=None):
        super().__init__(TinySTMPolicy(), n_threads, lock_bits=lock_bits,
                         heap=heap, device=device)
        self.name = type(self).__name__


BASELINES = {"tl2": TL2, "dctl": DCTL, "norec": NOrec, "tinystm": TinySTM}
POLICIES = {"tl2": TL2Policy, "dctl": DCTLPolicy, "norec": NOrecPolicy,
            "tinystm": TinySTMPolicy}
