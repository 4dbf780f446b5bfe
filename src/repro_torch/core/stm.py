"""Multiverse STM — the paper's Algorithms 1-5 as a ``TMPolicy``.

Word-based opaque STM with dynamic multiversioning:
  * unversioned path: DCTL-style (global clock, versioned locks,
    encounter-time locking, in-place writes, commit-time read revalidation,
    clock incremented by aborts);
  * versioned read-only path: version-list traversal with TBD blocking and
    deleted timestamps;
  * four TM modes on a monotone counter (Q, QtoU, U, UtoQ) with the
    Q->QtoU CAS open to workers and all other transitions centralized in
    the background thread, which also unversions VLT buckets in Mode Q
    using the L/P commit-delta heuristic and drives EBR.

The begin/read/write/commit scaffolding lives in
``repro_torch.core.engine`` — this module contains only what makes
Multiverse Multiverse (``MultiversePolicy``), plus the ``Multiverse``
engine subclass that exposes the attribute surface (``tm.vlt``,
``tm.mode_counter``, ``tm.announce``, ...) instrumentation relies on.
Commit-time read-set revalidation routes through ``engine.revalidate``,
which switches to the ``validate`` kernel for large read sets.

The heap, lock words and version mirror are device tensors; version
lists, bloom filters, EBR, announcements, the clocks and the mode
machine stay host Python objects, as in the reference.

The user API is ``repro_torch.api`` (``run``/``@atomic``/``tm.txn()``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.paper_stm import MultiverseParams
from repro_torch.core import heuristics as heur
from repro_torch.core import modes as M
from repro_torch.core.bloom import BloomTable
from repro_torch.core.clock import AtomicInt
from repro_torch.core.engine import bulkread as B
from repro_torch.core.engine import commit as C
from repro_torch.core.ebr import EBR, TxRetireBuffer
from repro_torch.core.engine import (
    AbortTx,
    BULK_MIN,
    MaxRetriesExceeded,
    PolicyBase,
    TMBase,
    TransactionEngine,
)
from repro_torch.core.vlt import DELETED_TS, VLT, VersionList, VListNode
from repro_torch.kernels._lib import to_device, to_host
from repro_torch.reliability import faultpoints as FP

__all__ = ["AbortTx", "MaxRetriesExceeded", "Multiverse",
           "MultiversePolicy", "TMBase"]


def _host_values(values):
    """Write values for the word-at-a-time loops: a tensor comes back
    to the host once as Python ints (so version lists and the mirror
    see plain ints), anything else passes through."""
    return values.tolist() if isinstance(values, torch.Tensor) else values


class MultiversePolicy(PolicyBase):
    name = "multiverse"

    def __init__(self, params: Optional[MultiverseParams] = None,
                 start_bg: bool = True):
        self.params = params or MultiverseParams()
        self._start_bg = start_bg

    # ------------------------------------------------------------------
    # engine wiring
    # ------------------------------------------------------------------
    def setup(self, eng) -> None:
        bits = self.params.lock_table_bits
        self.bloom = BloomTable(bits, self.params.bloom_bits)
        self.vlt = VLT(bits, device=eng.device)
        self.mode_counter = AtomicInt(0)         # mode = counter & 3
        self.first_obs_mode_u_ts = AtomicInt(-1)
        self.min_mode_u_reads = heur.MinModeUReadCount()
        self.ebr = EBR(eng.n_threads)
        self.announce = [heur.ThreadAnnouncement()
                         for _ in range(eng.n_threads)]
        self.unversion_heur = heur.UnversionThreshold(self.params)
        self._retire_bufs = [TxRetireBuffer(self.ebr)
                             for _ in range(eng.n_threads)]
        self.stats_unversioned_buckets = 0
        self.stats_mode_transitions = 0
        self.stats_version_gather_hits = 0   # words resolved by the
        #                                      packed-VLT bulk gather
        self._stop = threading.Event()
        self._bg: Optional[threading.Thread] = None
        if self._start_bg:
            self._bg = threading.Thread(target=self._bg_thread,
                                        args=(eng,), daemon=True)
            self._bg.start()

    # ------------------------------------------------------------------
    # transaction lifecycle (Alg. 1)
    # ------------------------------------------------------------------
    def on_begin(self, eng, d) -> None:
        ann = self.announce[d.tid]
        # announce-then-verify: publish (counter, active) BEFORE trusting
        # the counter, else the background thread can advance the mode in
        # the window between our load and our announcement and a local-
        # Mode-Q writer would run unversioned under global Mode U —
        # breaking the invariant Mode-U readers rely on (paper SS3.4 fn.1).
        while True:
            cnt = self.mode_counter.load()
            d.local_mode_counter = cnt
            ann.local_mode_counter = cnt
            d.active = True
            if self.mode_counter.load() == cnt:
                break
            d.active = False
        d.local_mode = M.get_mode(cnt)
        d.r_clock = eng.clock.load()
        if d.versioned and d.initial_versioned_ts is None:
            d.initial_versioned_ts = d.r_clock
        ann.active_versioned = d.versioned
        self.ebr.pin(d.tid)

    def commit_read_only(self, eng, d) -> None:
        ann = self.announce[d.tid]
        if d.versioned:
            delta = eng.clock.load() - (d.initial_versioned_ts or 0)
            ann.commit_ts_delta = delta
            if d.local_mode == M.MODE_U:
                self.min_mode_u_reads.update(d.read_cnt)
            d.stats["versioned_commits"] += 1
        if ann.sticky_mode_u and heur.sticky_cleared(
                self.params, ann, d.read_cnt):
            ann.sticky_mode_u = False

    def commit_update(self, eng, d) -> None:
        # revalidate the read set: scalar loop for small read sets, the
        # vectorized bulk path (one lock-table gather) for large ones
        if not eng.revalidate(d):
            eng.abort_txn(d)
        if FP.ACTIVE is not None:
            FP.fire("pre_clock_tick", d.tid)
        commit_clock = eng.clock.load()
        # commit record: versioned readers can observe cleared-TBD
        # versions the instant _publish_versions runs, and the in-place
        # heap already holds the final values — from here a crash must
        # roll FORWARD (finish publish + release), never back; the
        # durable DECIDE lands at the same instant
        C.wal_log_decide_encounter(eng, d)
        d.publish_started = True
        if d.versioned_write_set:
            self._publish_versions(eng, d, commit_clock)
        if FP.ACTIVE is not None:
            try:
                FP.fire("pre_release", d.tid)
            except BaseException as e:
                if not FP.is_simulated_crash(e):
                    # decided: versions are published, so an injected
                    # recoverable error must complete the commit — an
                    # undo-log rollback here would fork heap vs. VLT
                    C.release_locks(eng, d.locked_idxs, commit_clock)
                    self._retire_bufs[d.tid].commit()
                    d.undo.clear()
                    d.versioned_write_set.clear()
                    d.stats["commits"] += 1
                    d.active = False
                    self.on_finish(eng, d)
                raise
        # release write locks at the commit clock: the DEDUPED index set
        # both write paths maintain (two addresses colliding into one
        # lock word must release it exactly once — a second per-address
        # unlock could stomp a lock another writer claimed in between),
        # one bulk sweep at large write sets (engine/commit.py
        # normalization note)
        C.release_locks(eng, d.locked_idxs, commit_clock)
        self._retire_bufs[d.tid].commit()

    def _publish_versions(self, eng, d, commit_clock: int) -> None:
        """Remove TBD marks (publishing versions at the commit clock) and
        refresh the packed-VLT mirror while the address locks are still
        held (the mirror's writer discipline).  Large versioned write
        sets refresh the mirror in ONE ``publish_bulk`` sweep — per
        unique row a single seqlock bracket around a vectorized slot
        shift — instead of a per-address publish dance."""
        vws = d.versioned_write_set
        for addr, (vlist, node) in vws.items():
            node.timestamp = commit_clock
            node.tbd = False
        if len(vws) >= BULK_MIN and \
                getattr(eng.locks, "index_bulk", None) is not None:
            addrs = np.fromiter(vws.keys(), np.int64, len(vws))
            self.vlt.mirror.publish_bulk(
                eng.locks.index_bulk(addrs), addrs, commit_clock,
                [node.data for (_vl, node) in vws.values()])
        else:
            for addr, (vlist, node) in vws.items():
                self.vlt.mirror.publish(eng.locks.index(addr), addr,
                                        commit_clock, node.data)

    def on_finish(self, eng, d) -> None:
        d.attempts = 0
        d.versioned = False
        d.initial_versioned_ts = None
        self.ebr.unpin(d.tid)

    def rollback(self, eng, d) -> None:
        # roll back versioned writes: deleted timestamp, UNLINK, retire.
        # We hold the address lock, and our node is necessarily still the
        # head (no one else can prepend), so unlinking is safe; without it
        # a reader pinned AFTER the grace period could still walk through
        # the freed node — a real use-after-free caught by the poison-bit
        # assertions (EXPERIMENTS.md SSDeviations).
        buf = self._retire_bufs[d.tid]
        for addr, (vlist, node) in d.versioned_write_set.items():
            node.timestamp = DELETED_TS
            node.tbd = False
            if vlist.head is node:
                vlist.head = node.older
            buf.retire_on_abort(node)
        buf.abort()
        # then the in-place writes: the shared encounter-time rollback —
        # one heap scatter at large undo logs, deduped-index release at
        # the bumped (deferred-clock) abort version
        C.rollback_inplace(eng, d)

    def on_abort(self, eng, d) -> None:
        if d.read_only:
            if heur.should_attempt_mode_cas(
                    self.params, versioned=d.versioned,
                    attempts=d.attempts, read_cnt=d.read_cnt,
                    min_mode_u_reads=self.min_mode_u_reads.get()):
                self._attempt_mode_cas(d)
            if not d.versioned and not d.no_versioning and \
                    heur.should_go_versioned(self.params, d.attempts):
                d.versioned = True
        d.attempts += 1
        self.ebr.unpin(d.tid)

    def on_retries_exhausted(self, eng, tid: int) -> None:
        # a capped operation must leave nothing behind: flush the retire
        # buffer (revoking commit-conditional retires, landing the abort-
        # conditional ones in EBR limbo) and make sure the thread is
        # unpinned so reclamation cannot stall on a dead transaction
        self._retire_bufs[tid].abort()
        self.ebr.unpin(tid)

    def _attempt_mode_cas(self, d) -> None:
        """Any local-Mode-Q txn may CAS Q -> QtoU (SS3.3.1)."""
        cnt = self.mode_counter.load()
        if M.get_mode(cnt) == M.MODE_Q:
            self.announce[d.tid].sticky_mode_u = True
            self.announce[d.tid].small_txn_read_cnt = None
            if self.mode_counter.cas(cnt, cnt + 1):
                d.stats["mode_cas"] += 1
                self.stats_mode_transitions += 1

    # ------------------------------------------------------------------
    # TM accesses (Alg. 3 / Alg. 4)
    # ------------------------------------------------------------------
    def write(self, eng, d, addr: int, value: Any) -> None:
        if d.versioned:
            # Only read-only transactions can be versioned (paper SS3.2.2).
            # A versioned txn that turns out to write must restart on the
            # unversioned path: its versioned reads were of the PAST and
            # cannot anchor writes to the present (mixing them is the
            # SI-writer path of SS3.5, which must be explicitly requested).
            # no_versioning is STICKY for this operation — otherwise the K1
            # heuristic re-promotes on the next abort and the write aborts
            # it again, forever (livelock).
            d.versioned = False
            d.no_versioning = True
            d.initial_versioned_ts = None
            eng.abort_txn(d)
        d.read_only = False
        idx = eng.locks.index(addr)
        st = eng.locks.read_wait_unflagged(idx)
        if not eng.locks.validate(st, d.r_clock, d.tid):
            # version-blocked but conflict-free word: snapshot-extend
            # past the deferred clock instead of aborting (the abort
            # would replay to exactly this state — commit.py note)
            if st.locked or not C.extend_snapshot(eng, d):
                eng.abort_txn(d)
            st = eng.locks.read_wait_unflagged(idx)
            if not eng.locks.validate(st, d.r_clock, d.tid):
                eng.abort_txn(d)
        if not eng.locks.try_lock(idx, st, d.tid):
            eng.abort_txn(d)
        d.locked_idxs.add(idx)
        if addr not in d.undo:
            d.undo[addr] = eng.heap[addr]
        # ORDER MATTERS (paper SS4.1 TEXT, not Alg. 3's line order): the
        # versioned write must complete BEFORE the in-place write.  Mode-U
        # readers of an unversioned address use the lock-freeze protocol,
        # whose safety argument is "a writer holding the lock would have
        # versioned the address [before changing the data]" — with the
        # pseudocode's in-place-first order there is a window where the
        # lock is held, the bloom filter still misses, and the heap already
        # holds the uncommitted value: a reader returns a torn read.  We
        # hit this as a real ~1-in-20s tear (EXPERIMENTS.md SSDeviations).
        if d.local_mode == M.MODE_Q:
            self._try_write_to_vlist(eng, d, addr, idx, value)
        else:
            # Modes QtoU / U / UtoQ: writers must version (Table 1)
            vlist = self._get_vlist(idx, addr)
            if vlist is None:
                ts = self.first_obs_mode_u_ts.load()
                if ts < 0:
                    ts = st.version
                node = VListNode(None, ts, d.undo[addr], False)
                vlist = VersionList(node)
                self.vlt.insert(idx, addr, vlist)
                self.bloom.add(idx, addr)
            self._append_version(d, addr, vlist, value)
        eng.heap[addr] = value                    # in-place (encounter-time)

    def write_bulk(self, eng, d, addrs, values) -> None:
        """Batched encounter-time write for the Mode-Q unversioned case.

        One ``try_lock_bulk`` sweep (validate + claim, atomic under the
        stripes), one undo gather, one heap scatter — the update-heavy
        hot path the paper's SS5 throughput comparison measures.  The
        batch only stays batched when NO claimed bucket holds a version
        list: our locks freeze those buckets (versioning an address
        requires its lock), so bucket-empty checked after the sweep is
        exact, and skipping the per-address version logic is then the
        same decision the scalar Mode-Q write makes on a bloom miss.
        The paper's version-before-in-place ordering (SS4.1) is not in
        play here: lock-freeze readers only exist in Mode U, and the
        mode machinery never overlaps a Mode-U reader with a local-
        Mode-Q writer (QtoU waits for us).  Everything else — versioned
        modes, version-list buckets, flagged/conflicted batches,
        sub-``BULK_MIN`` batches — takes the exact scalar loop.
        """
        if addrs.size == 0:
            return
        if d.versioned:
            self.write(eng, d, int(addrs[0]), values[0])  # restart path
        try_bulk = getattr(eng.locks, "try_lock_bulk", None)
        if d.local_mode != M.MODE_Q or try_bulk is None or \
                addrs.size < BULK_MIN:
            for a, v in zip(addrs, _host_values(values)):
                self.write(eng, d, int(a), v)
            return
        d.read_only = False
        addrs, values = C.dedup_last_wins(addrs, values)
        idxs = eng.locks.index_bulk(addrs)
        if FP.ACTIVE is not None:
            FP.fire("pre_claim", d.tid)
        new = try_bulk(idxs, d.tid, max_version=d.r_clock)
        if new is None:
            # version-blocked but conflict-free batch: snapshot-extend
            # past the deferred clock instead of aborting (the abort
            # would replay to exactly this state — commit.py note)
            new = C.extend_and_relock(eng, d, idxs)
        if new is None:
            # a FLAG means a Mode-Q reader is mid-versioning and the
            # scalar loop's wait-on-flag owns that window; any other
            # conflict (foreign lock, stale version with a stale read
            # set) aborts the scalar write too — skip straight to the
            # abort instead of replaying the batch word by word
            _, _, meta = eng.locks.gather(idxs)
            if bool(((meta & 2) != 0).any()):
                for a, v in zip(addrs, _host_values(values)):
                    self.write(eng, d, int(a), v)
                return
            eng.abort_txn(d)
        if self.vlt.nonempty_count and any(
                self.vlt._buckets[int(i)] is not None
                for i in np.unique(idxs)):
            # a claimed bucket holds version lists: unwind OUR new claims
            # (never locks earlier writes hold) and take the per-address
            # version-append path
            eng.locks.unlock_bulk(new)
            for a, v in zip(addrs, _host_values(values)):
                self.write(eng, d, int(a), v)
            return
        d.locked_idxs.update(new.tolist())
        if FP.ACTIVE is not None:
            FP.fire("post_claim", d.tid)
        C.merge_undo(eng, d, addrs)
        if FP.ACTIVE is not None:
            FP.fire("pre_scatter", d.tid)
        C.heap_scatter(eng.heap, addrs, values, tid=d.tid)
        if FP.ACTIVE is not None:
            FP.fire("post_scatter", d.tid)

    def _get_vlist(self, idx: int, addr: int) -> Optional[VersionList]:
        if not self.bloom.contains(idx, addr):
            return None
        return self.vlt.get(idx, addr)

    def _try_write_to_vlist(self, eng, d, addr, idx, value) -> None:
        """Mode Q: add a version iff the address is already versioned."""
        vlist = self._get_vlist(idx, addr)
        if vlist is None:
            return
        self._append_version(d, addr, vlist, value)

    def _append_version(self, d, addr, vlist, value) -> None:
        head = vlist.head
        if head is not None and head.tbd and addr in d.versioned_write_set:
            head.data = value                     # our own TBD: update it
            return
        node = VListNode(head, d.r_clock, value, True)
        vlist.head = node
        d.versioned_write_set[addr] = (vlist, node)
        if head is not None:
            # previous version retired iff we commit (eventualFree)
            self._retire_bufs[d.tid].retire_on_commit(head)

    def read_bulk(self, eng, d, addrs) -> Any:
        """Batched read on BOTH of the paper's read paths.

        Unversioned: the shared lock-version batch (one heap gather
        bracketed by two lock-word gathers, V_LT predicate); failures
        re-read scalar, which spins/aborts exactly like a scalar loop.

        Versioned: the same batch WITHOUT read-set tracking — an element
        that is unlocked, unflagged and stable at ``version < r_clock``
        holds precisely its value as of the reader's snapshot, no version
        list needed.  A Mode-U reader also accepts every UNVERSIONED
        element that was free and unchanged across the two lock gathers,
        whatever its version (``_bulk_lock_freeze``).  Then the
        recently-written minority (version at or past the snapshot,
        locked, or mid-versioning) resolves through ONE gather of the
        packed VLT mirror (`PackedVLT.gather`: the newest committed
        version strictly below the snapshot, the `version_select` kernel
        on the device), and only what the mirror cannot represent
        (colliding buckets, torn rows, versions deeper than the mirror)
        walks the version lists through the mode's scalar read.  This is
        what makes the paper's long-running read an array operation end
        to end: the stable majority moves in the heap gather, the
        written minority in the mirror gather, and the scalar walk
        handles a residue that is empty in the common case.
        """
        if not d.versioned:
            vals, ok, _ = B.bulk_read_lockver(eng, d, addrs,
                                              inclusive=False)
            return B.finish_with_scalar(eng, d, addrs, vals, ok, self.read)
        idxs, idx_dev, words, vals = B.gather_lockver(eng, addrs)
        # the mirror rows are gathered right behind the post-gather,
        # which is the lock gate they need (_bulk_versioned_gather);
        # lock words and rows come back in one copy
        rows = self.vlt.mirror.gather(idx_dev, d.r_clock)
        words, *rows = to_host([words, *rows])
        ok, frozen = B.lockver_verdict(eng, d, addrs, idxs, words,
                                       inclusive=False, track=False)
        if d.local_mode == M.MODE_U:
            ok = self._bulk_lock_freeze(addrs, idxs, ok, frozen)
        vals, ok = self._bulk_versioned_gather(eng, addrs, vals, ok,
                                               words[1], rows)
        scalar = (self._mode_u_versioned_read if d.local_mode == M.MODE_U
                  else self._mode_q_versioned_read)
        return B.finish_with_scalar(eng, d, addrs, vals, ok, scalar)

    def _bulk_lock_freeze(self, addrs, idxs, ok, frozen):
        """The Mode-U lock-freeze read (paper SS4.2,
        ``_mode_u_versioned_read``) over a whole batch.

        In Mode U every writer versions an address before changing it,
        and no bucket is unversioned while a local-Mode-U reader is
        active, so an address the bloom filter does not hold has not
        been written since this reader's snapshot.  If its lock word was
        free, unflagged and unchanged across the batch's two gathers, the
        gathered value is that snapshot value — whatever the word's
        version, which a write to ANOTHER address of the same lock
        bucket may have bumped past ``r_clock``.  The scalar read accepts
        exactly these words after one lock/heap/lock round of its own;
        on the device that is three blocking reads per word, and with
        ~15 addresses per bucket at the paper's table size a long scan
        under updaters sends most of its chunks down that path.  Bloom
        false positives only send a word on to the mirror / scalar path.
        """
        cand = np.nonzero(~ok & frozen)[0]
        if cand.size == 0:
            return ok
        contains = self.bloom.contains
        unversioned = np.fromiter(
            (not contains(int(i), int(a))
             for i, a in zip(idxs[cand], addrs[cand])), bool, cand.size)
        ok[cand[unversioned]] = True
        return ok

    def _bulk_versioned_gather(self, eng, addrs, vals, ok, gate, rows):
        """Vectorized version-list resolution for a failed batch minority.

        Elements the lock-version predicate rejected are exactly the
        recently-written ones a versioned reader serves from version
        lists (paper SS4.2); the packed mirror rows (``rows``, from
        ``PackedVLT.gather``) answer them.  SOUNDNESS needs a lock gate
        in front of the row gather: a commit that could still land BELOW
        this snapshot (its commit clock was loaded before we began — the
        deferred clock can advance in between) holds its address locks
        for its entire version-publish window, so requiring the lock
        word to be free in a gather issued BEFORE the rows excludes every
        such in-flight commit.  The gate here is the batch's post-gather
        (``gate``, host lock words), issued after this reader began and
        right before the rows on the one stream.  A writer who takes the
        lock after the gate commits at/above our snapshot and is skipped
        by the strict ``ts < r_clock`` acceptance anyway, and an accepted
        row is a seqlock-stable snapshot of the address's newest
        committed versions, so acceptance equals the scalar traverse's
        result.  Unresolved elements keep ``ok=False`` and take the
        scalar walk.
        """
        if bool(ok.all()):
            return vals, ok
        bad = np.nonzero(~ok)[0]
        s1, s2, rows_addr, mvals, found = rows
        mvals, mok = self.vlt.mirror.resolve(
            s1[bad], s2[bad], rows_addr[bad], mvals[bad], found[bad],
            addrs[bad])
        _, _, meta = eng.locks.host_fields(gate[bad])
        mok &= (meta & 3) == 0             # unlocked AND unflagged
        hit = bad[mok]
        if hit.size == 0:
            return vals, ok
        self.stats_version_gather_hits += int(hit.size)
        picked = mvals[mok]
        if isinstance(vals, torch.Tensor):
            # the gathered batch is a fresh writable device tensor (the
            # reference had to copy its read-only kernel output here)
            put = to_device(np.stack((hit, picked)), vals.device)
            vals.index_put_((put[0],), put[1])
        else:
            for i, v in zip(hit.tolist(), picked.tolist()):
                vals[i] = v
        ok[hit] = True
        return vals, ok

    def read(self, eng, d, addr: int) -> Any:
        if d.versioned and d.local_mode in (M.MODE_Q, M.MODE_QTOU,
                                            M.MODE_UTOQ):
            return self._mode_q_versioned_read(eng, d, addr)
        if d.versioned and d.local_mode == M.MODE_U:
            return self._mode_u_versioned_read(eng, d, addr)
        # unversioned read
        idx = eng.locks.index(addr)
        if addr in d.undo:
            return eng.heap[addr]
        data = eng.heap[addr]
        st = eng.locks.read_wait_unflagged(idx)
        if not eng.locks.validate(st, d.r_clock, d.tid):
            eng.abort_txn(d)
        d.read_set.append((idx, st.version))
        return data

    # -- versioned reads ---------------------------------------------------
    def _traverse(self, eng, d, vlist: VersionList) -> Any:
        """Alg. 2 traverse: block on suitable TBD heads, skip deleted.

        Acceptance is STRICTLY ts < rClock (the paper writes <=; with the
        deferred clock several commits share one timestamp, so a reader at
        rclock c could otherwise see half of an in-flight commit whose
        commitClock also lands on c — mirroring validateLock's strict <
        restores opacity; DESIGN.md SS6)."""
        node = vlist.head
        while node is not None and node.tbd and node.timestamp < d.r_clock:
            node = vlist.head                     # reread head (spin)
        while node is not None and (node.timestamp >= d.r_clock
                                    or node.timestamp == DELETED_TS
                                    or node.tbd):
            assert not node.freed, "use-after-free: version node"
            node = node.older
        if node is None:
            eng.abort_txn(d)
        assert not node.freed, "use-after-free: version node"
        return node.data

    def _mode_q_versioned_read(self, eng, d, addr: int) -> Any:
        idx = eng.locks.index(addr)
        if not self.bloom.try_add(idx, addr):
            vlist = self.vlt.get(idx, addr)       # bloom hit (may be false+)
            if vlist is not None:
                return self._traverse(eng, d, vlist)
        return self._version_then_read(eng, d, addr, idx)

    def _version_then_read(self, eng, d, addr: int, idx: int) -> Any:
        """Mode-Q reader versions an unversioned address (SS4.1)."""
        st = eng.locks.lock_and_flag(idx, d.tid)
        try:
            # recheck: someone may have versioned it while we waited
            vlist = self.vlt.get(idx, addr)
            if vlist is None:
                data = eng.heap[addr]
                ts = self.first_obs_mode_u_ts.load()
                if ts < 0:
                    ts = st.version
                self.vlt.insert(idx, addr,
                                VersionList(VListNode(None, ts, data,
                                                      False)))
                self.bloom.add(idx, addr)
        finally:
            eng.locks.unlock(idx)
        if st.version >= d.r_clock:
            # the value we versioned was written at/after our snapshot
            eng.abort_txn(d)
        vlist = self.vlt.get(idx, addr)
        if vlist is not None:
            return self._traverse(eng, d, vlist)
        return eng.heap[addr]

    def _mode_u_versioned_read(self, eng, d, addr: int) -> Any:
        """SS4.2: unversioned addresses cannot have been written since the
        TM entered Mode U — read them with the lock-freeze protocol."""
        idx = eng.locks.index(addr)
        if self.bloom.contains(idx, addr):
            vlist = self.vlt.get(idx, addr)
            if vlist is not None:
                return self._traverse(eng, d, vlist)
        last_ver, last_val = -1, None
        while True:
            st = eng.locks.read(idx)
            if st.locked:
                # stable-value check by EQUALITY, not identity: ArrayHeap
                # returns a fresh int per read, so `is` would only ever
                # match CPython's small-int cache and the early return
                # would silently stop firing for values > 256
                cur = eng.heap[addr]
                if st.version == last_ver and cur == last_val:
                    return cur
                last_ver, last_val = st.version, cur
                # recheck versioned-ness: a writer holding the lock would
                # have versioned the address before changing it
                if self.bloom.contains(idx, addr):
                    vlist = self.vlt.get(idx, addr)
                    if vlist is not None:
                        return self._traverse(eng, d, vlist)
                continue
            data = eng.heap[addr]
            st2 = eng.locks.read(idx)
            if st2.version != st.version or st2.locked:
                if self.bloom.contains(idx, addr):
                    vlist = self.vlt.get(idx, addr)
                    if vlist is not None:
                        return self._traverse(eng, d, vlist)
                eng.abort_txn(d)
            return data

    # ------------------------------------------------------------------
    # background thread (Alg. 5)
    # ------------------------------------------------------------------
    def _wait_for_workers(self, eng, mode_counter: int) -> None:
        while not self._stop.is_set():
            found = False
            for t, ann in enumerate(self.announce):
                if ann.local_mode_counter < mode_counter and \
                        eng.ctx(t).active:
                    found = True
                    break
            if not found:
                return
            time.sleep(0.0005)

    def _any_sticky(self) -> bool:
        return any(a.sticky_mode_u for a in self.announce)

    def _transition(self, cur: int) -> int:
        new = cur + 1
        self.mode_counter.store(new)
        self.stats_mode_transitions += 1
        return new

    def _bg_thread(self, eng) -> None:
        poll = self.params.unversion_poll_ms / 1000.0
        while not self._stop.is_set():
            cnt = self.mode_counter.load()
            mode = M.get_mode(cnt)
            if mode == M.MODE_QTOU:
                self._wait_for_workers(eng, cnt)
                cnt = self._transition(cnt)          # -> U
                self.first_obs_mode_u_ts.store(eng.clock.load())
                # remain in U while sticky readers want it
                while self._any_sticky() and not self._stop.is_set():
                    time.sleep(poll)
                cnt = self._transition(cnt)          # -> UtoQ
                self._wait_for_workers(eng, cnt)
                self.first_obs_mode_u_ts.store(-1)
                cnt = self._transition(cnt)          # -> Q
            elif mode == M.MODE_Q:
                self._unversion_pass(eng)
                self.ebr.advance_and_reclaim()
                time.sleep(poll)
            else:  # recover if constructed mid-cycle
                time.sleep(poll)

    def _unversion_pass(self, eng) -> None:
        """SS4.4: unversion buckets whose newest version is older than the
        L/P-averaged commit-delta threshold."""
        deltas = [a.commit_ts_delta for a in self.announce
                  if a.commit_ts_delta is not None]
        self.unversion_heur.observe_round(deltas)
        thresh = self.unversion_heur.threshold()
        if thresh is None:
            return
        now = eng.clock.load()
        for bucket in self.vlt.nonempty_buckets():
            newest = self.vlt.bucket_newest_ts(bucket)
            if newest is None or now - newest < thresh:
                continue
            # claim the bucket's lock, detach, retire everything, reset bloom
            st = eng.locks.lock_and_flag(bucket, tid=-2)
            try:
                head = self.vlt.take_bucket(bucket)
                node = head
                while node is not None:
                    v = node.vlist.head
                    while v is not None:
                        self.ebr.retire(v)
                        v = v.older
                    self.ebr.retire(node)
                    node = node.next
                self.bloom.reset(bucket)
                self.stats_unversioned_buckets += 1
            finally:
                eng.locks.unlock(bucket)

    # ------------------------------------------------------------------
    # reporting / teardown
    # ------------------------------------------------------------------
    def mode_name(self, eng) -> str:
        return M.mode_name(self.mode_counter.load())

    def extra_stats(self, eng, out: dict) -> None:
        out["mode_transitions"] = self.stats_mode_transitions
        out["unversioned_buckets"] = self.stats_unversioned_buckets
        out["ebr_freed"] = self.ebr.freed_count
        # raw-engine stats only (the normalized substrate schema drops
        # them): words a versioned bulk read resolved via PackedVLT.select,
        # and how many of those a non-primary mirror way served (bucket
        # collisions the multi-way row layout kept vectorizable)
        out["version_gather_hits"] = self.stats_version_gather_hits
        out["mirror_way2_hits"] = sum(self.vlt.mirror.way_hits[1:])

    def stop(self, eng) -> None:
        self._stop.set()
        if self._bg is not None:
            self._bg.join(timeout=2.0)


class Multiverse(TransactionEngine):
    """The paper's TM: ``MultiversePolicy`` on the shared engine.

    Historical attribute surface (``tm.vlt``, ``tm.mode_counter``, ...)
    is preserved as properties over the policy so instrumentation,
    forced-mode ablations and the memory benchmarks keep working.
    """

    def __init__(self, n_threads: int,
                 params: Optional[MultiverseParams] = None,
                 start_bg: bool = True, heap=None, device=None):
        p = params or MultiverseParams()
        super().__init__(MultiversePolicy(p, start_bg=start_bg), n_threads,
                         lock_bits=p.lock_table_bits, heap=heap,
                         device=device)
        self.name = "Multiverse"

    # -- instrumentation surface (policy state) ---------------------------
    @property
    def params(self) -> MultiverseParams:
        return self.policy.params

    @property
    def vlt(self) -> VLT:
        return self.policy.vlt

    @property
    def bloom(self) -> BloomTable:
        return self.policy.bloom

    @property
    def mode_counter(self) -> AtomicInt:
        return self.policy.mode_counter

    @property
    def first_obs_mode_u_ts(self) -> AtomicInt:
        return self.policy.first_obs_mode_u_ts

    @property
    def min_mode_u_reads(self):
        return self.policy.min_mode_u_reads

    @property
    def announce(self):
        return self.policy.announce

    @property
    def ebr(self) -> EBR:
        return self.policy.ebr

    @property
    def unversion_heur(self):
        return self.policy.unversion_heur

    @property
    def stats_mode_transitions(self) -> int:
        return self.policy.stats_mode_transitions

    @property
    def stats_unversioned_buckets(self) -> int:
        return self.policy.stats_unversioned_buckets

