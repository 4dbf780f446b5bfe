"""Crash recovery: reconstruct a consistent heap after a simulated crash.

The recovery rules fall out of where each pipeline's COMMIT RECORD sits
(``TxnDescriptor.publish_started``, set the instant a decided commit
starts publishing):

  * ``publish_started`` False — the transaction never decided (or
    decided to abort): roll BACK.  Buffered writes never touched the
    heap, so rollback is releasing whatever locks the attempt claimed;
    encounter-time writes restore from the undo log (the engine's
    ``_abort`` already knows every policy's rollback, including
    Multiverse's TBD-version unlink).
  * ``publish_started`` True — the commit decided and the heap (or the
    version list, for Multiverse) may already be visible: roll FORWARD.
    Buffered pipelines redo the scatter from ``write_map`` (idempotent —
    the locks are still held, nobody else wrote those words), Multiverse
    finishes publishing its version set, and the held locks release at
    a fresh clock tick in one ``unlock_bulk`` sweep — at/above the tick
    the crashed commit took, so readers only see a conservative version
    bump, never a torn value.

Either way the sweep finishes with ``release_thread_locks`` (claims the
crashed frame never recorded anywhere — TL2's commit-time claim list is
a lost local — are found by owner scan), a torn-row repair pass over the
PackedVLT mirror (odd seqlock -> reset the row to fail-closed empty, on
the card and in its host copy of the ways), and invariant checks the
crash matrix asserts on.  Every sweep over device state brings it home
in one copy per call (lock words, mirror seqlocks, the heap words an
invariant needs), never one blocking read per word.

``recover_handle`` is the MVStore twin: complete a crashed install from
``MVStoreHandle._inflight`` (between the ``commit_fused`` call that
refreshed the ring slot in place and ``_install`` the parked state is
the only record of the new block and clock), truncate ring timestamps
past the durable clock — on the card and in the handle's host copy,
which is then rebuilt from the card so a slot a crashed publish
invalidated serves again — and verify a snapshot resolves at every
durable ring timestamp.  ``recover_shardstore`` resolves a parked
cross-shard ``EpochRecord``.  ``replay_from_checkpoint`` restores
training state from the newest manifest (the ``TrainSupervisor`` restore
path).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.snapshotter import restore_checkpoint
from repro_torch.configs.base import MVStoreConfig
from repro_torch.core import mvstore
from repro_torch.core.stats_schema import RECOVERY_STAT_KEYS  # noqa: F401
from repro_torch.reliability import faultpoints as FP


@dataclasses.dataclass
class RecoveryReport:
    dead_tids: List[int] = dataclasses.field(default_factory=list)
    rolled_forward: List[int] = dataclasses.field(default_factory=list)
    rolled_back: List[int] = dataclasses.field(default_factory=list)
    released_locks: int = 0
    repaired_mirror_rows: int = 0
    truncated_ring_slots: int = 0
    completed_install: bool = False
    clock_before: int = 0
    clock_after: int = 0
    wal_records_replayed: int = 0
    wal_torn_bytes: int = 0

    # canonical satellite names for the sweep counters
    @property
    def locks_swept(self) -> int:
        return self.released_locks

    @property
    def torn_rows_repaired(self) -> int:
        return self.repaired_mirror_rows

    def as_stats(self) -> dict:
        """The report projected onto the shared stats schema keys —
        ``normalize_stats`` carries these through unchanged."""
        return {"rolled_forward": len(self.rolled_forward),
                "rolled_back": len(self.rolled_back),
                "locks_swept": self.released_locks,
                "torn_rows_repaired": self.repaired_mirror_rows,
                "wal_records_replayed": self.wal_records_replayed}

    def apply_to(self, target: Any) -> None:
        """Accumulate into the target's ``recovery_counters`` so its
        ``stats()`` (and thus ``normalize_stats``) surfaces recovery
        work instead of ad-hoc fields."""
        t = getattr(target, "raw", target)
        rc = getattr(t, "recovery_counters", None)
        if rc is not None:
            for k, v in self.as_stats().items():
                rc[k] += v

    def summary(self) -> str:
        return (f"recovered tids={self.dead_tids} "
                f"fwd={self.rolled_forward} back={self.rolled_back} "
                f"locks={self.released_locks} "
                f"mirror={self.repaired_mirror_rows} "
                f"ring={self.truncated_ring_slots} "
                f"wal={self.wal_records_replayed} "
                f"clock {self.clock_before}->{self.clock_after}")


def _unwrap(tm: Any) -> Any:
    """Accept an engine, a WordSubstrate, or anything with ``.raw``."""
    return getattr(tm, "raw", tm)


def _mirror(eng) -> Any:
    vlt = getattr(eng.policy, "vlt", None) if hasattr(eng, "policy") else None
    return getattr(vlt, "mirror", None)


def locked_indices(locks) -> np.ndarray:
    """Every lock-table index with its locked bit set (ascending int64),
    from one copy home of the device words' nonzero positions (every
    engine of the port keeps an ``ArrayLockTable``)."""
    return torch.nonzero((locks._words & 2) != 0).reshape(-1).cpu().numpy()


def _roll_forward(eng, d, commit_clock: int) -> None:
    """Finish a decided commit on behalf of a dead owner.

    The owner's locks are still held (that is WHY we can redo), so the
    scatter/publish below races nobody.
    """
    if d.write_map and not d.undo:
        # buffered: redo the write-back from the redo log (idempotent);
        # recovery never routes through heap_scatter — an installed
        # fault schedule must not inject into the repair itself
        from repro_torch.reliability.wal import _plain_scatter
        wm = d.write_map
        addrs = np.fromiter(wm.keys(), np.int64, len(wm))
        _plain_scatter(eng.heap, addrs, list(wm.values()))
    if d.versioned_write_set:
        # Multiverse: finish clearing TBD marks / refreshing the mirror
        # at the recovery clock (>= the tick the crashed commit took)
        eng.policy._publish_versions(eng, d, commit_clock)
    retire = getattr(eng.policy, "_retire_bufs", None)
    if retire is not None:
        retire[d.tid].commit()
    d.stats["commits"] += 1
    d.active = False
    eng.policy.on_finish(eng, d)


def recover_engine(tm: Any, dead_tids: Sequence[int],
                   wal: Any = None) -> RecoveryReport:
    """Scan a word-level engine after a crash and restore consistency.

    ``dead_tids`` are the threads that died (every transaction they
    owned is orphaned) — MULTIPLE dead workers recover in this one
    sweep, including group-commit batch mates.  Safe to call with live
    threads quiesced — the crash matrix and the reliability workload
    both stop the world first, exactly like a real restart.

    ``wal`` (optional): the engine's attached WAL — a rolled-forward
    descriptor's durable record gets its COMPLETE marker here, so the
    journal reflects the finished publish.  (Replay stays idempotent
    without it; whole-process recovery is ``wal.recover_from_wal``.)
    """
    eng = _unwrap(tm)
    rep = RecoveryReport(dead_tids=sorted(int(t) for t in dead_tids))
    rep.clock_before = eng.clock.load()
    for tid in rep.dead_tids:
        d = eng.ctx(tid)
        if d.active:
            if d.publish_started:
                # one fresh tick serves as the recovered commit version
                cv = eng.clock.increment()
                _roll_forward(eng, d, cv)
                held = eng._held_by(tid)
                if held:
                    # one sweep at cv: the words the reference's
                    # one-index-at-a-time unlock(idx, cv) leaves
                    eng.locks.unlock_bulk(np.asarray(held, np.int64), cv)
                rep.released_locks += len(held)
                rep.rolled_forward.append(tid)
                if wal is not None and d.wal_lsn is not None:
                    wal.append_complete(d.wal_lsn)
                    d.wal_lsn = None
            else:
                # the engine's abort already knows every policy's
                # rollback: undo restore, TBD unlink, deferred-clock bump
                eng._abort(d)
                rep.rolled_back.append(tid)
        # claims the descriptor never recorded (TL2's commit-time claim
        # list is a lost local): owner-scan sweep at a bumped clock
        rep.released_locks += eng.release_thread_locks(tid)
    rep.repaired_mirror_rows = repair_mirror(eng)
    rep.clock_after = eng.clock.load()
    rep.apply_to(eng)
    FP.reset_thread()
    return rep


def repair_mirror(tm: Any) -> int:
    """Reset torn PackedVLT mirror rows (odd per-row seqlock).

    A writer that died inside a seq bracket leaves the row permanently
    odd — readers already fail closed (scalar walk), but the row can
    never serve again.  Repair = empty the row and restore an even seq:
    fail-closed, and the next publish re-seeds it.  The device rows
    (``_addr``, ``_ts``, ``_data``, ``_seq``) and the writers' host copy
    of the ways (``_ways``) reset together, so the next ``publish``
    finds no way the card no longer tracks.  Returns the number of rows
    repaired.

    LIVE-MODE SAFETY: mirror rows are keyed by lock index, and the
    writer discipline publishes only while holding that address lock —
    so a row that is odd while its lock word is HELD belongs to a live
    writer mid-bracket, not to the dead one, and must be skipped.  (The
    dead thread's locks were already swept before this runs.)
    """
    eng = _unwrap(tm)
    mirror = _mirror(eng)
    if mirror is None:
        return 0
    from repro_torch.core.vlt import EMPTY_TS
    odd = torch.nonzero((mirror._seq & 1) != 0).reshape(-1)
    rows = odd[(eng.locks._words[odd] & 2) == 0]    # skip live brackets
    torn = rows.cpu().numpy()
    if torn.size:
        mirror._addr[rows] = mirror.NO_ADDR
        mirror._ts[rows] = EMPTY_TS
        mirror._data[rows] = 0
        mirror._seq[rows] += 1
        mirror._ways[torn] = mirror.NO_ADDR
    return int(torn.size)


def _heap_words(eng, n: int) -> np.ndarray:
    """The first ``n`` heap words on the host: one copy of the device
    block on an array heap, the list's cells otherwise."""
    live = getattr(eng.heap, "live", None)
    if live is not None:
        return live()[:n].cpu().numpy()
    return np.array([eng.heap[i] for i in range(n)])


def check_engine_invariants(tm: Any, *,
                            expect_heap: Optional[np.ndarray] = None,
                            expect_sums: Optional[Iterable] = None,
                            clock_at_least: Optional[int] = None
                            ) -> List[str]:
    """Post-recovery invariants; returns human-readable violations.

    * lock table empty (no locked bits anywhere);
    * no torn PackedVLT mirror rows (every per-row seq even);
    * clock monotone (>= ``clock_at_least``);
    * heap equality (``expect_heap``) or block-sum conservation
      (``expect_sums``: iterable of ``(base, n, expected_sum)``).

    Block sums read every block's words in ONE heap gather on an array
    heap, brought home in one copy.
    """
    eng = _unwrap(tm)
    out: List[str] = []
    held = locked_indices(eng.locks)
    if held.size:
        out.append(f"lock table not empty: {held.size} held "
                   f"(first {held[:8].tolist()})")
    mirror = _mirror(eng)
    if mirror is not None:
        torn = int(((mirror._seq & 1) != 0).sum())
        if torn:
            out.append(f"{torn} torn PackedVLT mirror rows")
    if clock_at_least is not None and eng.clock.load() < clock_at_least:
        out.append(f"clock went backwards: {eng.clock.load()} "
                   f"< {clock_at_least}")
    if expect_heap is not None:
        want = np.asarray(expect_heap)
        got = _heap_words(eng, len(want))
        if not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0]
            out.append(f"heap mismatch at {bad.size} addrs "
                       f"(first {bad[:8].tolist()})")
    if expect_sums is not None:
        blocks = [(int(b), int(n), w) for b, n, w in expect_sums]
        if blocks:
            addrs = np.concatenate([np.arange(b, b + n, dtype=np.int64)
                                    for b, n, _ in blocks])
            got = eng.heap.gather(addrs)
            if isinstance(got, torch.Tensor):
                got = got.cpu().numpy()
            else:
                got = np.array([int(v) for v in got], dtype=object)
            off = 0
            for base, n, want in blocks:
                got_sum = int(got[off:off + n].sum()) if n else 0
                off += n
                if got_sum != want:
                    out.append(f"block sum at {base}+{n}: {got_sum} "
                               f"!= {want}")
    return out


# ---------------------------------------------------------------------------
# MVStore handle recovery
# ---------------------------------------------------------------------------


def recover_handle(handle: Any) -> RecoveryReport:
    """Recover an ``MVStoreHandle`` after a crashed commit.

    Completes a crashed install (``_inflight`` — the state a finished
    ``commit_fused`` call returned, parked until ``_install``; its ring
    slot was already refreshed in place), then truncates any ring
    timestamp past the durable clock (a torn row can never satisfy a
    reader consistently) on the card, and rebuilds the handle's host
    copy of the timestamps from the card: a publish that crashed after
    invalidating a slot on the host (``NO_TS``) but before the kernel
    refreshed it leaves the card's older timestamp, which serves again.
    """
    rep = RecoveryReport()
    with handle._commit_lock:
        rep.clock_before = int(handle._state.clock)
        inflight = handle._inflight
        if inflight is not None:
            handle._install(inflight)
            handle._inflight = None
            rep.completed_install = True
        state = handle._state
        durable = int(state.clock)
        for ts in (state.ring_ts or {}).values():
            torn = ts > durable
            n = int(torn.sum())
            if n:
                rep.truncated_ring_slots += n
                ts.masked_fill_(torn, mvstore.NO_TS)
        handle._install(state)
        host_ts = handle._snap[3]
        if host_ts is not None:
            host_ts[:] = state.ring_ts[handle._path].cpu().numpy()
        rep.clock_after = int(handle._state.clock)
    rep.apply_to(handle)
    FP.reset_thread()
    return rep


def check_store_invariants(handle: Any, *,
                           clock_at_least: Optional[int] = None
                           ) -> List[str]:
    """Post-recovery MVStore invariants; returns violations.

    * no in-flight (uninstalled) state;
    * clock monotone;
    * no ring timestamp past the durable clock;
    * the handle's host ring timestamps equal the card's (the port keeps
      both copies);
    * a snapshot RESOLVES at every durable ring timestamp (the paper's
      committed-prefix promise, checked slot by slot: one
      ``snapshot_select`` launch each).
    """
    out: List[str] = []
    if handle._inflight is not None:
        out.append("uninstalled in-flight commit")
    clock, live, ring, ring_ts = handle._snap
    if clock_at_least is not None and clock < clock_at_least:
        out.append(f"store clock went backwards: {clock} < {clock_at_least}")
    if ring_ts is not None:
        past = ring_ts[ring_ts > clock]
        if past.size:
            out.append(f"ring timestamps past durable clock: "
                       f"{past.tolist()}")
        dev_ts = handle._state.ring_ts[handle._path].cpu().numpy()
        if not np.array_equal(dev_ts, ring_ts):
            out.append(f"host ring timestamps {ring_ts.tolist()} differ "
                       f"from the card's {dev_ts.tolist()}")
        for ts in sorted(int(t) for t in ring_ts if int(t) != -1):
            _view, ok = mvstore.mv_snapshot(handle._state, ts)
            if not bool(ok):
                out.append(f"snapshot unreadable at durable clock {ts}")
    return out


# ---------------------------------------------------------------------------
# sharded-store recovery (cross-shard epoch publish)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EpochRecord:
    """The cross-shard commit record: ``publish_started`` generalized
    from one transaction to one EPOCH of shard-local publishes.

    A multi-shard commit parks this in ``ShardStoreHandle._epoch_inflight``
    before bumping the epoch seqlock odd.  ``pins[s]`` is write shard
    ``s``'s clock at validation time; a shard whose clock still equals
    its pin after a crash has NOT published (each shard-local publish
    ticks its clock by exactly one), so recovery can tell redo from done
    without any per-shard journal:

      * ``publish_started`` False — the epoch never decided: roll BACK.
        No shard published (the flag flips before the first shard-local
        publish), so rollback is dropping the record and re-evening the
        seqlock.
      * ``publish_started`` True — the epoch decided: roll FORWARD.
        Replay every write shard still at its pin through the exact
        publish path (``MVStoreHandle._publish_locked`` on the parked
        per-shard context), so after recovery either ALL shards carry
        the epoch's writes or the epoch is re-driven to completion —
        never a torn cut.
    """
    epoch: int
    write_shards: tuple
    pins: dict                      # shard id -> clock pinned at validate
    ctxs: dict                      # shard id -> parked _MVCtx (write_buf)
    tid: int = -1
    publish_started: bool = False
    published: list = dataclasses.field(default_factory=list)
    # the epoch's durable twin: one WAL prepare per write shard, all
    # covered by ONE group DECIDE — so a restart replays the epoch
    # all-or-nothing (wal.recover_from_wal)
    wal_lsns: tuple = ()


def recover_shardstore(store: Any, wal: Any = None) -> RecoveryReport:
    """Recover a ``ShardStoreHandle`` after a crashed commit.

    Stop-world like every recovery here: first each member shard recovers
    exactly as a solo handle (completing crashed installs, truncating
    torn ring slots), then the epoch record applies the roll-forward /
    roll-back rule above, and finally the epoch seqlock is forced even so
    new transactions stop spinning in ``begin``.  With ``wal`` given, a
    rolled-forward epoch's durable records get their COMPLETE markers.
    """
    rep = RecoveryReport()
    rep.clock_before = int(store._epoch.load())
    for shard in store._shards:
        sub = recover_handle(shard)
        rep.truncated_ring_slots += sub.truncated_ring_slots
        rep.completed_install = rep.completed_install or sub.completed_install
    rec = store._epoch_inflight
    if rec is not None:
        if rec.publish_started:
            for s in rec.write_shards:
                shard = store._shards[s]
                if int(shard._state.clock) == rec.pins[s]:
                    # still at its pin => this shard never published:
                    # redo through the exact commit publish path
                    with shard._commit_lock:
                        shard._publish_locked(rec.ctxs[s],
                                              wal_log=False)
                    rec.published.append(s)
            rep.rolled_forward.append(rec.tid)
            if wal is not None:
                for lsn in rec.wal_lsns:
                    wal.append_complete(lsn)
        else:
            rep.rolled_back.append(rec.tid)
        for ctx in rec.ctxs.values():
            ctx.active = False
        store._epoch_inflight = None
    if store._epoch_seq.load() & 1:
        store._epoch_seq.increment()
    rep.clock_after = int(store._epoch.load())
    rep.apply_to(store)
    FP.reset_thread()
    return rep


def check_shardstore_invariants(store: Any, *,
                                clocks_at_least: Optional[Sequence[int]]
                                = None) -> List[str]:
    """Post-recovery sharded-store invariants; returns violations.

    Per-shard ``check_store_invariants`` plus the epoch level: no parked
    epoch record, epoch seqlock even (readers can pin), and every shard
    clock monotone against ``clocks_at_least``.
    """
    out: List[str] = []
    if store._epoch_inflight is not None:
        out.append("unresolved cross-shard epoch record")
    if store._epoch_seq.load() & 1:
        out.append("epoch seqlock left odd (readers starve)")
    for s, shard in enumerate(store._shards):
        floor = (None if clocks_at_least is None
                 else int(clocks_at_least[s]))
        out.extend(f"shard {s}: {v}"
                   for v in check_store_invariants(shard,
                                                   clock_at_least=floor))
    return out


# ---------------------------------------------------------------------------
# checkpoint replay (TrainSupervisor restore path)
# ---------------------------------------------------------------------------


def replay_from_checkpoint(ckpt_dir: str, template_state):
    """Restore (step, state) from the newest manifest under ``ckpt_dir``.

    ``template_state`` supplies the structure (a TrainState with
    ``.mv``/``.opt``) and each leaf's dtype and device; rings are
    re-seeded from the restored live values at the restored clock, and
    the template's block stamps are kept, as in the reference.  Raises
    FileNotFoundError when no checkpoint has landed (callers decide: cold
    restart).  ``save_checkpoint``'s atomic ``os.replace`` publish means
    a crash at ``pre_manifest_publish`` leaves only a ``.tmp`` directory,
    which the restore scan skips — replay always lands on a COMPLETE
    manifest.
    """
    tmpl = {"params": template_state.mv.live, "opt": template_state.opt}
    step, restored, _extra = restore_checkpoint(ckpt_dir, tmpl)
    mv = template_state.mv._replace(live=restored["params"], clock=step)
    if mv.ring:
        paths = set(mv.ring)
        slots = next(iter(template_state.mv.ring.values())).shape[0]
        mv = mv._replace(ring={}, ring_ts={})
        mv = mvstore.version_blocks(mv, paths,
                                    MVStoreConfig(ring_slots=slots))
    return step, template_state._replace(mv=mv, opt=restored["opt"])
