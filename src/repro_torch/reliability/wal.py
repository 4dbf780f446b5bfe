"""Write-ahead commit log: the durable twin of ``publish_started``.

Crash recovery (``recovery.py``) keys every roll-forward/roll-back
decision on ``TxnDescriptor.publish_started`` — process memory.  A real
``kill -9`` loses it, and with it the committed prefix.  This module
makes the commit record durable with the classic two-marker WAL
protocol, shaped to fit the existing pipelines:

  * PREPARE — the serialized write-set (tid, addrs, values, pinned
    clock(s), epoch + shard for the sharded store), appended BEFORE the
    claim/scatter phase.  A prepare alone decides nothing: a crash (or
    an ordinary abort) that never reaches DECIDE rolls BACK by simply
    not replaying the record.
  * DECIDE — appended + fsync'd at the exact instant ``publish_started``
    flips True, BEFORE the first heap mutation (the write-ahead
    invariant).  On the card that is before the first heap write is
    even enqueued, so a process killed with launches still queued has
    its decided records on disk.  Group commit amortizes: one DECIDE
    frame carrying every surviving member's lsn, one fsync per group.
    The cross-shard ``EpochRecord`` is one prepare per write shard + one
    group DECIDE, so the epoch is all-or-nothing across restarts too.
  * COMPLETE — buffered, informational: replay is idempotent either
    way, but decided-without-COMPLETE is what ``recover_from_wal``
    reports as rolled forward.

Frames are length- and CRC-framed (``MWAL | len | crc32 | payload``), so
a torn tail — the frame a dying ``write()`` cut in half — is detected
and dropped, never misparsed; segments roll at ``segment_bytes`` and a
``checkpoint`` writes an atomic base image (tmp + ``os.replace``) that
lets old segments be reclaimed.  The frame and file formats are the JAX
package's byte for byte (little-endian ``struct`` headers, CRC32, int64
images), so a log written by either package replays in the other.

``recover_from_wal`` rebuilds a FRESH target (word engine, MVStore
handle or sharded store — all in-memory state lost) by replaying every
decided record in lsn order, then runs the owner-scan / torn-row sweep
so the caller's ``check_*_invariants`` passes.  Redo is whole-record and
idempotent: a partial-lane kernel fault that scattered half the lanes is
healed by re-scattering all of them.  On an array heap each record is
one ``scatter_write`` call from its int64 columns (and the base image
one more), never a Python list.

Values are int64 (this is the numeric-heap layer — parameter blocks and
the int benchmarks); a non-numeric heap cannot go durable and
``append_prepare`` raises rather than silently logging garbage.  Values
or a checkpoint's heap given as a tensor on the card come home in one
copy.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import zlib
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["WriteAheadLog", "WalRecord", "scan_dir", "attach_wal",
           "recover_from_wal"]

MAGIC = b"MWAL"
_FRAME = struct.Struct("<4sII")            # magic, payload len, crc32
_PREP = struct.Struct("<BQqiqHI")          # type, lsn, tid, shard, epoch,
                                           #   n_clocks, n_writes
_MARK = struct.Struct("<BQ")               # type, lsn   (COMPLETE / BASE)
_DEC = struct.Struct("<BI")                # type, n_lsns

REC_PREPARE = 1
REC_DECIDE = 2
REC_COMPLETE = 3
REC_BASE = 4

_SEG_FMT = "wal-%08d.seg"
_BASE_FMT = "base-%016d.npz"


@dataclasses.dataclass
class WalRecord:
    """One prepared commit as scanned back from the segment files."""

    lsn: int
    tid: int
    shard: int                  # -1 = unsharded; else owning shard id
    epoch: int                  # -1 = not a cross-shard epoch member
    clocks: Tuple[int, ...]     # pinned clock(s) at prepare time
    addrs: np.ndarray           # int64 write-set addresses
    values: np.ndarray          # int64 write-set values
    decided: bool = False
    completed: bool = False


def _host_i64(x) -> np.ndarray:
    """Addresses or values as a host int64 array: a tensor (any device)
    in one copy, anything else through numpy's int64 conversion."""
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(-1).to("cpu", torch.int64).numpy()
    return np.asarray(x if hasattr(x, "__len__") else list(x),
                      dtype=np.int64)


def _prepare_frame(lsn: int, tid: int, addrs, values, clocks,
                   epoch: int, shard: int) -> bytes:
    a = _host_i64(addrs)
    try:
        v = _host_i64(values)
    except (TypeError, ValueError) as e:
        raise TypeError(
            "WAL records are int64: durable mode needs a numeric heap "
            f"({e})") from e
    if v.shape != a.shape:
        raise ValueError(f"addrs/values length mismatch: "
                         f"{a.shape} vs {v.shape}")
    c = np.asarray(tuple(clocks), dtype=np.int64)
    payload = (_PREP.pack(REC_PREPARE, lsn, int(tid), int(shard),
                          int(epoch), c.size, a.size)
               + c.astype("<i8").tobytes() + a.astype("<i8").tobytes()
               + v.astype("<i8").tobytes())
    return _frame(payload)


def _frame(payload: bytes) -> bytes:
    return _FRAME.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


# fdatasync skips the mtime flush but (per POSIX) still flushes the size
# change an append needs for the data to be retrievable after a crash —
# the cheapest call that keeps the decide durable.
_fdatasync = getattr(os, "fdatasync", os.fsync)


class WriteAheadLog:
    """Append-only, fsync'd, segmented commit log.

    Thread-safe (one internal lock — appends from concurrent commit
    pipelines interleave whole frames, never bytes).  Reopening an
    existing directory continues the lsn sequence in a FRESH segment, so
    a torn tail left by the previous process never gets appended past.
    """

    def __init__(self, path: str, *, segment_bytes: int = 4 << 20,
                 sync: bool = True, group_sync: bool = False):
        self.dir = str(path)
        os.makedirs(self.dir, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.sync = bool(sync)
        self._lock = threading.RLock()
        # group-sync state: appends bump _append_seq under _lock; the
        # fsync that settles durability runs under _sync_lock WITHOUT
        # _lock, so concurrent committers keep appending while the disk
        # works, and any decide that fsync covered piggybacks
        # (_synced_seq only ever grows).  Lock order: _sync_lock before
        # _lock, never the reverse.
        self._sync_lock = threading.Lock()
        self._append_seq = 0
        self._synced_seq = 0
        self._cv = threading.Condition(self._lock)
        self.counters = {"records": 0, "decides": 0, "fsyncs": 0,
                         "bytes": 0, "segments": 0}
        segs = self._segments()
        self._seg_idx = (segs[-1][0] + 1) if segs else 0
        self._next_lsn = 0
        if segs:
            recs, _torn, base = scan_dir(self.dir)
            floor = base[0] if base is not None else 0
            self._next_lsn = max([floor] + [r.lsn + 1 for r in recs])
        self._f = None
        self._open_segment()
        # group_sync: a dedicated syncer thread owns every fdatasync;
        # committers append, then sleep on the condvar until the
        # syncer's next cycle covers their frame.  The disk pipeline
        # runs back-to-back while committers' Python overlaps it — the
        # throughput shape of group commit without batching the commits
        # themselves.
        self._syncer = None
        self._syncer_stop = False
        if group_sync and self.sync:
            self._syncer = threading.Thread(
                target=self._sync_loop, name="wal-syncer", daemon=True)
            self._syncer.start()

    # -- segment bookkeeping ------------------------------------------
    def _segments(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("wal-") and name.endswith(".seg"):
                out.append((int(name[4:-4]), os.path.join(self.dir, name)))
        return sorted(out)

    def _open_segment(self) -> None:
        if self._f is not None:
            self._f.close()
        path = os.path.join(self.dir, _SEG_FMT % self._seg_idx)
        self._seg_idx += 1
        self._f = open(path, "ab")
        self.counters["segments"] += 1

    def _maybe_roll(self) -> None:
        # only ever between whole frames — a roll can't tear a record
        if self._f.tell() >= self.segment_bytes:
            self.flush(fsync=self.sync)
            self._open_segment()

    # -- appends -------------------------------------------------------
    def append_prepare(self, tid: int, addrs, values, *,
                       clocks: Sequence[int] = (), epoch: int = -1,
                       shard: int = -1) -> int:
        """Buffered PREPARE (call BEFORE the claim); returns the lsn."""
        with self._lock:
            lsn = self._next_lsn
            self._next_lsn += 1
            buf = _prepare_frame(lsn, tid, addrs, values, clocks,
                                 epoch, shard)
            self._f.write(buf)
            self.counters["records"] += 1
            self.counters["bytes"] += len(buf)
            return lsn

    def append_prepare_group(self, recs: Iterable[tuple]) -> List[int]:
        """Batched PREPAREs — one buffered write for a whole commit
        group.  ``recs`` items: ``(tid, addrs, values, clocks, epoch,
        shard)``."""
        with self._lock:
            frames, lsns = [], []
            for tid, addrs, values, clocks, epoch, shard in recs:
                lsn = self._next_lsn
                self._next_lsn += 1
                frames.append(_prepare_frame(lsn, tid, addrs, values,
                                             clocks, epoch, shard))
                lsns.append(lsn)
            if frames:
                buf = b"".join(frames)
                self._f.write(buf)
                self.counters["records"] += len(frames)
                self.counters["bytes"] += len(buf)
            return lsns

    def append_decide(self, lsn: int) -> None:
        """The durable commit record: DECIDE + fsync, call at the exact
        point ``publish_started`` flips True (before any heap write)."""
        self.append_decide_group((lsn,))

    def append_decide_group(self, lsns: Sequence[int]) -> None:
        """One DECIDE frame for a whole group, made durable by a
        COALESCED sync — group commit across transactions AND threads.

        The frame is appended and flushed under the append lock; the
        blocking ``fdatasync`` then runs under a separate sync lock with
        the append lock RELEASED, so other committers keep appending
        while the disk works.  Whichever committer reaches the sync lock
        first syncs everything flushed so far; a committer whose frame
        that sync already covered returns without touching the disk.
        Either way this method never returns before the caller's DECIDE
        is durable — the write-ahead invariant is untouched, only the
        number of device flushes shrinks.
        """
        if not lsns:
            return
        with self._lock:
            payload = (_DEC.pack(REC_DECIDE, len(lsns))
                       + np.asarray(lsns, "<u8").tobytes())
            buf = _frame(payload)
            self._f.write(buf)
            self._f.flush()
            self.counters["decides"] += len(lsns)
            self.counters["bytes"] += len(buf)
            self._append_seq += 1
            my_seq = self._append_seq
            if not self.sync:
                self._maybe_roll()
                return
            if self._syncer is not None:
                # wake the syncer, then sleep (lock released) until its
                # fsync covers this frame — the wait timeout is only a
                # lost-wakeup safety net
                self._cv.notify_all()
                while self._synced_seq < my_seq:
                    self._cv.wait(0.05)
                return
        if self._synced_seq >= my_seq:   # a peer's fsync covered us
            return
        with self._sync_lock:
            if self._synced_seq >= my_seq:
                return
            self._sync_cycle()

    def _sync_cycle(self) -> bool:
        """One durability step: flush + fdatasync everything appended so
        far, then publish the new synced frontier.  Caller holds
        ``_sync_lock``; the blocking fdatasync runs with the append lock
        RELEASED so committers keep appending while the disk works."""
        with self._lock:
            if self._append_seq == self._synced_seq:
                return False
            self._f.flush()
            target = self._append_seq
            fd = self._f.fileno()
        _fdatasync(fd)
        with self._lock:
            self.counters["fsyncs"] += 1
            self._synced_seq = target
            self._maybe_roll()           # rolls only under _sync_lock,
                                         # so fd above is never stale
            self._cv.notify_all()
        return True

    def _sync_loop(self) -> None:
        while True:
            with self._sync_lock:
                did = self._sync_cycle()
            with self._cv:
                if self._syncer_stop and \
                        self._append_seq == self._synced_seq:
                    return
                # sleep only with nothing pending, checked under the
                # condvar's lock: a decide appended (and its notify sent)
                # between the idle cycle above and this wait would
                # otherwise sleep the full timeout with its committer
                if not did and not self._syncer_stop and \
                        self._append_seq == self._synced_seq:
                    self._cv.wait(0.05)

    def append_complete(self, lsn: int) -> None:
        """Buffered COMPLETE marker (publish finished; replay-optional)."""
        with self._lock:
            buf = _frame(_MARK.pack(REC_COMPLETE, lsn))
            self._f.write(buf)
            self.counters["bytes"] += len(buf)
            if not self.sync:
                # sync mode rolls in the decide path (under _sync_lock);
                # rolling here could close the fd out from under a
                # concurrent leader's fdatasync
                self._maybe_roll()

    # -- durability / lifecycle ---------------------------------------
    def flush(self, fsync: Optional[bool] = None) -> None:
        with self._lock:
            self._f.flush()
            if self.sync if fsync is None else fsync:
                os.fsync(self._f.fileno())
                self.counters["fsyncs"] += 1

    def checkpoint(self, heap_values, clock: int) -> int:
        """Write an atomic base image; records below the returned floor
        lsn no longer need replaying and their segments are reclaimed.

        ``heap_values``: the whole heap — a tensor on the card comes
        home in one copy, before any lock is taken.  Same publish idiom
        as ``checkpoint/snapshotter.save_checkpoint``: write to a tmp
        name, fsync, ``os.replace`` — a crash mid-checkpoint leaves only
        a tmp file the scan ignores.
        """
        if isinstance(heap_values, torch.Tensor):
            heap = heap_values.detach().to("cpu", torch.int64).numpy()
        else:
            heap = np.asarray(heap_values, np.int64)
        with self._sync_lock, self._lock:
            floor = self._next_lsn
            final = os.path.join(self.dir, _BASE_FMT % floor)
            tmp = final + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, heap=heap, clock=np.int64(clock),
                         floor=np.int64(floor))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            buf = _frame(_MARK.pack(REC_BASE, floor))
            self._f.write(buf)
            self.flush(fsync=self.sync)
            # reclaim: everything below the floor is in the base image
            cur = self._f.name
            for _idx, path in self._segments():
                if path != cur:
                    os.unlink(path)
            for name in os.listdir(self.dir):
                if (name.startswith("base-") and name.endswith(".npz")
                        and name != os.path.basename(final)):
                    os.unlink(os.path.join(self.dir, name))
            return floor

    def stats(self) -> dict:
        out = dict(self.counters)
        out["next_lsn"] = self._next_lsn
        return out

    def close(self) -> None:
        if self._syncer is not None:
            with self._cv:
                self._syncer_stop = True
                self._cv.notify_all()
            self._syncer.join(timeout=5.0)
            self._syncer = None
        with self._sync_lock, self._lock:
            if self._f is not None:
                self.flush(fsync=self.sync)
                self._f.close()
                self._f = None

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# scan (restart path)
# ---------------------------------------------------------------------------


def _scan_segment(path: str, records: dict, decided: set,
                  completed: set) -> int:
    """Parse one segment; returns torn-tail bytes dropped (0 = clean).

    Stops at the first bad frame — a frame the dying process cut in
    half can only be the LAST thing written to the then-live segment, so
    everything after a failed length/CRC check is the tear.
    """
    with open(path, "rb") as f:
        data = f.read()
    off, n = 0, len(data)
    while off + _FRAME.size <= n:
        magic, ln, crc = _FRAME.unpack_from(data, off)
        if magic != MAGIC or off + _FRAME.size + ln > n:
            break
        payload = data[off + _FRAME.size: off + _FRAME.size + ln]
        if zlib.crc32(payload) != crc:
            break
        kind = payload[0]
        if kind == REC_PREPARE:
            (_k, lsn, tid, shard, epoch,
             n_clk, n_w) = _PREP.unpack_from(payload, 0)
            body = payload[_PREP.size:]
            clocks = np.frombuffer(body, "<i8", n_clk)
            a0 = n_clk * 8
            addrs = np.frombuffer(body, "<i8", n_w, a0)
            vals = np.frombuffer(body, "<i8", n_w, a0 + n_w * 8)
            records[lsn] = WalRecord(
                lsn=lsn, tid=tid, shard=shard, epoch=epoch,
                clocks=tuple(int(c) for c in clocks),
                addrs=addrs.astype(np.int64),
                values=vals.astype(np.int64))
        elif kind == REC_DECIDE:
            _k, cnt = _DEC.unpack_from(payload, 0)
            decided.update(
                int(x) for x in np.frombuffer(payload, "<u8", cnt,
                                              _DEC.size))
        elif kind == REC_COMPLETE:
            _k, lsn = _MARK.unpack_from(payload, 0)
            completed.add(int(lsn))
        # REC_BASE frames are advisory; the base image carries the floor
        off += _FRAME.size + ln
    return n - off


def scan_dir(path: str):
    """Scan a WAL directory.

    Returns ``(records, torn_bytes, base)`` — ``records`` is the
    lsn-ordered list of :class:`WalRecord` (``decided``/``completed``
    resolved), ``torn_bytes`` counts dropped torn-tail bytes, ``base``
    is ``(floor_lsn, heap, clock)`` from the newest checkpoint image or
    ``None``.  Records below the base floor are already in the image
    and are omitted.
    """
    records: dict = {}
    decided: set = set()
    completed: set = set()
    torn = 0
    segs = sorted(name for name in os.listdir(path)
                  if name.startswith("wal-") and name.endswith(".seg"))
    for name in segs:
        torn += _scan_segment(os.path.join(path, name), records,
                              decided, completed)
    base = None
    bases = sorted(name for name in os.listdir(path)
                   if name.startswith("base-") and name.endswith(".npz"))
    if bases:
        with np.load(os.path.join(path, bases[-1])) as z:
            base = (int(z["floor"]), np.asarray(z["heap"], np.int64),
                    int(z["clock"]))
    floor = base[0] if base is not None else 0
    out = []
    for lsn in sorted(records):
        if lsn < floor:
            continue
        r = records[lsn]
        r.decided = lsn in decided
        r.completed = lsn in completed
        out.append(r)
    return out, torn, base


# ---------------------------------------------------------------------------
# attach / recover
# ---------------------------------------------------------------------------


def attach_wal(target: Any, wal: WriteAheadLog) -> WriteAheadLog:
    """Point a substrate's commit pipeline at a WAL.

    Word engines (and their ``WordSubstrate`` wrappers), MVStore handles
    and sharded stores all carry a ``wal`` slot the pipelines check; the
    sharded store additionally tags each member shard so its records
    carry the shard id the replay routes by.
    """
    t = getattr(target, "raw", target)
    t.wal = wal
    if hasattr(t, "_shards"):
        for s, sh in enumerate(t._shards):
            sh.wal = wal
            sh.wal_shard = s
    return wal


def _plain_scatter(heap, addrs, values) -> None:
    """Recovery-side scatter of int64 columns: NEVER routes through the
    commit pipeline's fault points — replay must not re-fire the
    schedule that killed us.  An array heap takes the arrays as they
    are (one ``scatter_write`` call); an object heap stores Python
    ints, as a commit would have."""
    if isinstance(values, np.ndarray) and not hasattr(heap, "live"):
        values = values.tolist()             # object heap: Python ints
    heap.scatter(np.asarray(addrs, np.int64), values)


def recover_from_wal(wal: Any, target: Any = None):
    """Replay the durable committed prefix into a fresh ``target``.

    ``wal`` is a :class:`WriteAheadLog` or a directory path.  ``target``
    is a word engine / ``WordSubstrate`` (replay scatters into its
    heap, floors its clock, then runs the owner-scan + torn-row sweep),
    an ``MVStoreHandle`` or ``ShardStoreHandle`` (replay re-drives each
    decided record through the exact publish path, suppressing re-
    logging), or ``None`` (scan only).  Returns a
    ``recovery.RecoveryReport`` whose WAL counters feed
    ``core.stats_schema.normalize_stats``:

      * ``wal_records_replayed`` — decided records redone (idempotent,
        whole-record: a partial-lane crash image is overwritten);
      * ``rolled_forward`` — tids of decided-but-not-COMPLETE records
        (the mid-publish crashes);
      * ``rolled_back``  — tids of prepared-but-undecided records
        (dropped: they never decided).
    """
    from repro_torch.reliability import faultpoints as FP
    from repro_torch.reliability.recovery import (RecoveryReport,
                                                  repair_mirror)

    if isinstance(wal, WriteAheadLog):
        wal.flush(fsync=False)       # same-process restart drills
        path = wal.dir
    else:
        path = str(wal)
    records, torn, base = scan_dir(path)
    rep = RecoveryReport()
    rep.wal_torn_bytes = torn
    decided = [r for r in records if r.decided]
    for r in records:
        if not r.decided:
            rep.rolled_back.append(r.tid)
    t = getattr(target, "raw", target) if target is not None else None
    if t is None:
        for r in decided:
            rep.wal_records_replayed += 1
            if not r.completed:
                rep.rolled_forward.append(r.tid)
        return rep

    prev_wal = getattr(t, "wal", None)
    try:
        if prev_wal is not None:
            t.wal = None             # replay must not re-log itself
        if hasattr(t, "_shards"):
            _replay_shardstore(t, decided, rep)
        elif hasattr(t, "_publish_locked"):
            _replay_handle(t, decided, rep)
        else:
            _replay_engine(t, decided, base, rep)
            rep.repaired_mirror_rows = repair_mirror(t)
    finally:
        if prev_wal is not None:
            attach_wal(t, prev_wal)
    rep.apply_to(t)
    FP.reset_thread()
    return rep


def _replay_engine(eng, decided, base, rep) -> None:
    clock_floor = 0
    if base is not None:
        _floor, heap, clk = base
        if heap.size:
            _plain_scatter(eng.heap, np.arange(heap.size, dtype=np.int64),
                           heap)
        clock_floor = clk
    tids = set()
    for r in decided:
        _plain_scatter(eng.heap, r.addrs, r.values)
        rep.wal_records_replayed += 1
        tids.add(r.tid)
        if not r.completed:
            rep.rolled_forward.append(r.tid)
        if r.clocks:
            clock_floor = max(clock_floor, max(r.clocks))
    if eng.clock.load() < clock_floor:
        eng.clock.store(int(clock_floor))
    # owner-scan sweep: a fresh engine holds nothing, an in-place
    # restart drill may still hold the dead workers' claims
    for tid in sorted(tids):
        rep.released_locks += eng.release_thread_locks(int(tid))


def _replay_handle(handle, decided, rep) -> None:
    from repro_torch.api.mvhandle import _MVCtx
    for r in decided:
        ctx = _MVCtx(max(int(r.tid), 0) % max(handle.n_threads, 1))
        ctx.read_only = False
        ctx.active = True
        ctx.write_buf = dict(zip(r.addrs.tolist(), r.values.tolist()))
        with handle._commit_lock:
            ctx.read_clock = int(handle._state.clock)
            handle._publish_locked(ctx, wal_log=False)
        ctx.active = False
        rep.wal_records_replayed += 1
        if not r.completed:
            rep.rolled_forward.append(r.tid)


def _replay_shardstore(store, decided, rep) -> None:
    epoch_floor = store._epoch.load()
    for r in decided:
        s = r.shard if r.shard >= 0 else 0
        _replay_handle(store._shards[s], [r], rep)
        if r.epoch >= 0:
            epoch_floor = max(epoch_floor, r.epoch)
    # cross-shard epochs replayed above are all-or-nothing by
    # construction: every member shares one group DECIDE, so either the
    # whole epoch is in `decided` or none of it is
    while store._epoch.load() < epoch_floor:
        store._epoch.increment()
    if store._epoch_seq.load() & 1:
        store._epoch_seq.increment()     # readers stop spinning
    store._epoch_inflight = None
