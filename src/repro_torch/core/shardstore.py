"""ShardStoreHandle — the MVStore partitioned into shards.

The coarse level of the two-level clock scheme (``mvstore.MVStoreState.
block_clocks`` is the fine level): ``n_shards`` independent
``MVStoreHandle``s, each owning one slice of the address space, one
shard-local clock and its own bounded ring — plus ONE coarse epoch
clock for cross-shard ordering.  Commits to disjoint shards tick
independently and never conflict: the paper's
footprints-only-conflict-when-they-overlap promise lifted from blocks to
shards.

Address routing: the global space is striped in spans of ``span``
words — global address ``a`` lives in span ``k = a // span``, which
shard ``k % n_shards`` stores at local address
``(k // n_shards) * span + a % span``.  At ``n_shards == 1`` the map is
the identity, so the sharded store is BIT-IDENTICAL to a solo
``MVStoreHandle`` on the same seeds.  Each shard's handle is built on
its device slice (``shard_devices``: every shard on the store's device,
or round-robin over a mesh's devices); on one card every shard shares
it and the partitioning still buys clock independence.

Transaction lifecycle (the two-level clock protocol):

  * ``begin`` pins a VECTOR of shard clocks — one sub-context per
    shard — under an epoch seqlock bracket: the pin loop re-reads the
    epoch sequence (odd = a cross-shard publish is mid-flight) and
    retries until it pinned a stable, even cut.  Single-shard commits
    never bump the sequence, so the common case costs two atomic loads.
  * reads/writes route to the owning shard and validate against that
    shard's pin (``read_bulk`` batches per shard through
    ``engine/bulkread.shard_partition``, or by span arithmetic for an
    address range, and reassembles in order, on the store's device).
  * commit with a SINGLE-shard footprint delegates to that shard's solo
    commit: no coordination, no epoch traffic.
  * commit SPANNING shards runs a two-phase epoch-stamped publish:
    acquire every involved shard's commit lock in ascending shard order
    (``engine/commit.acquire_ascending``), validate EVERY touched shard
    against its pin under the locks, park an ``EpochRecord``
    (``reliability/recovery.py``), bump the epoch seqlock odd, publish
    shard-locally through each shard's solo publish path (one
    ``commit_fused`` call each), then even the seqlock.

On the card each shard keeps its own ring-timestamp seqlock
(``api/mvhandle.py``), and every publish and every reader's gather is
issued on the one default stream, which runs them in issue order: a
reader whose ``begin`` saw an even, stable epoch sequence was issued
after every launch of each epoch it can see.
"""
from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.mvhandle import MVStoreHandle, _MVCtx
from repro_torch.api.substrate import SubstrateBase, Txn
from repro_torch.core import modes as M
from repro_torch.core.clock import AtomicInt
from repro_torch.core.engine import AbortTx, resolve_device
from repro_torch.core.engine.bulkread import as_addr_array, shard_partition
from repro_torch.core.engine.commit import acquire_ascending, as_value_list
from repro_torch.core.stats_schema import RECOVERY_STAT_KEYS, base_stats
from repro_torch.kernels._lib import to_device
from repro_torch.reliability import faultpoints as FP
from repro_torch.reliability.recovery import EpochRecord

__all__ = ["ShardStoreHandle", "shard_devices"]

_COUNTER_KEYS = ("commits", "aborts", "ro_commits", "versioned_commits")


def shard_devices(n_shards: int, mesh=None, device=None) -> List[Any]:
    """One device per shard: round-robin over a mesh's device slices
    (``launch.mesh.make_mesh``/``make_host_mesh``), or, without one,
    every shard on ``device`` (``None`` means the card and raises
    without CUDA)."""
    if mesh is not None:
        from repro_torch.launch.sharding import shard_device_slices
        return shard_device_slices(mesh, n_shards)
    return [resolve_device(device)] * n_shards


class _ShardCtx:
    """Store-level transaction context: one sub-context per shard plus
    the pinned vector of shard clocks (the epoch-consistent cut)."""

    __slots__ = ("tid", "subs", "pins", "active")

    def __init__(self, tid: int, subs: List[_MVCtx]):
        self.tid = tid
        self.subs = subs
        self.pins = tuple(c.read_clock for c in subs)
        self.active = True


class ShardStoreHandle(SubstrateBase):
    name = "shardstore"

    def __init__(self, n_threads: int = 1, *, n_shards: int = 2,
                 span: int = 64, cfg=None, params=None, controller=None,
                 versioned: str = "none", start_bg: bool = True,
                 mesh=None, device=None):
        from repro_torch.configs.base import MVStoreConfig
        from repro_torch.configs.paper_stm import MultiverseParams
        from repro_torch.core.mvcontroller import MVController

        if n_shards < 1 or span < 1:
            raise ValueError(f"n_shards ({n_shards}) and span ({span}) "
                             "must be positive")
        self.device = resolve_device(device)
        self.n_threads = n_threads
        self.n_shards = n_shards
        self._span = span
        self.cfg = cfg or MVStoreConfig(ring_slots=8)
        self.params = params or MultiverseParams()
        self.controller = controller or MVController(
            params=self.params, mvcfg=self.cfg, start_bg=start_bg)
        self._own_controller = controller is None
        # one solo handle per shard, each on its device slice, all
        # sharing ONE controller: the mode cycle is global (the paper's
        # single global mode), the clocks are per shard
        self._devices = shard_devices(n_shards, mesh, self.device)
        self._shards = [
            MVStoreHandle(n_threads, cfg=self.cfg, params=self.params,
                          controller=self.controller, versioned=versioned,
                          device=dev)
            for dev in self._devices]
        # the coarse level of the two-level clock: an epoch counter
        # (ticks once per cross-shard publish) and its seqlock (odd =
        # publish in flight; begin() pins only on even-and-stable)
        self._epoch = AtomicInt(0)
        self._epoch_seq = AtomicInt(0)
        self._epoch_inflight: Optional[EpochRecord] = None
        self._alloc_lock = threading.Lock()
        self._top = 0
        self._counters = [{k: 0 for k in _COUNTER_KEYS}
                          for _ in range(n_threads)]
        self._cross_commits = 0
        # durable commit log (reliability/wal.attach_wal sets this AND
        # each member shard's ``wal``/``wal_shard``): single-shard
        # commits journal through the member's solo publish, cross-shard
        # commits as one epoch (``_commit_cross``)
        self.wal = None
        self.recovery_counters = {k: 0 for k in RECOVERY_STAT_KEYS}

    # -- address routing --------------------------------------------------
    def _route(self, a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Global addresses -> (shard ids, shard-local addresses): the
        reference's ``k % n`` and ``(k // n) * g + a % g`` with two
        divisions where it takes four (numpy's ``//`` and ``%`` agree:
        ``x == (x // d) * d + x % d``), and none at one shard, where the
        map is the identity.  A 1M-word read spends its time here."""
        g, n = self._span, self.n_shards
        if n == 1:
            return np.zeros(a.size, np.int64), a
        k = a // g
        q = k // n
        return k - q * n, q * g + (a - k * g)

    def _route1(self, addr: int) -> Tuple[int, int]:
        g, n = self._span, self.n_shards
        k = addr // g
        return int(k % n), int((k // n) * g + (addr % g))

    def _local_top(self, s: int, top: int) -> int:
        """Shard ``s``'s heap size when the global heap has ``top`` words
        (spans round-robin, so local heaps stay contiguous prefixes)."""
        g, n = self._span, self.n_shards
        full, rem = divmod(top, g)
        local = (full // n + (1 if (full % n) > s else 0)) * g
        if full % n == s:
            local += rem
        return local

    def _split(self, addrs):
        """The batch grouped by shard: ``(a, [(s, local, pos)])``, one
        entry per shard it touches, ``local`` shard ``s``'s addresses in
        batch order and ``pos`` their batch positions, ascending.

        A unit-step ``range`` is split with no pass over its words: a
        shard's words in a contiguous global range are contiguous
        locally (its spans are consecutive local spans), so ``local`` is
        a ``range`` and ``pos`` is ``None`` until ``_gathered`` builds it
        after the gathers.  A whole-heap read then reaches each shard's
        ring right after its pin, as a one-shard read does; routing a
        million addresses one by one first can outlast a shallow ring's
        window under commit traffic, and the read aborts ungathered."""
        n = self.n_shards
        if isinstance(addrs, range) and addrs.step == 1 and addrs.start >= 0:
            lo, hi = addrs.start, max(addrs.stop, addrs.start)
            spans = [(s, range(self._local_top(s, lo), self._local_top(s, hi)))
                     for s in range(n)]
            return addrs, [(s, r, None) for s, r in spans if len(r)]
        a = as_addr_array(addrs)
        if a.size == 0:
            return a, []
        sid, local = self._route(a)
        if bool((sid == sid[0]).all()):
            return a, [(int(sid[0]), local, None)]
        return a, [(s, local[pos], pos) for s, pos in shard_partition(sid, n)]

    def _range_positions(self, s: int, batch: range) -> np.ndarray:
        """Batch positions of shard ``s``'s words in the unit-step range
        ``batch``: its spans laid end to end, the first and last cut to
        the range."""
        g, n = self._span, self.n_shards
        lo, hi = batch.start, batch.stop
        k0 = lo // g
        first = k0 + (s - k0) % n
        starts = np.arange(first * g, hi, n * g, dtype=np.int64)
        pos = (starts[:, None] + np.arange(g, dtype=np.int64)).reshape(-1)
        return pos[max(lo - first * g, 0):
                   pos.size - max(int(starts[-1]) + g - hi, 0)] - lo

    def _gathered(self, a, parts, dtype: torch.dtype):
        """Per-shard answers ``[(s, pos, values)]`` reassembled in batch
        order: one ``index_copy_`` per shard into a tensor on the store's
        device, or a host list when a shard's values are a list
        (buffered writes overlay its read).  ``pos`` is ``None`` where
        ``_split`` left it to be built: a range's, or the whole batch's
        when it lies on one shard."""
        if len(parts) == 1:             # the whole batch, in batch order
            vals = parts[0][2]
            return vals if isinstance(vals, list) else vals.to(self.device,
                                                               dtype)
        parts = [(self._range_positions(s, a) if pos is None else pos, vals)
                 for s, pos, vals in parts]
        if any(isinstance(v, list) for _, v in parts):
            out: list = [None] * len(a)
            for pos, vals in parts:
                vlist = vals if isinstance(vals, list) else vals.tolist()
                for p, v in zip(pos.tolist(), vlist):
                    out[p] = v
            return out
        out = torch.empty(len(a), dtype=dtype, device=self.device)
        for pos, vals in parts:
            out.index_copy_(0, to_device(pos, self.device),
                            vals.to(self.device, dtype))
        return out

    # -- Substrate protocol ----------------------------------------------
    def begin_operation(self, tid: int) -> None:
        for sh in self._shards:
            sh.begin_operation(tid)

    def begin(self, tid: int = 0) -> Txn:
        while True:
            s0 = self._epoch_seq.load()
            if s0 & 1:
                # a cross-shard publish is mid-flight: pinning now could
                # capture half an epoch — wait the bracket out
                time.sleep(0)
                continue
            subs = [sh.begin(tid)._ctx for sh in self._shards]
            if self._epoch_seq.load() == s0:
                break
            for c in subs:          # raced the bracket: discard the pins
                c.active = False
        return Txn(self, _ShardCtx(tid, subs), tid)

    def read(self, ctx: _ShardCtx, addr: int) -> Any:
        s, local = self._route1(addr)
        try:
            return self._shards[s].read(ctx.subs[s], local)
        except AbortTx:
            self._fail(ctx)
            raise

    def read_bulk(self, ctx: _ShardCtx, addrs) -> Any:
        """One gather per shard the batch touches (a ``gather_read``
        launch each on the card).  A one-shard batch returns that
        shard's answer; a spanning one an int32 tensor on the store's
        device, or a list where buffered writes overlay the read."""
        try:
            a, parts = self._split(addrs)
            if len(parts) <= 1:                 # one shard: one gather
                s, local, _ = parts[0] if parts else (0, a, None)
                return self._shards[s].read_bulk(ctx.subs[s], local)
            got = [(s, pos, self._shards[s].read_bulk(ctx.subs[s], local))
                   for s, local, pos in parts]
            return self._gathered(a, got, torch.int32)
        except AbortTx:
            self._fail(ctx)
            raise

    def write(self, ctx: _ShardCtx, addr: int, value: Any) -> None:
        s, local = self._route1(addr)
        try:
            self._shards[s].write(ctx.subs[s], local, value)
        except AbortTx:
            self._fail(ctx)
            raise

    def write_bulk(self, ctx: _ShardCtx, addrs, values) -> None:
        a = as_addr_array(addrs)
        if a.size == 0:
            return
        sid, local = self._route(a)
        try:
            if bool((sid == sid[0]).all()):
                s = int(sid[0])
                self._shards[s].write_bulk(ctx.subs[s], local, values)
                return
            vlist = as_value_list(values)
            for s, pos in shard_partition(sid, self.n_shards):
                self._shards[s].write_bulk(
                    ctx.subs[s], local[pos],
                    [vlist[p] for p in pos.tolist()])
        except AbortTx:
            self._fail(ctx)
            raise

    def txn_alloc(self, ctx: _ShardCtx, n: int, init: Any = None) -> int:
        return self.alloc(n, init)

    def read_count(self, ctx: _ShardCtx) -> int:
        return sum(c.read_cnt for c in ctx.subs)

    def validate(self, ctx: _ShardCtx) -> bool:
        return all(sh.validate(c)
                   for sh, c in zip(self._shards, ctx.subs))

    # -- commit -----------------------------------------------------------
    def _touched(self, ctx: _ShardCtx) -> List[int]:
        return [s for s, c in enumerate(ctx.subs)
                if c.read_cnt or c.write_buf]

    def commit(self, txn: Txn) -> None:
        ctx = txn._ctx
        c = self._counters[ctx.tid]
        subs = ctx.subs
        write_shards = [s for s, sc in enumerate(subs) if sc.write_buf]
        touched = self._touched(ctx)
        if not write_shards:
            # read-only: each touched shard commits locally (feeding the
            # K1/K2/K3 heuristics); pins are immutable, no coordination
            for s in touched:
                self._shards[s].commit(Txn(self._shards[s], subs[s],
                                           ctx.tid))
            if any(subs[s].versioned for s in touched):
                c["versioned_commits"] += 1
            c["ro_commits"] += 1
            self._deactivate(ctx)
            return
        if len(touched) == 1:
            # a single-shard footprint commits with NO cross-shard
            # coordination — the solo pipeline verbatim (shard==1
            # bit-identity rides this path)
            s = touched[0]
            try:
                self._shards[s].commit(Txn(self._shards[s], subs[s],
                                           ctx.tid))
            except AbortTx:
                self._fail(ctx)
                raise
        else:
            self._commit_cross(ctx, touched, write_shards)
            self._cross_commits += 1
        c["commits"] += 1
        self._deactivate(ctx)

    def _commit_cross(self, ctx: _ShardCtx, touched: List[int],
                      write_shards: List[int]) -> None:
        """Two-phase epoch-stamped publish across shards.

        Phase 1 (validate): under EVERY touched shard's commit lock
        (ascending order — deadlock-free), check each shard's block
        stamp against this transaction's pin.  Phase 2 (publish): park
        the ``EpochRecord``, bump the epoch seqlock odd, drive each
        write shard's solo publish, even the seqlock.  A crash in phase
        2 leaves the record parked and the sequence odd, which keeps new
        pins out (``begin`` spins) until a recovery resolves the epoch.
        """
        subs = ctx.subs
        shards = self._shards
        if FP.ACTIVE is not None:
            FP.fire("pre_claim", ctx.tid)
        with acquire_ascending([shards[s]._commit_lock for s in touched]):
            if (self._epoch_inflight is not None
                    or any(shards[s]._check_conflict(subs[s])
                           for s in touched)):
                # fail closed on an unrecovered epoch, abort on conflict
                self._abort_cross(ctx, touched)
            if FP.ACTIVE is not None:
                FP.fire("post_claim", ctx.tid)
            rec = EpochRecord(
                epoch=self._epoch.increment(),
                write_shards=tuple(write_shards),
                pins={s: int(shards[s]._state.clock)
                      for s in write_shards},
                ctxs={s: subs[s] for s in write_shards},
                tid=ctx.tid)
            if self.wal is not None:
                # the epoch's durable twin: one PREPARE per write shard
                # (each carrying that shard's redo image + pinned clock)
                # under ONE group DECIDE — a restart replays the epoch
                # all-or-nothing across shards (wal.recover_from_wal)
                recs = []
                for s in write_shards:
                    wb = subs[s].write_buf
                    idx = sorted(wb)
                    recs.append((ctx.tid, idx, [wb[i] for i in idx],
                                 (rec.pins[s] + 1,), rec.epoch, s))
                rec.wal_lsns = tuple(self.wal.append_prepare_group(recs))
            self._epoch_inflight = rec
            self._epoch_seq.increment()        # odd: begin() waits
            try:
                if FP.ACTIVE is not None:
                    FP.fire("pre_clock_tick", ctx.tid)
                if self.wal is not None:
                    self.wal.append_decide_group(rec.wal_lsns)
                rec.publish_started = True     # the epoch commit record
                for s in write_shards:
                    # members must not re-journal solo records — the
                    # EPOCH is the durable unit
                    shards[s]._publish_locked(subs[s], wal_log=False)
                    rec.published.append(s)
                if FP.ACTIVE is not None:
                    FP.fire("pre_release", ctx.tid)
                self._epoch_inflight = None
                if self.wal is not None:
                    for lsn in rec.wal_lsns:
                        self.wal.append_complete(lsn)
            finally:
                if self._epoch_inflight is None:
                    self._epoch_seq.increment()    # even: bracket closed
                # else: crashed mid-epoch — the record stays parked and
                # the sequence odd until a recovery resolves it

    # -- abort bookkeeping -------------------------------------------------
    def _deactivate(self, ctx: _ShardCtx) -> None:
        for c in ctx.subs:
            c.active = False
        ctx.active = False

    def _fail(self, ctx: _ShardCtx) -> None:
        """A shard-level abort surfaced: the shard already did its own
        accounting/heuristics; record ONE logical abort and retire every
        sub-context."""
        self._counters[ctx.tid]["aborts"] += 1
        self._deactivate(ctx)

    def _abort_cross(self, ctx: _ShardCtx, touched: List[int]) -> None:
        for s in touched:
            try:
                self._shards[s]._abort_ctx(ctx.subs[s])
            except AbortTx:
                pass
        self._fail(ctx)
        raise AbortTx()

    def abort(self, txn: Txn) -> None:
        ctx = txn._ctx
        if not getattr(ctx, "active", False):
            return
        for s in self._touched(ctx):
            if ctx.subs[s].active:
                try:
                    self._shards[s]._abort_ctx(ctx.subs[s])
                except AbortTx:
                    pass
        self._fail(ctx)

    # -- heap --------------------------------------------------------------
    def alloc(self, n: int, init: Any = None) -> int:
        """Grow the global heap by ``n`` words: each shard whose local
        top moves grows its block on its own device."""
        with self._alloc_lock:
            base = self._top
            new_top = base + n
            for s, sh in enumerate(self._shards):
                need = self._local_top(s, new_top)
                have = self._local_top(s, base)
                if need > have:
                    got = sh.alloc(need - have, init)
                    if got != have:
                        raise RuntimeError(
                            f"shard {s} grew from {got}, expected {have}")
            self._top = new_top
        return base

    def peek(self, addr: int) -> Any:
        s, local = self._route1(addr)
        return self._shards[s].peek(local)

    def snapshot_bulk(self, addrs, read_clock=None):
        """``(values, ok)`` at a pinned cut: values an int64 tensor on the
        store's device.

        ``read_clock`` is ``None`` (now), one int (the same clock on
        every shard), or a per-shard vector — the pin a transaction's
        ``ctx.pins`` carries, so a recovery check can replay any epoch's
        cut."""
        a, parts = self._split(addrs)
        got = []
        for s, local, pos in parts:
            rc = (read_clock if read_clock is None
                  or isinstance(read_clock, (int, np.integer))
                  else read_clock[s])
            vals, ok = self._shards[s].snapshot_bulk(local, rc)
            if not ok:
                return None, False
            got.append((s, pos, vals))
        return self._gathered(a, got, torch.int64), True

    # -- accessors ---------------------------------------------------------
    @property
    def clocks(self) -> Tuple[int, ...]:
        """The per-shard clock vector (the fine level)."""
        return tuple(sh.clock for sh in self._shards)

    @property
    def clock(self) -> int:
        """Total commits across shards — one monotone scalar for callers
        that want a single progress clock."""
        return sum(self.clocks)

    @property
    def epoch(self) -> int:
        """The coarse epoch clock (ticks once per cross-shard publish)."""
        return self._epoch.load()

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> dict:
        out = base_stats(backend=self.name,
                         mode=M.mode_name(self.controller.mode_counter))
        for c in self._counters:
            for k in _COUNTER_KEYS:
                out[k] += c[k]
        out["mode_cas"] = sum(h.stats["mode_cas"]
                              for sh in self._shards
                              for h in sh._readers)
        out["mode_transitions"] = self.controller.stats["mode_transitions"]
        out["unversioned_buckets"] = self.controller.stats[
            "blocks_unversioned"]
        out["n_shards"] = self.n_shards
        out["cross_shard_commits"] = self._cross_commits
        out["epoch"] = self.epoch
        for k, v in self.recovery_counters.items():
            out[k] += v
        return out

    def stop(self) -> None:
        if self._own_controller:
            self.controller.stop()
