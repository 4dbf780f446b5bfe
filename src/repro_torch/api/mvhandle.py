"""MVStoreHandle — the Layer-B MVStore behind the same Substrate protocol.

Wraps `mv_init/mv_commit_fused/mv_snapshot` plus an `MVController` in
the begin/read/write/commit vocabulary of `repro_torch.api`, so a
snapshot read is literally a read-only transaction:

  * the heap is ONE parameter block (an int32 vector on the store's
    device); `alloc` grows it, `Txn.read/write` index into it;
  * an update transaction buffers writes (TL2-style) and publishes them
    as one `mv_commit_fused` under a single-writer lock — the
    optimizer-step analogue — validating that no commit has stamped the
    block past its begin snapshot;
  * a read-only transaction validates the clock on the unversioned path
    (the Mode-Q reader that aborts when the writer commits first) and
    resolves ring versions at its read clock on the versioned path;
  * aborts feed the SAME K1/K2/K3 heuristics as the word level, via
    `MVController.ReaderHandle`.

The reader rule.  Torch tensors are mutable and nothing is donated, so
the reference's "a commit deleted the buffer under a reader -> abort"
has no trigger here; the port's rule instead:

  * LIVE BLOCK: every commit builds a new block OUT OF PLACE
    (``commit_fused``), so a reader's snapshot of the block stays whole
    for as long as it holds it.
  * RING: a commit refreshes slot ``clock' % R`` IN PLACE.  The handle
    keeps a host copy of the ring timestamps (``_snap[3]``) and treats
    it as a seqlock per slot: the publisher sets the slot's host
    timestamp to NO_TS BEFORE it enqueues the refresh and to the new
    clock after; a ring reader picks its slot from a copy of the host
    timestamps, enqueues its gather, and then re-reads the slot's host
    timestamp — a change means a refresh was enqueued before its gather
    could run, and the reader aborts (outside a transaction it retries).
    Device operations run in host issue order on the one stream
    (``kernels/_lib.py``), so a gather enqueued before the refresh reads
    the whole old row and one enqueued after the invalidation is caught:
    a reader never returns a row mixed from two versions.
"""
from __future__ import annotations

import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.substrate import SubstrateBase, Txn
from repro_torch.core import modes as M
from repro_torch.core.engine import AbortTx, resolve_device
from repro_torch.core.engine.bulkread import as_addr_array, gather_row
from repro_torch.core.engine.commit import as_value_list
from repro_torch.core.stats_schema import RECOVERY_STAT_KEYS, base_stats
from repro_torch.reliability import faultpoints as FP

__all__ = ["MVStoreHandle"]

_COUNTER_KEYS = ("commits", "aborts", "ro_commits", "versioned_commits")

_RACED = object()   # a ring read lost the race against a slot refresh

NO_TS = -1


def _ring_slot(ring_ts, read_clock: int) -> Optional[int]:
    """Newest ring slot with a timestamp at/below ``read_clock``, or
    ``None`` when the clock fell out of the ring window (the one place
    the slot-selection idiom lives: scalar read, bulk read,
    ``snapshot_bulk`` and ``validate`` all route here)."""
    if ring_ts is None:
        return None
    valid = (ring_ts != NO_TS) & (ring_ts <= read_clock)
    if not valid.any():
        return None
    return int(np.argmax(np.where(valid, ring_ts, NO_TS)))


class _MVCtx:
    """Per-transaction context at the store level."""

    __slots__ = ("tid", "read_clock", "write_buf", "read_only", "read_cnt",
                 "active", "versioned")

    def __init__(self, tid: int):
        self.tid = tid
        self.read_clock = 0
        self.write_buf: dict = {}
        self.read_only = True
        self.read_cnt = 0
        self.active = False
        self.versioned = False


class MVStoreHandle(SubstrateBase):
    name = "mvstore"

    def __init__(self, n_threads: int = 1, *, cfg=None, params=None,
                 controller=None, versioned: str = "none",
                 start_bg: bool = True, device=None):
        from repro_torch.configs.base import MVStoreConfig
        from repro_torch.configs.paper_stm import MultiverseParams
        from repro_torch.core import mvstore
        from repro_torch.core.mvcontroller import MVController

        self._mvstore = mvstore
        self.device = resolve_device(device)
        self.n_threads = n_threads
        self.cfg = cfg or MVStoreConfig(ring_slots=8)
        self.params = params or MultiverseParams()
        self.controller = controller or MVController(
            params=self.params, mvcfg=self.cfg, start_bg=start_bg)
        self._own_controller = controller is None
        self._key = "heap"
        live = {self._key: torch.zeros((0,), dtype=torch.int32,
                                       device=self.device)}
        self._path = mvstore.block_paths(live)[0]
        self._commit_lock = threading.Lock()
        # crash-recovery slot (reliability/recovery.recover_handle): from
        # the return of the ``commit_fused`` call — which already
        # refreshed the ring slot and its timestamp IN PLACE — until
        # ``_install``, the new state (block, clock) is parked here, so a
        # crash in that window completes the install instead of leaving
        # a ring slot newer than the clock
        self._inflight = None
        # durable commit log (reliability/wal.py, via attach_wal): when
        # set, _publish_locked appends PREPARE + fsync'd DECIDE before
        # the fused call is enqueued
        self.wal = None
        self.wal_shard = -1
        self.recovery_counters = {k: 0 for k in RECOVERY_STAT_KEYS}
        self._readers = [self.controller.reader() for _ in range(n_threads)]
        self._counters = [{k: 0 for k in _COUNTER_KEYS}
                          for _ in range(n_threads)]
        self._no_version = [False] * n_threads
        self._state = None
        self._snap: Tuple = (0, live[self._key], None, None)
        self._install(mvstore.mv_init(live, self.cfg, versioned=versioned))

    # -- state installation ----------------------------------------------
    def _install(self, state) -> None:
        """Publish a new MVStoreState plus the reader-visible snapshot
        ``(clock, live block, ring, host ring timestamps)`` — one tuple
        replaced wholesale.  The host timestamps are one array per ring
        tensor, kept across commits (the seqlock of the module
        docstring) and rebuilt from the device only for a new ring."""
        ring = state.ring.get(self._path)
        if ring is None:
            snap = (int(state.clock), state.live[self._key], None, None)
        else:
            old = self._snap
            host_ts = old[3] if old[2] is ring else \
                state.ring_ts[self._path].cpu().numpy().copy()
            snap = (int(state.clock), state.live[self._key], ring, host_ts)
        self._state = state
        self._snap = snap

    def _ring_read(self, fn, ring_ts, read_clock: int):
        """``fn(slot)`` for the slot ``read_clock`` selects, under the
        seqlock check: ``None`` when the clock fell out of the ring
        window, ``_RACED`` when the slot was refreshed around the read."""
        ts = ring_ts.copy()
        slot = _ring_slot(ts, read_clock)
        if slot is None:
            return None
        out = fn(slot)
        if ring_ts[slot] != ts[slot]:
            return _RACED
        return out

    # -- Substrate protocol ----------------------------------------------
    def begin_operation(self, tid: int) -> None:
        # no_versioning is per OPERATION: a versioned txn that writes must
        # restart unversioned, and must not be re-promoted on the next
        # abort of the same operation (the word-level livelock guard)
        self._no_version[tid] = False

    def begin(self, tid: int = 0) -> Txn:
        h = self._readers[tid]
        if self._no_version[tid]:
            h.versioned = False
        snap = self._snap
        ctx = _MVCtx(tid)
        ctx.read_clock = snap[0]
        h.begin(ctx.read_clock)
        ctx.versioned = h.versioned
        ctx.active = True
        return Txn(self, ctx, tid)

    def _versioned_read(self, ctx: _MVCtx, fn):
        """A versioned read-only transaction's ring read (seqlocked);
        aborts when the clock left the window or a refresh raced it."""
        clock, live, ring, ring_ts = self._snap
        if ring is None:
            # Mode-Q reader versions the block itself (paper SS4.1's
            # reader-triggered versioning, at block granularity)
            clock, live, ring, ring_ts = self._version_block()
        out = self._ring_read(lambda slot: fn(ring[slot]), ring_ts,
                              ctx.read_clock)
        if out is None or out is _RACED:
            self._abort_ctx(ctx)
        return out

    def read(self, ctx: _MVCtx, addr: int) -> Any:
        ctx.read_cnt += 1
        if addr in ctx.write_buf:
            return ctx.write_buf[addr]
        if ctx.versioned and ctx.read_only:
            return self._versioned_read(ctx, lambda row: row[addr].item())
        # unversioned (Mode-Q reader / writer encounter read): validate
        # that no commit has advanced the clock past our begin snapshot
        clock, live, _, _ = self._snap
        if clock > ctx.read_clock:
            self._abort_ctx(ctx)
        return live[addr].item()

    def read_bulk(self, ctx: _MVCtx, addrs) -> Any:
        """`Txn.read_bulk` at the store level: one gather per batch — of
        the live block on the unversioned path (after the same clock
        check every scalar read makes), or of the ONE ring row the
        reader's clock selects on the versioned path; a ``gather_read``
        launch (int32) on the card.  Returns an int32 tensor on the
        store's device, or a list when buffered writes overlay it."""
        a = as_addr_array(addrs)
        ctx.read_cnt += a.size
        if ctx.versioned and ctx.read_only:
            vals = self._versioned_read(ctx, lambda row: gather_row(row, a))
        else:
            clock, live, _, _ = self._snap
            if clock > ctx.read_clock:
                self._abort_ctx(ctx)
            vals = gather_row(live, a)
        if ctx.write_buf:
            return [ctx.write_buf.get(int(x), v)
                    for x, v in zip(a, vals.tolist())]
        return vals

    def write(self, ctx: _MVCtx, addr: int, value: Any) -> None:
        if ctx.versioned:
            # versioned reads are of the PAST and cannot anchor writes to
            # the present: restart on the unversioned path, sticky for
            # this operation (mirrors Multiverse.tm_write)
            self._no_version[ctx.tid] = True
            self._abort_ctx(ctx)
        ctx.read_only = False
        ctx.write_buf[addr] = value

    def write_bulk(self, ctx: _MVCtx, addrs, values) -> None:
        """`Txn.write_bulk` at the store level: writes buffer until the
        single publish, so the batch is one dict update."""
        if ctx.versioned:
            self._no_version[ctx.tid] = True
            self._abort_ctx(ctx)
        ctx.read_only = False
        ctx.write_buf.update(zip((int(a) for a in as_addr_array(addrs)),
                                 as_value_list(values)))

    def txn_alloc(self, ctx: _MVCtx, n: int, init: Any = None) -> int:
        # applied immediately, NOT rolled back on abort: block shapes are
        # step-boundary state at this layer
        return self.alloc(n, init)

    def _version_block(self) -> Tuple:
        """Seed a ring for the heap block with the live value, at
        firstObsModeUTs when valid, else the current clock (paper
        SS4.2)."""
        with self._commit_lock:
            state = self._state
            if self._path not in state.ring:
                state = self._mvstore.version_blocks(
                    state, {self._path}, self.cfg,
                    first_obs_mode_u_ts=self.controller.first_obs_mode_u_ts)
                self._install(state)
        return self._snap

    def commit(self, txn: Txn) -> None:
        ctx = txn._ctx
        h = self._readers[ctx.tid]
        c = self._counters[ctx.tid]
        if ctx.read_only:
            c["ro_commits"] += 1
            if ctx.versioned:
                c["versioned_commits"] += 1
            h.on_commit(ctx.read_cnt, commit_clock=self._snap[0])
            ctx.active = False
            return
        conflict = False
        with self._commit_lock:
            if self._check_conflict(ctx):
                conflict = True            # another step committed first
            else:
                self._publish_locked(ctx)
        if conflict:
            self._abort_ctx(ctx)
        c["commits"] += 1
        h.attempts = 0
        ctx.active = False

    def _check_conflict(self, ctx: _MVCtx) -> bool:
        """Commit-time validation, ``self._commit_lock`` held: has the
        block been committed past this transaction's begin pin?"""
        return self._mvstore.blocks_conflict(
            self._state, (self._path,), ctx.read_clock)

    def _publish_locked(self, ctx: _MVCtx, wal_log: bool = True) -> None:
        """The publish half of commit, ``self._commit_lock`` held and
        validation passed: ONE ``mv_commit_fused`` — the new block out of
        place through the ``commit_fused`` kernel, the ring slot refreshed
        in place inside the seqlock bracket (module docstring).  Also the
        recovery redo entry point: the cross-shard epoch roll-forward and
        the WAL replay drive a parked context through exactly this path
        with ``wal_log=False`` (replay must not re-journal itself; the
        cross-shard caller journals the EPOCH instead)."""
        if FP.ACTIVE is not None:
            FP.fire("pre_clock_tick", ctx.tid)
        state = self.controller.trainer_tick(self._state)
        mode = self.controller.current_local_mode()
        idx = np.array(sorted(ctx.write_buf), dtype=np.int64)
        vals = np.array([int(ctx.write_buf[int(i)]) for i in idx],
                        dtype=np.int64)
        lsn = None
        if wal_log and self.wal is not None and idx.size:
            # PREPARE + DECIDE before the fused call: from the kernel on,
            # the block, the ring slot and the clock change, so the WAL
            # record is what a whole-process crash recovers from
            lsn = self.wal.append_prepare(
                ctx.tid, idx, vals,
                clocks=(int(self._state.clock) + 1,),
                shard=self.wal_shard)
            self.wal.append_decide(lsn)
        _, _, ring, host_ts = self._snap
        slot = None
        if ring is not None and state.ring.get(self._path) is ring:
            slot = (int(state.clock) + 1) % self.cfg.ring_slots
            host_ts[slot] = NO_TS          # readers of this slot now abort
        state = self._mvstore.mv_commit_fused(
            state, self._key, idx, vals, local_mode=mode, cfg=self.cfg)
        self._inflight = state
        if slot is not None:
            host_ts[slot] = int(state.clock)
        if FP.ACTIVE is not None:
            FP.fire("post_scatter", ctx.tid)
            FP.fire("pre_release", ctx.tid)
        self._install(state)
        self._inflight = None
        if lsn is not None:
            self.wal.append_complete(lsn)

    def abort(self, txn: Txn) -> None:
        ctx = txn._ctx
        if not getattr(ctx, "active", False):
            return
        try:
            self._abort_ctx(ctx)
        except AbortTx:
            pass

    def validate(self, ctx: _MVCtx) -> bool:
        """`Txn.validate_bulk` at the store level (read-only check):
        unversioned transactions are valid while no commit has advanced
        the clock past their begin snapshot; versioned readers while the
        ring still holds a slot at/below their read clock."""
        clock, live, ring, ring_ts = self._snap
        if ctx.versioned and ctx.read_only:
            if ring_ts is None:
                return True               # block not versioned yet
            return _ring_slot(ring_ts.copy(), ctx.read_clock) is not None
        return clock <= ctx.read_clock

    def _abort_ctx(self, ctx: _MVCtx) -> None:
        self._counters[ctx.tid]["aborts"] += 1
        h = self._readers[ctx.tid]
        if ctx.read_only:
            # read-only aborts drive the paper's heuristics (K1 go-
            # versioned, K2/K3 mode CAS, block-versioning requests)
            h.on_abort(ctx.read_cnt, wanted_blocks=(self._path,))
        else:
            h.attempts += 1
        ctx.active = False
        raise AbortTx()

    # -- heap -------------------------------------------------------------
    def alloc(self, n: int, init: Any = None) -> int:
        fill = 0 if init is None else int(init)
        with self._commit_lock:
            state = self._state
            live = state.live[self._key]
            base = int(live.shape[0])
            was_versioned = self._path in state.ring
            new_live = {self._key: torch.cat(
                [live, torch.full((n,), fill, dtype=live.dtype,
                                  device=live.device)])}
            state = self._mvstore.MVStoreState(
                live=new_live, ring={}, ring_ts={}, clock=state.clock,
                block_clocks=state.block_clocks)
            if was_versioned:   # reseed the ring at the new block shape
                state = self._mvstore.version_blocks(
                    state, {self._path}, self.cfg,
                    first_obs_mode_u_ts=self.controller.first_obs_mode_u_ts)
            self._install(state)
        return base

    def peek(self, addr: int) -> Any:
        return self._snap[1][addr].item()

    # -- Layer-B extras ----------------------------------------------------
    def snapshot(self, read_clock: Optional[int] = None):
        """(params_view, ok) via mv_snapshot — the functional spelling of a
        read-only transaction at `read_clock` (default: now).  Taken under
        the commit lock, so no ring refresh runs beside it."""
        with self._commit_lock:
            state = self._state
            if read_clock is None:
                read_clock = int(state.clock)
            return self._mvstore.mv_snapshot(state, read_clock)

    def snapshot_bulk(self, addrs, read_clock: Optional[int] = None):
        """``(values, ok)``: batched snapshot read outside any transaction.

        The current clock serves from the live block; a stale clock
        resolves through the ring (``ok`` False when the block is
        unversioned or the clock fell out of the ring window — the cases
        a transactional reader would abort on).  A read that raced a
        ring refresh retries.
        """
        a = as_addr_array(addrs)
        while True:
            clock, live, ring, ring_ts = self._snap
            if read_clock is None or read_clock >= clock:
                return gather_row(live, a), True
            if ring is None:
                return None, False
            vals = self._ring_read(lambda slot: gather_row(ring[slot], a),
                                   ring_ts, read_clock)
            if vals is None:
                return None, False
            if vals is not _RACED:
                return vals, True

    @property
    def state(self):
        """The underlying MVStoreState."""
        return self._state

    @property
    def clock(self) -> int:
        return self._snap[0]

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> dict:
        out = base_stats(backend=self.name,
                         mode=M.mode_name(self.controller.mode_counter))
        for c in self._counters:
            for k in _COUNTER_KEYS:
                out[k] += c[k]
        out["mode_cas"] = sum(h.stats["mode_cas"] for h in self._readers)
        out["mode_transitions"] = self.controller.stats["mode_transitions"]
        out["unversioned_buckets"] = self.controller.stats[
            "blocks_unversioned"]
        for k, v in self.recovery_counters.items():
            out[k] += v
        return out

    def stop(self) -> None:
        if self._own_controller:
            self.controller.stop()
