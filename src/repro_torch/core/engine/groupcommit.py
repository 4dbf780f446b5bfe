"""Group commit: publish batches of conflict-disjoint transactions at
one clock tick through the fused commit path.

A single commit is one batched pipeline (``engine/commit.py``); this
module batches ACROSS transactions.  The paper's serialization argument (and the
multi-version conflict notion it builds on) says transactions whose
conflict sets are disjoint serialize freely — so N ready commits whose
footprints do not overlap can share one atomicity bracket, one clock
tick and one publish sweep instead of N of each:

  * ``CommitBatcher.add`` collects ready transactions (engine ``_Tx``
    handles, substrate ``Txn`` wrappers or raw descriptors);
  * ``commit_all`` partitions them into conflict-disjoint groups via
    vectorized lock-index intersection (``partition_disjoint``).  The
    conflict rule is ``write_i ∩ (read_j ∪ write_j) = ∅`` for i != j —
    write-write AND write-read overlaps separate transactions; read-read
    overlap is harmless.  Write-set-only disjointness would be UNSOUND:
    two members each reading what the other writes have no serial order
    at a shared commit version;
  * each multi-member group publishes through the fused commit math
    (``kernels/commit_fused``): gather + verdict + claim under ONE
    hoisted stripe window (``ArrayLockTable.striped`` — the batched
    spelling of ``try_lock_bulk``'s CAS bracket), ONE
    ``clock.increment()``, one heap scatter for every surviving
    member's writes, one release sweep stamping the shared version.
    The verdict is decided on the host (``np_commit_decide``) over the
    lock words gathered inside the window; on an ``ArrayHeap`` the
    publish is one ``commit_fused`` call over the engine heap, in place
    (the CUDA kernel on the card, its plain version on the CPU), fed
    the SAME words the host verdict read, and its verdict must equal
    the host's (see ``_publish``); its release words are what the
    release sweep stores.  An object heap scatters through
    ``heap_scatter``;
  * anything it cannot prove safe — colliding footprints, encounter
    descriptors holding locks mid-undo, irrevocable or versioned
    transactions, policies that never opted in — falls back to TODAY'S
    solo pipeline (``eng._try_commit``), so grouping is an optimization
    of the ready-batch case, never a semantic change
    (``tests/test_torch_groupcommit.py`` pins group == solo results).

Ordering proof sketch for the buffered (TL2) group: the stripe window
makes verdict + claim atomic, which is at least as strong as solo TL2's
acquire-then-revalidate (both observe a state where every write lock is
held and every read entry validated at the member's own ``r_clock``).
``wv`` is fetched AFTER the claim — a reader beginning after the
increment sees either our locks or our released version ``wv <= its
r_clock`` with the new values, never a torn mix (the same GV4 argument
as the solo pipeline, hoisted over the group).  Failed members are
never claimed and never scattered: they abort individually with the
heap and their group-mates untouched.

Policies opt in via ``group_commit``: ``"buffered"`` (TL2 — full
claim + validate + scatter + stamp) or ``"encounter"`` (DCTL — locks
already held, so the group is one fused validation plus one release
sweep at the deferred clock's current value, the exact solo release).
"""
from __future__ import annotations

from itertools import chain
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.engine import commit as C
from repro_torch.core.engine.arrayheap import ArrayHeap
from repro_torch.core.engine.errors import AbortTx
from repro_torch.kernels import commit_fused as CF
from repro_torch.kernels._lib import to_host
from repro_torch.kernels.commit_fused import np_commit_decide, pack_segments
from repro_torch.reliability import faultpoints as FP

__all__ = ["CommitBatcher", "ShardedCommitBatcher", "partition_disjoint"]


def partition_disjoint(write_sets: List[np.ndarray],
                       read_sets: List[np.ndarray]) -> List[List[int]]:
    """Partition into conflict-disjoint groups via one vectorized sweep.

    ``write_sets[i]`` / ``read_sets[i]`` are transaction ``i``'s lock
    indices (any order, within-transaction duplicates allowed — a hash
    collision within one transaction is one lock word claimed once).
    Conflict rule: ``write_i ∩ (read_j ∪ write_j) != ∅`` for ``i != j``
    — cross-transaction collisions on a lock word count even when the
    heap addresses differ, because colliding addresses share the word.

    Fast path (the expected batch): lock indices are table slots, so a
    dense ``bincount`` over the concatenated write indices finds any
    duplicate in O(batch + table) with no sort at all — zero duplicates
    means no write-write conflict is possible, and a dense owner map
    resolves the read probe with one fancy gather.  A batch with ANY
    repeated write index (cross-owner = a real conflict; within one
    transaction = a hash collision claiming one word once) or with
    indices too sparse for a dense table falls to one argsort sweep,
    and only a genuinely conflicted batch takes the quadratic first-fit
    fallback.  Singleton groups are committed solo by the batcher, so
    overlapping transactions degrade to exactly today's pipeline.
    """
    n = len(write_sets)
    if n == 0:
        return []
    sizes = np.fromiter((a.size for a in write_sets), np.int64, n)
    all_w = np.concatenate(write_sets)
    w_own = np.repeat(np.arange(n), sizes)
    conflict = None
    hi = int(all_w.max(initial=-1)) + 1
    if 0 <= hi <= (1 << 18) and int(all_w.min(initial=0)) >= 0:
        counts = np.bincount(all_w, minlength=hi)
        # dup check via a gather back through the batch — O(batch), not
        # a full-table scan
        if not (counts[all_w] > 1).any():
            conflict = False
            nz = [i for i, r in enumerate(read_sets) if r.size]
            if nz and all_w.size:
                # every written index is unique, so a dense last-writer
                # map IS the owner map
                own_map = np.empty(hi, np.int64)
                own_map[all_w] = w_own
                all_r = np.concatenate([read_sets[i] for i in nz])
                r_own = np.repeat(
                    np.asarray(nz, np.int64),
                    np.fromiter((read_sets[i].size for i in nz),
                                np.int64, len(nz)))
                inb = (all_r >= 0) & (all_r < hi)
                pos = np.where(inb, all_r, 0)
                hit = inb & (counts[pos] > 0)
                conflict = bool((hit & (own_map[pos] != r_own)).any())
    if conflict is None:
        # sparse or duplicated indices: one sort sweep.  Any equal-value
        # run spanning two owners yields SOME adjacent cross-owner pair
        # regardless of sort stability.
        order = np.argsort(all_w)
        sw, so = all_w[order], w_own[order]
        dup = sw[1:] == sw[:-1]
        conflict = bool((dup & (so[1:] != so[:-1])).any())
        if not conflict:
            nz = [i for i, r in enumerate(read_sets) if r.size]
            if nz and sw.size:
                all_r = np.concatenate([read_sets[i] for i in nz])
                r_own = np.repeat(
                    np.asarray(nz, np.int64),
                    np.fromiter((read_sets[i].size for i in nz),
                                np.int64, len(nz)))
                # no write-write conflict => each written value has one
                # owner, so any slot of its equal run identifies it
                pos = np.clip(np.searchsorted(sw, all_r), 0, sw.size - 1)
                hit = sw[pos] == all_r
                conflict = bool((hit & (so[pos] != r_own)).any())
    if not conflict:
        return [list(range(n))]

    # slow path: first-fit greedy over unique sets (conflicted batch)
    groups: List[dict] = []
    for i in range(n):
        w = np.unique(write_sets[i])
        rw = np.union1d(w, read_sets[i])
        placed = False
        for g in groups:
            if np.intersect1d(w, g["rw"], assume_unique=True).size:
                continue
            if np.intersect1d(rw, g["w"], assume_unique=True).size:
                continue
            g["members"].append(i)
            g["w"] = np.union1d(g["w"], w)
            g["rw"] = np.union1d(g["rw"], rw)
            placed = True
            break
        if not placed:
            groups.append({"members": [i], "w": w, "rw": rw})
    return [g["members"] for g in groups]


_EMPTY = np.zeros((0,), np.int64)


def _read_arrays(d):
    rs = d.read_set
    if not rs:
        return _EMPTY, _EMPTY
    idx = np.fromiter((p[0] for p in rs), np.int64, len(rs))
    seen = np.fromiter((p[1] for p in rs), np.int64, len(rs))
    return idx, seen


class CommitBatcher:
    """Collects ready transactions and commits them in disjoint groups.

    ``add`` accepts whatever the caller holds — an engine ``_Tx``, a
    substrate ``Txn`` or a raw descriptor; ``commit_all`` returns one
    bool per added transaction (add order): True committed, False
    aborted (the descriptor is rolled back; the caller owns the retry).
    ``stats`` counts how the batch split: ``grouped`` members published
    through fused group windows, ``solo`` through the fallback
    pipeline, ``groups`` fused windows executed, ``failed`` aborts.
    """

    def __init__(self, eng: Any):
        self.eng = getattr(eng, "raw", eng)   # unwrap WordSubstrate
        self._pending: List[Any] = []
        self.stats = {"grouped": 0, "solo": 0, "groups": 0, "failed": 0}

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, tx: Any) -> None:
        self._pending.append(getattr(tx, "_ctx", tx))

    # -- eligibility ----------------------------------------------------
    def _groupable(self, d) -> Optional[str]:
        kind = getattr(self.eng.policy, "group_commit", None)
        if kind is None or not d.active or d.read_only:
            return None
        if getattr(d, "irrevocable", False) or d.versioned_write_set:
            return None
        if kind == "buffered":
            # pure buffered: no in-place state, no held locks — and a
            # lock table with the bulk window primitives (the scalar
            # table commits solo)
            if d.write_map and not d.undo and not d.locked_idxs \
                    and getattr(self.eng.locks, "striped", None) is not None:
                return kind
            return None
        if kind == "encounter":
            # in-place writes, locks already held; write_map would mean a
            # policy this module does not know — fall back
            if d.locked_idxs and not d.write_map \
                    and getattr(self.eng.locks, "gather", None) is not None:
                return kind
        return None

    # -- the entry point ------------------------------------------------
    def commit_all(self) -> List[bool]:
        eng = self.eng
        descs, self._pending = self._pending, []
        results: List[Optional[bool]] = [None] * len(descs)

        kind = None
        cand: List[int] = []
        for i, d in enumerate(descs):
            k = self._groupable(d)
            if k is not None and (kind is None or k == kind):
                kind = k
                cand.append(i)

        # extract each candidate's footprint ONCE — partition and the
        # group window share the same arrays (a second per-txn pass
        # would hand back most of the batching win).  Lock indices hash
        # in ONE index_bulk call over the whole batch and split back
        # into per-transaction views.
        groups: List[List[int]] = []
        preps: List[tuple] = []
        l_pack = None
        if len(cand) >= 2:
            arrayish = isinstance(eng.heap, ArrayHeap)
            if kind == "buffered":
                wms = [descs[i].write_map for i in cand]
                sizes = np.fromiter((len(wm) for wm in wms),
                                    np.int64, len(wms))
                total = int(sizes.sum())
                offs = [0] * (len(wms) + 1)
                for k, wm in enumerate(wms):
                    offs[k + 1] = offs[k] + len(wm)
                # hand-rolled view slicing: np.split routes through
                # array_split/swapaxes and costs real time at this size
                cut = lambda a: [a[offs[k]:offs[k + 1]]          # noqa: E731
                                 for k in range(len(wms))]
                # ONE fromiter over the chained dicts, split into
                # per-transaction views — per-dict fromiter calls cost
                # about twice as much at typical write-set sizes
                all_addr = np.fromiter(
                    chain.from_iterable(wms), np.int64, total)
                w_addrs = cut(all_addr)
                if arrayish:
                    # int64 heap: values as one array now, so the
                    # publish sweep is one concatenate + one fancy
                    # scatter (object heaps keep the list form)
                    w_valss = cut(np.fromiter(
                        chain.from_iterable(wm.values() for wm in wms),
                        np.int64, total))
                else:
                    w_valss = [list(wm.values()) for wm in wms]
                all_l = eng.locks.index_bulk(all_addr)
                l_sets = cut(all_l)
            else:
                w_addrs = w_valss = None
                all_l = sizes = None
                l_sets = [C.held_write_indices(eng, descs[i])
                          for i in cand]
            for k, i in enumerate(cand):
                d = descs[i]
                r_idx, r_seen = _read_arrays(d)
                preps.append((d,
                              w_addrs[k] if w_addrs is not None else None,
                              w_valss[k] if w_valss is not None else None,
                              l_sets[k], r_idx, r_seen))
            groups = partition_disjoint(
                [p[3] for p in preps], [p[4] for p in preps])
            if (all_l is not None and len(groups) == 1
                    and len(groups[0]) == len(preps)):
                # the whole batch formed one group: its flat lock batch
                # is exactly the one we already hashed — skip the repack
                l_pack = (all_l,
                          np.repeat(np.arange(len(preps), dtype=np.int64),
                                    sizes))

        solo = set(range(len(descs)))
        for members in groups:
            if len(members) < 2:
                continue                       # singleton: solo fallback
            gp = [preps[m] for m in members]
            ok = (self._commit_group_buffered(gp, l_pack)
                  if kind == "buffered"
                  else self._commit_group_encounter(gp))
            self.stats["grouped"] += len(gp)
            self.stats["groups"] += 1
            for m, okd in zip(members, ok):
                results[cand[m]] = bool(okd)
                solo.discard(cand[m])

        for i in sorted(solo):
            d = descs[i]
            self.stats["solo"] += 1
            try:
                eng._try_commit(d)
                results[i] = True
            except AbortTx:
                results[i] = False
        out = [bool(r) for r in results]
        self.stats["failed"] += sum(1 for r in out if not r)
        return out

    # -- buffered (TL2-style) group window ------------------------------
    def _commit_group_buffered(self, gp, l_pack=None) -> np.ndarray:
        eng = self.eng
        locks = eng.locks
        mode = eng.policy.validate_mode
        group = [p[0] for p in gp]
        w_addrs = [p[1] for p in gp]
        w_vals = [p[2] for p in gp]
        if l_pack is not None:
            l_flat, l_seg = l_pack
        else:
            l_flat, l_seg, _ = pack_segments([p[3] for p in gp])
        r_flat, r_seg, _ = pack_segments([p[4] for p in gp])
        tids = np.fromiter((d.tid for d in group), np.int64, len(group))

        # durable group commit: ONE buffered append carries every
        # member's PREPARE frame, landed BEFORE the claim window (the
        # append-before-claim invariant); the single fsync'd group
        # DECIDE below covers the whole batch
        wal = eng.wal
        if wal is not None:
            lsns = wal.append_prepare_group(
                [(int(d.tid), a, v, (eng.clock.load(),), -1, -1)
                 for d, a, v in zip(group, w_addrs, w_vals)])
            for d, lsn in zip(group, lsns):
                d.wal_lsn = lsn

        # ONE hoisted CAS window for verdict + claim + tick + publish +
        # release: the group analogue of try_lock_bulk's
        # gather/check/scatter under held stripes.  The verdict, the
        # claim and the publish all use the words gathered HERE, inside
        # the window, so the kernel decides on exactly what the host
        # decided on.
        with locks.striped(l_flat):
            # the words stay on the card for the kernel's verdict too
            l_dev = locks.words_at(l_flat)
            r_dev = locks.words_at(r_flat) if r_flat.size else None
            if r_dev is not None:
                l_words, r_words = to_host([l_dev, r_dev])
            else:
                l_words, r_words = l_dev.cpu().numpy(), None
            r_seen = None
            if r_flat.size == 0 and not (l_words & 3).any():
                # fast verdict: no reads to validate and every write
                # word free + unflagged means claimable for ANY owner —
                # the answer np_commit_decide gives, minus the unpack
                ok = np.ones(len(group), bool)
                all_ok = any_ok = True
            else:
                r_seen = (np.concatenate([p[5] for p in gp]) if gp
                          else np.zeros((0,), np.int64))
                rcs = np.fromiter((d.r_clock for d in group),
                                  np.int64, len(group))
                if r_words is None:
                    r_words = np.zeros((0,), np.int64)
                lv, lo, lm = locks.host_fields(l_words)
                rv, ro, rm = locks.host_fields(r_words)
                ok = np_commit_decide(lv, lo, lm, l_seg, rv, ro, rm,
                                      r_seen, r_seg, tids, rcs,
                                      len(group), mode)
                all_ok = bool(ok.all())
                any_ok = all_ok or bool(ok[l_seg].any())
            if any_ok:
                if FP.ACTIVE is not None:
                    FP.fire("pre_claim", int(tids[0]))
                if all_ok:
                    claim = l_flat
                    locks.store_words(
                        claim, locks.claim_words(l_words, tids[l_seg]))
                else:
                    sel = ok[l_seg]
                    claim = l_flat[sel]
                    locks.store_words(
                        claim,
                        locks.claim_words(l_words[sel], tids[l_seg[sel]]))
                if FP.ACTIVE is not None:
                    FP.fire("post_claim", int(tids[0]))
                    FP.fire("pre_clock_tick", int(tids[0]))
            # ONE tick for the whole group — fetched AFTER the claim,
            # the same GV4 ordering the solo pipeline pins (module
            # docstring)
            wv = eng.clock.increment()
            if any_ok:
                if FP.ACTIVE is not None:
                    FP.fire("pre_scatter", int(tids[0]))
                # group commit record: every surviving member is decided
                # and about to publish — a crash from here rolls them
                # all FORWARD (recovery.recover_engine); ONE fsync'd
                # group DECIDE makes the whole batch durable before the
                # publish is enqueued
                if wal is not None:
                    wal.append_decide_group(
                        [d.wal_lsn for d, okd in zip(group, ok)
                         if okd and d.wal_lsn is not None])
                for d, okd in zip(group, ok):
                    if okd:
                        d.publish_started = True
                rel = self._publish(group, ok, all_ok, w_addrs, w_vals,
                                    l_seg, l_dev, r_seg, r_dev, r_seen,
                                    tids, wv, mode)
                if FP.ACTIVE is not None:
                    FP.fire("post_scatter", int(tids[0]))
                    FP.fire("pre_release", int(tids[0]))
                # release-at-wv is a raw scatter: the stripes are still
                # held and every claimed word is ours.  With the kernel's
                # release words every lock entry is stored: a failed
                # member's entry keeps its own word, which nobody can
                # have changed while the stripes are held
                if rel is not None:
                    locks.store_words(l_flat, rel)
                else:
                    locks.store_words(claim, np.full(
                        claim.size, CF.release_word(wv), np.int64))
        if wal is not None:
            for d, okd in zip(group, ok):
                if okd and d.wal_lsn is not None:
                    wal.append_complete(d.wal_lsn)
                d.wal_lsn = None    # losers: abandoned prepare = rollback
        self._bookkeep(group, ok)
        return ok

    def _publish(self, group, ok, all_ok, w_addrs, w_vals, l_seg, l_dev,
                 r_seg, r_dev, r_seen, tids, wv, mode):
        """Scatter every surviving member's writes in one sweep.

        On an ``ArrayHeap``: ONE ``commit_fused`` call over the engine
        heap, in place — verdict + claim check + scatter + release words
        (the CUDA kernel on the card).  It is handed the lock words the
        host verdict read (``l_dev``/``r_dev``: the device tensors
        gathered inside the stripe window, which the host copied for
        its verdict, so they do not cross the bus again), not a
        re-gather: a read-set word may change after the verdict, since
        the window holds only the write-lock stripes, and a kernel
        deciding on newer words could drop a member the host has
        claimed and is about to release as committed.  Its ``ok`` is
        copied back and must equal the host's, or the publish raises.
        Returns the release words for every lock entry (a device
        tensor).

        On an object heap: one ``heap_scatter`` of the surviving values;
        returns ``None`` (the caller stamps the claimed words).
        """
        eng = self.eng
        if isinstance(eng.heap, ArrayHeap):
            w_flat, w_seg, _ = pack_segments(w_addrs)
            vals = np.concatenate([np.asarray(v, np.int64) for v in w_vals])
            z = np.zeros((0,), np.int64)
            rcs = np.fromiter((d.r_clock for d in group), np.int64,
                              len(group))
            with eng.heap._lock:
                _, k_ok, rel = CF.commit_fused(
                    eng.heap.live(), w_flat, vals, w_seg, l_dev, l_seg,
                    z if r_dev is None else r_dev,
                    z if r_seen is None else r_seen, r_seg, tids, rcs, wv,
                    len(group), mode=mode)
            k_ok = k_ok.cpu().numpy()
            if not np.array_equal(k_ok, ok):
                raise RuntimeError(
                    f"commit_fused verdict {k_ok.tolist()} differs from "
                    f"the host verdict {np.asarray(ok).tolist()}")
            return rel
        sel_addrs = (w_addrs if all_ok
                     else [a for a, okd in zip(w_addrs, ok) if okd])
        addrs = (np.concatenate(sel_addrs) if sel_addrs
                 else np.zeros((0,), np.int64))
        if not addrs.size:
            return None
        sel_vals = (w_vals if all_ok
                    else [v for v, okd in zip(w_vals, ok) if okd])
        vals = []
        for vs in sel_vals:
            vals.extend(vs)
        C.heap_scatter(eng.heap, addrs, vals, tid=int(tids[0]))
        return None

    # -- encounter (DCTL-style) group window ----------------------------
    def _commit_group_encounter(self, gp) -> np.ndarray:
        """Locks are already held, writes already in place: the group is
        one fused read-set validation plus one release sweep at the
        deferred clock's CURRENT value — exactly the solo release
        (``DCTLPolicy.commit_update``), batched.  Failed members roll
        back individually (undo restore + deferred-clock bump) with
        their disjoint group-mates' words untouched."""
        eng = self.eng
        mode = eng.policy.validate_mode
        group = [p[0] for p in gp]
        l_sets = [p[3] for p in gp]
        r_flat, r_seg, _ = pack_segments([p[4] for p in gp])
        r_seen = (np.concatenate([p[5] for p in gp]) if gp
                  else np.zeros((0,), np.int64))
        tids = np.fromiter((d.tid for d in group), np.int64, len(group))
        rcs = np.fromiter((d.r_clock for d in group), np.int64, len(group))
        ver, own, meta = eng.locks.host_fields(
            eng.locks.words_at(r_flat).cpu().numpy())
        z = np.zeros((0,), np.int64)
        ok = np_commit_decide(z, z, z, z, ver, own, meta, r_seen, r_seg,
                              tids, rcs, len(group), mode)
        sel_l = [ls for ls, okd in zip(l_sets, ok) if okd]
        if sel_l:
            if FP.ACTIVE is not None:
                FP.fire("pre_clock_tick", int(tids[0]))
            cv = eng.clock.load()
            # encounter group commit record: the heap already holds the
            # surviving members' values — crash from here rolls forward.
            # Durable twin: redo images gathered from the locked heap
            # words (one gather for the group, one copy home), one
            # buffered prepare-group + one fsync'd DECIDE
            wal = eng.wal
            if wal is not None:
                owners = [d for d, okd in zip(group, ok) if okd and d.undo]
                if owners:
                    addrs = [np.fromiter(d.undo.keys(), np.int64,
                                         len(d.undo)) for d in owners]
                    vals = eng.heap.gather(np.concatenate(addrs))
                    if isinstance(vals, torch.Tensor):
                        vals = vals.cpu().numpy()
                    recs, off = [], 0
                    for d, a in zip(owners, addrs):
                        recs.append((int(d.tid), a, vals[off:off + a.size],
                                     (cv,), -1, -1))
                        off += a.size
                    lsns = wal.append_prepare_group(recs)
                    for d, lsn in zip(owners, lsns):
                        d.wal_lsn = lsn
                    wal.append_decide_group(lsns)
            for d, okd in zip(group, ok):
                if okd:
                    d.publish_started = True
            if FP.ACTIVE is not None:
                FP.fire("pre_release", int(tids[0]))
            eng.locks.unlock_bulk(np.concatenate(sel_l), cv)
            if wal is not None:
                for d, okd in zip(group, ok):
                    if okd and d.wal_lsn is not None:
                        wal.append_complete(d.wal_lsn)
                    d.wal_lsn = None
        self._bookkeep(group, ok, clear_locked=True)
        return ok

    # -- shared epilogue ------------------------------------------------
    def _bookkeep(self, group, ok: np.ndarray,
                  clear_locked: bool = False) -> None:
        eng = self.eng
        for d, okd in zip(group, ok):
            if okd:
                if clear_locked:
                    d.locked_idxs.clear()
                d.stats["commits"] += 1
                d.active = False
                eng.policy.on_finish(eng, d)
            else:
                eng._abort(d)


class ShardedCommitBatcher:
    """Group commit over the SHARDED store: one shard-local publish per
    batch of blind single-shard writers.

    ``add`` collects ready ``ShardStoreHandle`` transactions;
    ``commit_all`` buckets the BLIND writers (no reads anywhere, writes
    confined to one shard — the write-only ingest shape) per shard, and
    each bucket whose write addresses are pairwise disjoint publishes
    through ONE ``MVStoreHandle._publish_locked`` — one clock tick, one
    ``commit_fused`` call for the whole bucket, the store-level analogue
    of ``CommitBatcher``'s fused group window.

    SOUNDNESS: a blind write-only transaction carries no reads, so any
    serial order of disjoint-address blind writers from the same base
    state yields the same final state — the merged single-tick publish
    IS such an order.  This is deliberately a RELAXATION of the solo
    path (which aborts the second writer at block granularity and
    retries); it admits more schedules, all serializable.  Anything
    outside the shape — any read, multi-shard writes, overlapping
    addresses, versioned or inactive contexts — falls back to
    ``store.commit`` solo, so the batcher is an optimization of the
    write-only ingest case, never of validation.
    """

    def __init__(self, store: Any):
        self.store = store
        self._pending: List[Any] = []
        self.stats = {"grouped": 0, "solo": 0, "groups": 0, "failed": 0}

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, tx: Any) -> None:
        self._pending.append(getattr(tx, "_ctx", tx))

    def commit_all(self) -> List[bool]:
        from repro_torch.api.substrate import Txn
        store = self.store
        ctxs, self._pending = self._pending, []
        results: List[Any] = [None] * len(ctxs)

        by_shard: dict = {}
        solo: List[int] = []
        for i, ctx in enumerate(ctxs):
            ws = [s for s, c in enumerate(ctx.subs) if c.write_buf]
            blind = (ctx.active and len(ws) == 1
                     and not any(c.read_cnt or c.versioned
                                 for c in ctx.subs))
            if blind:
                by_shard.setdefault(ws[0], []).append(i)
            else:
                solo.append(i)

        for s, members in sorted(by_shard.items()):
            if len(members) < 2:
                solo.extend(members)
                continue
            # members whose addresses meet an earlier member's fall back
            # to a solo commit, one by one
            merged: dict = {}
            grouped: List[int] = []
            for i in members:
                wb = ctxs[i].subs[s].write_buf
                if any(a in merged for a in wb):
                    solo.append(i)
                    continue
                merged.update(wb)
                grouped.append(i)
            if len(grouped) < 2:
                solo.extend(grouped)
                continue
            shard = store._shards[s]
            with shard._commit_lock:
                g = type(ctxs[grouped[0]].subs[s])(ctxs[grouped[0]].tid)
                g.read_clock = int(shard._state.clock)
                g.read_only = False
                g.write_buf = merged
                shard._publish_locked(g)
            for i in grouped:
                store._counters[ctxs[i].tid]["commits"] += 1
                shard._readers[ctxs[i].tid].attempts = 0
                store._deactivate(ctxs[i])
                results[i] = True
            self.stats["grouped"] += len(grouped)
            self.stats["groups"] += 1

        for i in sorted(solo):
            ctx = ctxs[i]
            self.stats["solo"] += 1
            try:
                store.commit(Txn(store, ctx, ctx.tid))
                results[i] = True
            except AbortTx:
                results[i] = False
        out = [bool(r) for r in results]
        self.stats["failed"] += sum(1 for r in out if not r)
        return out
