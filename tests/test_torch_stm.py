"""The port's Multiverse STM against the JAX package's, end to end.

* Seeded two-tid schedules run through ``repro.api.make_tm`` and
  ``repro_torch.api.make_tm(device="cpu")`` in modes None, "Q" and "U":
  the traces (every value read, every abort and commit) and the final
  heaps, lock words, clocks, mirrors and counters must be identical.
* The ``read_bulk`` cases of ``tests/test_read_bulk.py`` hold on the port.
* Short threaded longread and rwmix runs on the CPU see no torn
  snapshot (``violations == 0``).
"""
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.api as J
from repro.configs.paper_stm import MultiverseParams as JParams
from repro_torch import api as T
from repro_torch.configs.paper_stm import MultiverseParams as TParams

INITIAL = 100
AMOUNT = 5


def _make(pkg, forced_mode, lock_bits=8, **kw):
    if pkg is J:
        return J.make_tm("multiverse", 2, array_heap=True, start_bg=False,
                         forced_mode=forced_mode,
                         params=JParams(k1=2, k2=6, k3=6,
                                        lock_table_bits=lock_bits), **kw)
    return T.make_tm("multiverse", 2, array_heap=True, start_bg=False,
                     forced_mode=forced_mode, device="cpu",
                     params=TParams(k1=2, k2=6, k3=6,
                                    lock_table_bits=lock_bits), **kw)


def _state(tm):
    """Heap, lock words, clock and mirror as numpy, for either package."""
    eng = tm.raw
    if hasattr(eng, "device"):
        return T.dump_numpy_state(tm)
    m = eng.policy.vlt.mirror
    return {"heap": eng.heap._buf[:len(eng.heap)].copy(),
            "lock_words": eng.locks._words.copy(),
            "clock": eng.clock.load(), "mirror_seq": m._seq.copy(),
            "mirror_addr": m._addr.copy(), "mirror_ts": m._ts.copy(),
            "mirror_data": m._data.copy()}


def _run_schedule(tm, AbortTx, seed, steps=300, region=600):
    """Two tids interleaved from one thread: a scan reads ``region`` words
    in 100-word chunks, one chunk per step, while the other tid commits
    point transfers or 300-word block rotations between its chunks.
    Each update runs whole inside one step, so no lock is held across a
    step and no reader spins on the other tid.  Returns the trace."""
    base = tm.alloc(region, INITIAL)
    rng = random.Random(seed)
    trace, scan = [], {}

    def update(tid):
        tx = tm.begin(tid)
        try:
            if rng.random() < 0.5:
                i, j = rng.sample(range(region), 2)
                a, b = tx.read(base + i), tx.read(base + j)
                tx.write(base + i, a - AMOUNT)
                tx.write(base + j, b + AMOUNT)
                got = (int(a), int(b))
            else:
                off = base + 300 * rng.randrange(2)
                vals = [int(v) for v in tx.read_bulk(range(off, off + 300))]
                tx.write_bulk(np.arange(off, off + 300),
                              np.roll(np.asarray(vals, np.int64), 1))
                got = sum(vals)
            tm.commit(tx)
            trace.append((tid, "update", got))
        except AbortTx:
            tm.abort(tx)
            trace.append((tid, "update-abort"))

    for _ in range(steps):
        tid = rng.randrange(2)
        if tid not in scan and rng.random() < 0.5:
            tm.begin_operation(tid)
            update(tid)
            continue
        if tid not in scan:
            tm.begin_operation(tid)
            scan[tid] = None
        if scan[tid] is None:
            scan[tid] = [tm.begin(tid), 0, 0]
        tx, off, acc = scan[tid]
        try:
            if off == region:
                tm.commit(tx)
                trace.append((tid, "scan", acc))
                del scan[tid]
                continue
            vals = [int(v) for v in tx.read_bulk(
                range(base + off, base + off + 100))]
            scan[tid] = [tx, off + 100, acc + sum(vals)]
            trace.append((tid, "chunk", sum(vals)))
        except AbortTx:
            tm.abort(tx)
            scan[tid] = None
            trace.append((tid, "scan-abort"))
    for st in scan.values():
        if st is not None:
            tm.abort(st[0])
    return trace


def _compare(jtm, ttm, stats=True):
    js, ts = jtm.raw.stats(), ttm.raw.stats()
    if stats:
        assert ts == js
    jst, tst = _state(jtm), _state(ttm)
    assert set(jst) == set(tst)
    for k in jst:
        np.testing.assert_array_equal(np.asarray(tst[k]), np.asarray(jst[k]),
                                      err_msg=k)
    return js


@pytest.mark.parametrize("forced_mode,seed", [(None, 1), (None, 4),
                                              ("Q", 2), ("U", 5),
                                              ("U", 7)])
def test_schedule_parity(forced_mode, seed):
    jtm, ttm = _make(J, forced_mode), _make(T, forced_mode)
    jtr = _run_schedule(jtm, J.AbortTx, seed)
    ttr = _run_schedule(ttm, T.AbortTx, seed)
    assert ttr == jtr
    stats = _compare(jtm, ttm)
    # the schedule really exercised conflicts and versioned reads
    assert stats["aborts"] > 0 and stats["commits"] > 0
    assert stats["versioned_commits"] > 0
    if forced_mode == "U":
        assert stats["version_gather_hits"] > 0
        assert stats["mirror_way2_hits"] > 0
    # the writers' host copy of the mirror's way table matches the card's
    mirror = ttm.raw.policy.vlt.mirror
    np.testing.assert_array_equal(mirror._ways, mirror._addr.numpy())
    jtm.stop()
    ttm.stop()


def test_mode_u_bulk_read_accepts_unversioned_bucket_mates_in_bulk():
    """A Mode-U versioned reader whose snapshot predates a write: the
    written word resolves through the mirror, and the never-written
    words sharing its lock bucket (their lock version now >= the
    snapshot) are accepted by the bulk lock-freeze read — none of them
    takes the scalar path — with the values the reference returns."""
    got = []
    for pkg in (J, T):
        tm = _make(pkg, "U", lock_bits=4)          # 16 buckets: many mates
        base = tm.alloc(256, 3)
        pkg.run(tm, lambda tx: tx.write(base + 255, 3), tid=1)
        tm.clock.increment()
        tx = tm.begin(0)
        tx._ctx.versioned = True
        pkg.run(tm, lambda t: t.write(base + 7, 99), tid=1)
        if pkg is T:
            scalar = []
            pol = tm.raw.policy
            real = pol._mode_u_versioned_read
            pol._mode_u_versioned_read = \
                lambda e, d, a: scalar.append(a) or real(e, d, a)
        vals = [int(v) for v in tx.read_bulk(range(base, base + 256))]
        tm.commit(tx)
        got.append(vals)
        if pkg is T:
            assert scalar == []
            assert tm.raw.stats()["version_gather_hits"] == 1
        tm.stop()
    assert got[0] == got[1] == [3] * 256


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bulk_lock_freeze_matches_scalar_route(seed):
    """The port's Mode-U bulk lock-freeze against the reference's scalar
    route on one seeded schedule.  Forced Mode U, a 16-word lock table
    (many bucket-mates per word), versioned readers whose snapshots
    predate seeded writes to addresses of the scanned range: the port's
    ``read_bulk`` accepts the never-written bucket-mates in bulk, the
    reference sends each through ``_mode_u_versioned_read``.  Values,
    abort outcomes and the final state must be identical, and both
    routes must really have been taken."""
    region, chunk = 128, 32
    traces, routes = [], []
    for pkg in (J, T):
        tm = _make(pkg, "U", lock_bits=4)
        base = tm.alloc(region, 3)
        rng = random.Random(seed)
        pol = tm.raw.policy
        hits = []
        if pkg is T:
            real = pol._bulk_lock_freeze

            def spy(addrs, idxs, ok, frozen, _real=real):
                before = int(ok.sum())
                out = _real(addrs, idxs, ok, frozen)
                hits.append(int(out.sum()) - before)
                return out
            pol._bulk_lock_freeze = spy
        else:
            real = pol._mode_u_versioned_read
            pol._mode_u_versioned_read = \
                lambda e, d, a, _real=real: hits.append(1) or _real(e, d, a)
        trace = []
        for _ in range(6):
            tm.clock.increment()
            tm.begin_operation(0)
            tx = tm.begin(0)
            tx._ctx.versioned = True
            try:
                for off in range(0, region, chunk):
                    for _ in range(rng.randrange(4)):
                        a = base + rng.randrange(region)
                        v = rng.randrange(1000)
                        pkg.run(tm, lambda t: t.write(a, v), tid=1)
                        trace.append(("write", a - base, v))
                    vals = tx.read_bulk(range(base + off,
                                              base + off + chunk))
                    trace.append(("chunk", [int(v) for v in vals]))
                tm.commit(tx)
                trace.append(("commit",))
            except pkg.AbortTx:
                tm.abort(tx)
                trace.append(("abort",))
        traces.append((trace, _state(tm)))
        routes.append(sum(hits))
        tm.stop()
    (jt, js), (tt, ts) = traces
    assert tt == jt
    for k in js:
        np.testing.assert_array_equal(np.asarray(ts[k]), np.asarray(js[k]),
                                      err_msg=k)
    assert routes[0] > 0 and routes[1] > 0      # both routes were taken


def test_computes_from_loaded_reference_state():
    """The reference's state, carried over with ``load_numpy_state``,
    gives the port the same reads, verdicts and final state."""
    jtm, ttm = _make(J, "Q"), _make(T, "Q")
    _run_schedule(jtm, J.AbortTx, 7, steps=120)
    ttm.alloc(600, 0)
    T.load_numpy_state(ttm, _state(jtm))
    out = []
    for tm, pkg in ((jtm, J), (ttm, T)):
        rows = [[int(v) for v in pkg.run(tm, lambda tx: tx.read_bulk(
            range(0, 600)), tid=0)]]
        pkg.run(tm, lambda tx: tx.write_bulk(
            range(100, 400), [7] * 300), tid=1)
        rows.append([int(v) for v in pkg.run(tm, lambda tx: tx.read_bulk(
            range(0, 600)), tid=0)])
        out.append(rows)
    assert out[0] == out[1]
    _compare(jtm, ttm, stats=False)
    jtm.stop()
    ttm.stop()


# ---------------------------------------------------------------------------
# the read_bulk cases of tests/test_read_bulk.py, on the port
# ---------------------------------------------------------------------------


def _port_tm(n_threads=1, **kw):
    kw.setdefault("device", "cpu")
    return T.make_tm("multiverse", n_threads,
                     params=TParams(k1=2, k2=50, k3=50, lock_table_bits=8),
                     **kw)


@pytest.mark.parametrize("array_heap", [False, True])
def test_read_bulk_matches_scalar(array_heap):
    tm = _port_tm(array_heap=array_heap)
    base = tm.alloc(300, 7)

    def body(tx):
        got = tx.read_bulk(range(base, base + 300))
        if array_heap:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.int64
        return [int(v) for v in got], \
            [int(tx.read(base + i)) for i in range(300)]
    bulk, scalar = T.run(tm, body, tid=0)
    assert bulk == scalar == [7] * 300
    tm.stop()


@pytest.mark.parametrize("array_heap", [False, True])
def test_read_bulk_sees_own_writes(array_heap):
    tm = _port_tm(array_heap=array_heap)
    base = tm.alloc(64, 1)

    def body(tx):
        tx.write(base + 3, 42)
        tx.write(base + 60, 43)
        return [int(v) for v in tx.read_bulk(
            [base + 2, base + 3, base + 60, base + 3])]
    assert T.run(tm, body, tid=0) == [1, 42, 43, 42]
    tm.stop()


def test_read_bulk_counts_reads_and_handles_empty():
    tm = _port_tm(array_heap=True)
    base = tm.alloc(128, 0)

    def body(tx):
        assert list(tx.read_bulk([])) == []
        tx.read_bulk(range(base, base + 128))
        return tx.read_count
    assert T.run(tm, body, tid=0) >= 128
    tm.stop()


def test_read_bulk_scalar_fallback_aborts_on_foreign_lock():
    """A word encounter-locked by another tid fails the bulk predicate;
    the scalar fallback must abort, not return a torn value."""
    tm = _port_tm(n_threads=2, array_heap=True, start_bg=False)
    base = tm.alloc(400, 5)
    tx0 = None
    for _ in range(3):                # deferred clock: a fresh TM's first
        tx0 = tm.begin(0)             # write may abort once
        try:
            tx0.write(base + 17, 99)
            break
        except T.AbortTx:
            tx0 = None
    assert tx0 is not None
    with pytest.raises(T.MaxRetriesExceeded):
        T.run(tm, lambda tx: tx.read_bulk(range(base, base + 400)),
              tid=1, max_retries=3)
    tm.abort(tx0)                     # rolls the 99 back
    vals = T.run(tm, lambda tx: tx.read_bulk(range(base, base + 400)),
                 tid=1)
    assert [int(v) for v in vals] == [5] * 400
    tm.stop()


@pytest.mark.parametrize("array_heap", [False, True])
def test_versioned_bulk_read_returns_snapshot_past(array_heap):
    tm = _port_tm(n_threads=2, array_heap=array_heap, start_bg=False)
    base = tm.alloc(300, 7)
    target = base + 5
    T.run(tm, lambda t: t.write(base + 299, 7), tid=0)
    tx = tm.begin(1)
    tx._ctx.versioned = True
    assert tx.read(target) == 7
    tm.commit(tx)
    tm.clock.increment()
    tx = tm.begin(1)
    tx._ctx.versioned = True
    T.run(tm, lambda t: t.write(target, 99), tid=0)
    assert tm.peek(target) == 99
    idx_t = tm.locks.index(target)
    addrs = [a for a in range(base, base + 300)
             if a == target or tm.locks.index(a) != idx_t]
    vals = tx.read_bulk(addrs)
    tm.commit(tx)
    assert int(vals[addrs.index(target)]) == 7   # the snapshot's past
    assert sum(int(v) for v in vals) == len(addrs) * 7
    assert tm.stats()["versioned_commits"] >= 1
    tm.stop()


# ---------------------------------------------------------------------------
# threaded: no torn snapshot under concurrent updaters
# ---------------------------------------------------------------------------


def _threads(workers, seconds):
    old = sys.getswitchinterval()
    sys.setswitchinterval(2e-5)
    stop = threading.Event()
    counts = [dict(violations=0, done=0) for _ in workers]
    threads = [threading.Thread(target=w, args=(stop, c), daemon=True)
               for w, c in zip(workers, counts)]
    try:
        for t in threads:
            t.start()
        time.sleep(seconds)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    return counts


def _sum(vals):
    return int(vals.sum()) if isinstance(vals, torch.Tensor) \
        else sum(int(v) for v in vals)


def test_threaded_longread_has_no_torn_scan():
    scan, chunk = 512, 256
    tm = T.make_tm("multiverse", 3, array_heap=True, device="cpu",
                   params=TParams(k1=2, k2=3, k3=3, lock_table_bits=12))
    base = tm.alloc(scan, INITIAL)

    def scanner(stop, c):
        while not stop.is_set():
            tot = T.run(tm, lambda tx: sum(_sum(tx.read_bulk(
                range(base + o, base + o + chunk)))
                for o in range(0, scan, chunk)), tid=0)
            c["done"] += 1
            c["violations"] += tot != scan * INITIAL

    def updater(tid):
        r = random.Random(tid)

        def transfer(tx):
            i, j = r.sample(range(scan), 2)
            a, b = tx.read(base + i), tx.read(base + j)
            tx.write(base + i, a - AMOUNT)
            tx.write(base + j, b + AMOUNT)

        def work(stop, c):
            while not stop.is_set():
                T.run(tm, transfer, tid=tid)
                c["done"] += 1
        return work

    counts = _threads([scanner, updater(1), updater(2)], 0.8)
    tm.stop()
    assert counts[0]["done"] > 0 and counts[1]["done"] > 0
    assert sum(c["violations"] for c in counts) == 0


def test_threaded_rwmix_has_no_torn_block():
    wb, n_blocks = 256, 8
    tm = T.make_tm("multiverse", 3, array_heap=True, device="cpu",
                   params=TParams(k1=30, k2=200, k3=200,
                                  lock_table_bits=16))
    base = tm.alloc(wb * n_blocks, INITIAL)

    def updater(tid):
        r = random.Random(300 + tid)
        mine = [b for b in range(n_blocks) if b % 2 == tid]

        def rotate(tx):
            off = base + wb * r.choice(mine)
            vals = tx.read_bulk(range(off, off + wb))
            vals = torch.as_tensor(vals, dtype=torch.int64)
            tx.write_bulk(range(off, off + wb), torch.roll(vals, 1))

        def work(stop, c):
            while not stop.is_set():
                T.run(tm, rotate, tid=tid)
                c["done"] += 1
        return work

    def checker(stop, c):
        r = random.Random(900)

        def check(tx):
            off = base + wb * r.randrange(n_blocks)
            return _sum(tx.read_bulk(range(off, off + wb)))
        while not stop.is_set():
            got = T.run(tm, check, tid=2)
            c["done"] += 1
            c["violations"] += got != wb * INITIAL

    counts = _threads([updater(0), updater(1), checker], 0.8)
    tm.stop()
    assert counts[0]["done"] > 0 and counts[2]["done"] > 0
    assert sum(c["violations"] for c in counts) == 0
