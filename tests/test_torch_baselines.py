"""The port's four baselines (TL2, DCTL, NOrec, TinySTM) and its MVStore
backend against the JAX package.

* Seeded two-tid schedules through ``repro.api.make_tm`` and
  ``repro_torch.api.make_tm(device="cpu")`` on all five word backends:
  the traces (every value read, every abort and commit), the counters and
  the final heaps, lock words and clocks must be identical.
* The assertions of ``tests/test_read_own_writes.py``,
  ``tests/test_read_bulk.py`` and ``tests/test_commit_bulk.py`` hold on
  the port's backends.
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
from repro_torch.core.engine import commit as C
from repro_torch.core.engine.validation import BULK_MIN

WORD_BACKENDS = ["multiverse", "tl2", "dctl", "norec", "tinystm"]
ALL_BACKENDS = WORD_BACKENDS + ["mvstore"]
N = BULK_MIN + 44          # comfortably past the bulk threshold
INITIAL = 10
AMOUNT = 5


def _port_tm(backend, n_threads=2, **kw):
    """The port's counterpart of ``tests/_backends.make_test_tm``."""
    params = TParams(k1=2, k2=50, k3=50, lock_table_bits=8)
    if backend == "mvstore":
        kw.setdefault("ring_slots", 16)
        kw.setdefault("start_bg", False)
    return T.make_tm(backend, n_threads, params=params, device="cpu", **kw)


def _word_tm(backend, n_threads=2, lock_bits=10):
    return T.make_tm(backend, n_threads,
                     params=TParams(k1=50, k2=200, k3=200,
                                    lock_table_bits=lock_bits),
                     array_heap=True, device="cpu")


# ---------------------------------------------------------------------------
# seeded schedules: both packages, all five word backends
# ---------------------------------------------------------------------------


def _pair(backend, lock_bits=8):
    kw = {"start_bg": False} if backend == "multiverse" else {}
    jtm = J.make_tm(backend, 2, array_heap=True,
                    params=JParams(k1=2, k2=6, k3=6,
                                   lock_table_bits=lock_bits), **kw)
    ttm = T.make_tm(backend, 2, array_heap=True, device="cpu",
                    params=TParams(k1=2, k2=6, k3=6,
                                   lock_table_bits=lock_bits), **kw)
    return jtm, ttm


def _schedule(tm, AbortTx, seed, steps=240, region=600):
    """Two tids from one thread: chunked scans (100 words a step) beside
    whole-in-one-step point transfers and 300-word block rotations.
    Returns the trace."""
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


def _word_state(tm):
    eng = tm.raw
    if hasattr(eng, "device"):           # the port
        out = {"heap": eng.heap.live().numpy().copy(),
               "lock_words": eng.locks._words.numpy().copy()}
    else:
        out = {"heap": eng.heap._buf[:len(eng.heap)].copy(),
               "lock_words": eng.locks._words.copy()}
    out["clock"] = eng.clock.load()
    if eng.name.lower() == "norec":
        out["seq"] = eng.policy.seq.load()
    return out


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("backend", WORD_BACKENDS)
def test_schedule_parity(backend, seed):
    jtm, ttm = _pair(backend)
    jtr = _schedule(jtm, J.AbortTx, seed)
    ttr = _schedule(ttm, T.AbortTx, seed)
    assert ttr == jtr
    js, ts = jtm.raw.stats(), ttm.raw.stats()
    assert ts == js
    assert js["commits"] > 0
    jst, tst = _word_state(jtm), _word_state(ttm)
    assert set(jst) == set(tst)
    for k in jst:
        np.testing.assert_array_equal(np.asarray(tst[k]), np.asarray(jst[k]),
                                      err_msg=k)
    jtm.stop()
    ttm.stop()


def test_schedules_exercise_conflicts():
    """The parity schedules are not vacuous: on every unversioned
    baseline they abort both scans and updates."""
    for backend in ("tl2", "dctl", "norec", "tinystm"):
        _, ttm = _pair(backend)
        trace = _schedule(ttm, T.AbortTx, 3)
        kinds = {t[1] for t in trace}
        assert {"scan-abort", "update", "chunk"} <= kinds, (backend, kinds)
        ttm.stop()


# ---------------------------------------------------------------------------
# tests/test_read_own_writes.py, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_read_sees_own_pending_write(backend):
    tm = _port_tm(backend)
    a = tm.alloc(2, 10)

    def txn(tx):
        tx.write(a, 77)
        first = tx.read(a)
        tx.write(a, first + 1)
        second = tx.read(a)
        untouched = tx.read(a + 1)
        return first, second, untouched

    assert T.run(tm, txn, tid=0) == (77, 78, 10)
    assert T.run(tm, lambda tx: tx.read(a), tid=0) == 78
    tm.stop()


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_read_after_write_after_read(backend):
    tm = _port_tm(backend)
    a = tm.alloc(1, 5)

    @T.atomic(tm)
    def bump(tx):
        before = tx.read(a)
        tx.write(a, before + 100)
        after = tx.read(a)
        assert after == before + 100, (before, after)
        return after

    assert bump() == 105
    assert bump() == 205
    tm.stop()


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_read_own_write_to_txn_allocated_cell(backend):
    tm = _port_tm(backend)
    tm.alloc(1, 0)

    def txn(tx):
        node = tx.alloc(3, 0)
        tx.write(node + 1, 42)
        return tx.read(node), tx.read(node + 1)

    assert T.run(tm, txn, tid=0) == (0, 42)
    tm.stop()


@pytest.mark.parametrize("backend", WORD_BACKENDS)
def test_own_writes_not_visible_to_other_threads_before_commit(backend):
    tm = _port_tm(backend)
    a = tm.alloc(1, 1)
    T.run(tm, lambda tx: tx.write(a, 1), tid=0)
    for _ in range(30):
        tx = tm.begin(0)
        try:
            tx.write(a, 99)
            break
        except T.AbortTx:
            continue
    else:
        raise RuntimeError("could not acquire the write lock")
    try:
        for _ in range(5):
            try:
                got = T.run(tm, lambda t: t.read(a), tid=1, max_retries=1)
                assert got == 1, got
            except T.MaxRetriesExceeded:
                pass                             # locked: abort is correct
    finally:
        tm.abort(tx)
    assert T.run(tm, lambda t: t.read(a), tid=1) == 1
    tm.stop()


# ---------------------------------------------------------------------------
# tests/test_read_bulk.py, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_read_bulk_matches_scalar(backend):
    tm = _port_tm(backend, n_threads=1)
    base = tm.alloc(300, 7)

    def body(tx):
        bulk = [int(v) for v in tx.read_bulk(range(base, base + 300))]
        scalar = [int(tx.read(base + i)) for i in range(300)]
        return bulk, scalar
    bulk, scalar = T.run(tm, body, tid=0)
    assert bulk == scalar == [7] * 300
    tm.stop()


@pytest.mark.parametrize("backend", ALL_BACKENDS)
@pytest.mark.parametrize("array_heap", [False, True])
def test_read_bulk_sees_own_writes(backend, array_heap):
    tm = _port_tm(backend, n_threads=1, array_heap=array_heap)
    base = tm.alloc(64, 1)

    def body(tx):
        tx.write(base + 3, 42)
        tx.write(base + 60, 43)
        return [int(v) for v in tx.read_bulk(
            [base + 2, base + 3, base + 60, base + 3])]
    assert T.run(tm, body, tid=0) == [1, 42, 43, 42]
    tm.stop()


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_read_bulk_counts_reads_and_handles_empty(backend):
    tm = _port_tm(backend, n_threads=1)
    base = tm.alloc(128, 0)

    def body(tx):
        assert list(tx.read_bulk([])) == []
        tx.read_bulk(range(base, base + 128))
        return tx.read_count
    assert T.run(tm, body, tid=0) >= 128
    tm.stop()


def test_read_bulk_scalar_fallback_aborts_on_foreign_lock():
    tm = _port_tm("dctl", n_threads=2, array_heap=True)
    base = tm.alloc(400, 5)
    tx0 = None
    for _ in range(3):
        tx0 = tm.begin(0)
        try:
            tx0.write(base + 17, 99)
            break
        except T.AbortTx:
            tx0 = None
    assert tx0 is not None
    with pytest.raises(T.MaxRetriesExceeded):
        T.run(tm, lambda tx: tx.read_bulk(range(base, base + 400)),
              tid=1, max_retries=3)
    tm.abort(tx0)
    vals = T.run(tm, lambda tx: tx.read_bulk(range(base, base + 400)),
                 tid=1)
    assert [int(v) for v in vals] == [5] * 400
    tm.stop()


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_scanner_snapshots_are_balance_preserving(backend):
    """A scanner ``read_bulk``s the whole region while two updaters
    commit transfers; every completed scan sees the exact region sum."""
    n, n_threads = 128, 3
    kw = {"array_heap": True} if backend in WORD_BACKENDS else {}
    tm = _port_tm(backend, n_threads=n_threads, **kw)
    base = tm.alloc(n, INITIAL)
    stop = threading.Event()
    scans = {"done": 0, "bad": 0}

    def updater(tid):
        r = random.Random(1000 + tid)

        def transfer(tx):
            i = r.randrange(n)
            j = (i + 1 + r.randrange(n - 1)) % n
            tx.write(base + i, int(tx.read(base + i)) - 1)
            tx.write(base + j, int(tx.read(base + j)) + 1)
        while not stop.is_set():
            try:
                T.run(tm, transfer, tid=tid, max_retries=2000)
            except T.MaxRetriesExceeded:
                pass

    def scan_once(max_retries):
        def scan(tx):
            return sum(int(torch.as_tensor(tx.read_bulk(
                range(base + off, base + off + 64))).sum())
                for off in range(0, n, 64))
        total = T.run(tm, scan, tid=n_threads - 1, max_retries=max_retries)
        scans["done"] += 1
        scans["bad"] += total != n * INITIAL

    old = sys.getswitchinterval()
    sys.setswitchinterval(2e-5)
    threads = [threading.Thread(target=updater, args=(t,), daemon=True)
               for t in range(2)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 1.0
        while time.time() < deadline and scans["done"] < 5:
            try:
                scan_once(max_retries=10)
            except T.MaxRetriesExceeded:
                pass                   # unversioned TMs starve here
    finally:
        stop.set()
        for t in threads:
            t.join()
        sys.setswitchinterval(old)
    scan_once(max_retries=100)         # quiescent: must complete exactly
    assert scans["bad"] == 0 and scans["done"] >= 1
    tm.stop()


# ---------------------------------------------------------------------------
# tests/test_commit_bulk.py, on the port
# ---------------------------------------------------------------------------


def test_scatter_row_is_out_of_place_and_bounds_checked():
    row = torch.arange(8, dtype=torch.int64)
    out = C.scatter_row(row, np.array([1, 6]), np.array([1 << 40, -3]))
    assert row.tolist() == list(range(8))
    assert out.tolist() == [0, 1 << 40, 2, 3, 4, 5, -3, 7]
    for bad in (-1, 8):
        with pytest.raises(IndexError):
            C.scatter_row(row, np.array([bad]), np.array([1]))


def test_acquire_ascending_releases_in_reverse_on_unwind():
    locks = [threading.Lock() for _ in range(3)]
    with pytest.raises(RuntimeError):
        with C.acquire_ascending(locks):
            assert all(lk.locked() for lk in locks)
            raise RuntimeError("unwind")
    assert not any(lk.locked() for lk in locks)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_write_bulk_commits_like_scalar(backend):
    def build(tm):
        base = tm.alloc(N, 0)
        T.run(tm, lambda tx: tx.write_bulk(range(base, base + N),
                                           list(range(N))), tid=0)
        return base

    def rotate_bulk(tm, base):
        def tx_body(tx):
            vals = torch.as_tensor(tx.read_bulk(range(base, base + N)))
            tx.write_bulk(range(base, base + N), torch.roll(vals, 1))
            assert int(tx.read(base)) == N - 1
            assert int(tx.read(base + 1)) == 0
        T.run(tm, tx_body, tid=0)

    def rotate_scalar(tm, base):
        def tx_body(tx):
            vals = [int(v) for v in tx.read_bulk(range(base, base + N))]
            for i in range(N):
                tx.write(base + i, vals[(i - 1) % N])
        T.run(tm, tx_body, tid=0)

    if backend == "mvstore":
        tm_b, tm_s = _port_tm(backend, 1), _port_tm(backend, 1)
    else:
        tm_b, tm_s = _word_tm(backend), _word_tm(backend)
    try:
        base_b, base_s = build(tm_b), build(tm_s)
        rotate_bulk(tm_b, base_b)
        rotate_scalar(tm_s, base_s)
        got = [int(tm_b.peek(base_b + i)) for i in range(N)]
        want = [int(tm_s.peek(base_s + i)) for i in range(N)]
        assert got == want == [(i - 1) % N for i in range(N)]
    finally:
        tm_b.stop()
        tm_s.stop()


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_write_bulk_duplicate_addresses_last_write_wins(backend):
    tm = _port_tm(backend, 1) if backend == "mvstore" else _word_tm(backend)
    try:
        base = tm.alloc(N, 0)
        addrs = list(range(base, base + N)) + [base + 5, base + 5]
        vals = list(range(N)) + [777, 888]
        T.run(tm, lambda tx: tx.write_bulk(addrs, vals), tid=0)
        assert int(tm.peek(base + 5)) == 888
        assert int(tm.peek(base + 4)) == 4
    finally:
        tm.stop()


@pytest.mark.parametrize("backend", WORD_BACKENDS)
def test_write_bulk_engages_bulk_lock_path(backend):
    tm = _word_tm(backend)
    try:
        base = tm.alloc(N, 7)
        raw = tm.raw
        T.run(tm, lambda tx: tx.write(base, 7), tid=0)
        tx = tm.begin(0)
        try:
            tx.write_bulk(range(base, base + N), [1] * N)
        except T.AbortTx:
            tm.abort(tx)
            tx = tm.begin(0)
            tx.write_bulk(range(base, base + N), [1] * N)
        if backend in ("tl2", "norec"):
            assert len(tx._ctx.write_map) == N
            assert len(raw.locks.held_by(0)) == 0
        else:
            assert len(raw.locks.held_by(0)) > 0
            assert len(tx._ctx.undo) == N
        tm.commit(tx)
        assert len(raw.locks.held_by(0)) == 0
        assert all(int(tm.peek(base + i)) == 1 for i in range(N))
    finally:
        tm.stop()


@pytest.mark.parametrize("backend", ["tl2", "dctl"])
def test_bulk_claim_conflict_acquires_nothing(backend):
    """A batch one of whose locks another tid holds aborts with nothing
    acquired and nothing written: TL2's commit-time sweep and DCTL's
    encounter-time sweep."""
    tm = _word_tm(backend)
    try:
        raw = tm.raw
        base = tm.alloc(N, 7)
        victim = raw.locks.index(base + (N - 1 if backend == "tl2"
                                         else N // 2))
        assert raw.locks.try_lock(victim, raw.locks.read(victim), tid=1)
        with pytest.raises(T.AbortTx):
            with tm.txn(tid=0) as tx:
                tx.write_bulk(range(base, base + N), [9] * N)
        assert len(raw.locks.held_by(0)) == 0
        assert all(int(tm.peek(base + i)) == 7 for i in range(N))
        raw.locks.unlock(victim)
    finally:
        tm.stop()


@pytest.mark.parametrize("backend", ("dctl", "tinystm", "multiverse"))
def test_bulk_rollback_restores_undo_exactly(backend):
    tm = _word_tm(backend)
    try:
        raw = tm.raw
        base = tm.alloc(N, 0)
        T.run(tm, lambda tx: tx.write_bulk(range(base, base + N),
                                           list(range(N))), tid=0)
        raw.clock.increment()
        clock0 = raw.clock.load()

        class Boom(Exception):
            pass

        with pytest.raises(Boom):
            with tm.txn(tid=0) as tx:
                tx.write(base + 3, -5)
                tx.write_bulk(range(base, base + N), [-1] * N)
                assert int(tx.read(base + 3)) == -1
                raise Boom()
        assert [int(tm.peek(base + i)) for i in range(N)] == list(range(N))
        assert len(raw.locks.held_by(0)) == 0
        assert raw.clock.load() > clock0
    finally:
        tm.stop()


def _racing_increment(raw, x):
    """A clock.increment that first commits a foreign write to ``x`` at
    the pre-bump clock (tid 1), once."""
    orig = raw.clock.increment
    x_idx = raw.locks.index(x)

    def racing():
        raw.clock.increment = orig
        assert raw.locks.try_lock(x_idx, raw.locks.read(x_idx), tid=1)
        raw.heap[x] = 99
        raw.locks.unlock(x_idx, raw.clock.load())
        return orig()
    raw.clock.increment = racing
    return orig


@pytest.mark.parametrize("bulk", [True, False])
def test_extension_bumps_clock_before_revalidating(bulk):
    """The snapshot extension (bulk ``extend_and_relock`` and scalar
    ``extend_snapshot``) bumps the deferred clock BEFORE revalidating: a
    foreign commit injected inside the bump must force an abort."""
    tm = _word_tm("dctl")
    try:
        raw = tm.raw
        if bulk:
            base = tm.alloc(N, 0)
            x = tm.alloc(1, 42)
            T.run(tm, lambda tx: tx.write_bulk(range(base, base + N),
                                               [1] * N), tid=0)
        else:
            base = tm.alloc(1, 0)
            x = tm.alloc(1, 42)
            assert raw.locks.index(base) != raw.locks.index(x)
            T.run(tm, lambda tx: tx.write(base, 1), tid=0)
        tx = tm.begin(0)
        assert int(tx.read(x)) == 42
        orig = _racing_increment(raw, x)
        try:
            with pytest.raises(T.AbortTx):
                if bulk:
                    tx.write_bulk(range(base, base + N), [2] * N)
                else:
                    tx.write(base, 2)
                tm.commit(tx)
            tm.abort(tx)
        finally:
            raw.clock.increment = orig
        assert int(tm.peek(x)) == 99
        n = N if bulk else 1
        assert all(int(tm.peek(base + i)) == 1 for i in range(n))
        assert len(raw.locks.held_by(0)) == 0
    finally:
        tm.stop()


@pytest.mark.parametrize("backend", ("dctl", "tinystm", "multiverse"))
def test_scalar_write_extends_past_own_commit(backend):
    tm = _word_tm(backend)
    try:
        raw = tm.raw
        a = tm.alloc(1, 0)
        b = tm.alloc(1, 0)
        for k, addr in enumerate((a, b, a), start=1):
            tx = tm.begin(0)
            tx.write(addr, k)
            tm.commit(tx)
        assert int(tm.peek(a)) == 3
        assert int(tm.peek(b)) == 2
        assert len(raw.locks.held_by(0)) == 0
    finally:
        tm.stop()


@pytest.mark.parametrize("backend", ("multiverse", "dctl"))
@pytest.mark.parametrize("path", ("commit", "rollback"))
def test_colliding_addresses_release_once(backend, path):
    tm = _word_tm(backend, lock_bits=4)
    try:
        raw = tm.raw
        base = tm.alloc(64, 7)
        raw.clock.increment()
        seen = {}
        for a in range(base, base + 64):
            seen.setdefault(raw.locks.index(a), []).append(a)
        idx, (a1, a2) = next((i, v[:2]) for i, v in seen.items()
                             if len(v) >= 2)
        released = []
        orig_unlock, orig_bulk = raw.locks.unlock, raw.locks.unlock_bulk

        def counting_unlock(i, version=None):
            released.append(int(i))
            orig_unlock(i, version)

        def counting_bulk(idxs, version=None):
            released.extend(int(i) for i in np.asarray(idxs))
            orig_bulk(idxs, version)

        raw.locks.unlock = counting_unlock
        raw.locks.unlock_bulk = counting_bulk
        try:
            if path == "commit":
                T.run(tm, lambda tx: (tx.write(a1, 1), tx.write(a2, 2)),
                      tid=0, max_retries=50)
            else:
                with pytest.raises(T.AbortTx):
                    with tm.txn(tid=0) as tx:
                        tx.write(a1, 1)
                        tx.write(a2, 2)
                        raise T.AbortTx()
        finally:
            raw.locks.unlock, raw.locks.unlock_bulk = orig_unlock, orig_bulk
        assert released.count(idx) >= 1
        for i in range(len(released) - 1):
            assert not (released[i] == idx and released[i + 1] == idx)
        assert not raw.locks.read(idx).locked
    finally:
        tm.stop()
