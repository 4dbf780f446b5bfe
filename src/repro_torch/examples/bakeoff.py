"""Multi-backend bake-off: ONE workload, every substrate, one API.

The same transfer/audit workload (quickstart's) runs via `make_tm` on all
five word-level TMs and the Layer-B MVStore; because `stats()` is one
schema everywhere, the comparison table needs zero per-backend glue.
A validation microbenchmark then times the engine's commit-time read-set
revalidation both ways — the word-at-a-time scalar loop vs the bulk
vectorized path (`engine.validation` / `kernels/validate.py`) — across
read-set sizes; the read_bulk microbench does the same for flat long
reads, the commitbulk microbench for the COMMIT pipeline (one
`try_lock_bulk` CAS sweep + one heap scatter + one `unlock_bulk` vs
the word-at-a-time loop, asserted >=3x at 1k-word write sets), and the
structrq microbench for pointer-chasing ones (the frontier-at-a-time
`HashMap.size_query` vs the scalar chain walk, asserted >=3x at 4k
keys).

The port's heaps and lock words live on the card (``array_heap=True``
for the bake-off too; the reference's bake-off keeps that heap on the
host): where the reference reads a result as a numpy array, the port
brings the tensor home in one explicit copy, and a verdict or a sum
that a timed call returns is read on the host inside the timed window,
as a commit reads it.

    python -m repro_torch.examples.bakeoff [--seconds 1.0] [--quick]
    PYTHONPATH=src python -m repro_torch.examples.bakeoff --quick \
        --device cpu
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.api import (MaxRetriesExceeded, atomic, backend_names,
                             make_tm, run)
from repro_torch.configs.paper_stm import MultiverseParams
from repro_torch.core.engine import resolve_device
from repro_torch.core.engine.traverse import host_words

N_ACCOUNTS = 100
INITIAL = 100


def bake(backend: str, seconds: float, device=None):
    tm = make_tm(backend, n_threads=3,
                 params=MultiverseParams(k1=4, lock_table_bits=10),
                 array_heap=True, device=device)
    base = tm.alloc(N_ACCOUNTS, INITIAL)
    stop = threading.Event()
    done = [0, 0]

    @atomic(tm)
    def transfer(tx, src, dst, amt):
        a = tx.read(base + src)
        b = tx.read(base + dst)
        tx.write(base + src, a - amt)
        tx.write(base + dst, b + amt)

    def worker(tid):
        i = 0
        while not stop.is_set():
            src, dst = i % N_ACCOUNTS, (i * 13 + 7) % N_ACCOUNTS
            if src != dst:
                transfer(src, dst, 5, tid=tid)
                done[tid] += 1
            i += 1

    ths = [threading.Thread(target=worker, args=(t,)) for t in (0, 1)]
    [t.start() for t in ths]
    audits = failed = 0
    t0 = time.time()
    while time.time() - t0 < seconds:
        try:
            total = run(tm, lambda tx: sum(tx.read(base + i)
                                           for i in range(N_ACCOUNTS)),
                        tid=2, max_retries=500)
            assert total == N_ACCOUNTS * INITIAL, "torn read!"
            audits += 1
        except MaxRetriesExceeded:
            failed += 1                   # the starvation the paper fixes
    stop.set()
    [t.join() for t in ths]
    st = tm.stats()
    tm.stop()
    return {"backend": backend, "transfers": sum(done), "audits": audits,
            "failed_audits": failed, **{k: st[k] for k in
            ("aborts", "versioned_commits", "mode")}}


def validation_microbench(sizes=(256, 1024, 4096, 16384), repeats=5,
                          device=None):
    """Commit-time revalidation: scalar loop vs bulk vectorized path.

    Builds a real engine lock table, populates a read set of each size
    through actual transactional reads, and times
    `validation.revalidate_scalar` against `validation.revalidate_bulk`
    on identical inputs.  Returns rows; asserts the two agree.  The lock
    table lives on the card: the scalar loop reads one lock word at a
    time, the bulk path is one ``validate_words`` launch and its verdict
    read home.
    """
    from repro_torch.core.engine import validation as V

    tm = make_tm("tl2", n_threads=1,
                 params=MultiverseParams(lock_table_bits=16), device=device)
    base = tm.alloc(max(sizes), 1)
    raw = tm.raw
    rows = []
    for n in sizes:
        tx = raw.begin(0)
        for i in range(n):
            tx.read(base + i)
        d = tx._ctx

        def timeit(fn):
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                ok = fn()
                best = min(best, time.perf_counter() - t0)
            return ok, best

        ok_s, t_scalar = timeit(lambda: V.revalidate_scalar(
            raw.locks, d.read_set, d.r_clock, d.tid, V.V_LE))
        ok_b, t_bulk = timeit(lambda: V.revalidate_bulk(
            raw.locks, d.read_set, d.r_clock, d.tid, V.V_LE))
        assert ok_s == ok_b, "scalar and bulk validators disagree"
        raw._abort(d)
        rows.append({"reads": n, "scalar_us": t_scalar * 1e6,
                     "bulk_us": t_bulk * 1e6,
                     "speedup": t_scalar / max(t_bulk, 1e-12)})
    tm.stop()
    return rows


def readbulk_microbench(sizes=(1024, 4096, 16384), repeats=5,
                        backend="multiverse", device=None):
    """Long-running read: scalar `tx.read` loop vs one `tx.read_bulk`.

    A quiescent TM on the int64 array heap, one read-only transaction per
    measurement — so the comparison isolates the read path itself: N
    Python round-trips (lock read + validate each) against one heap
    gather bracketed by two lock-word gathers (one ``gather_bracketed``
    launch on the card, its words brought home in one copy).  Asserts
    the two agree.
    """
    tm = make_tm(backend, n_threads=1,
                 params=MultiverseParams(lock_table_bits=16),
                 array_heap=True, device=device)
    base = tm.alloc(max(sizes), 1)
    rows = []
    for n in sizes:
        # run() not txn(): the deferred clock aborts the very first
        # access after construction once (see API.md), and run retries
        def scalar():
            return run(tm, lambda tx: sum(tx.read(base + i)
                                          for i in range(n)), tid=0)

        def bulk():
            return run(tm, lambda tx: int(np.sum(host_words(
                tx.read_bulk(range(base, base + n))))), tid=0)

        def timeit(fn):
            best, val = float("inf"), None
            for _ in range(repeats):
                t0 = time.perf_counter()
                val = fn()
                best = min(best, time.perf_counter() - t0)
            return val, best

        v_s, t_scalar = timeit(scalar)
        v_b, t_bulk = timeit(bulk)
        assert v_s == v_b == n, "scalar and bulk reads disagree"
        rows.append({"reads": n, "scalar_us": t_scalar * 1e6,
                     "bulk_us": t_bulk * 1e6,
                     "speedup": t_scalar / max(t_bulk, 1e-12)})
    tm.stop()
    return rows


def commitbulk_microbench(sizes=(256, 1024, 4096), repeats=5,
                          backend="tl2", device=None):
    """Commit pipeline: scalar loop vs batched acquire/write-back/release.

    A quiescent TL2 on the int64 array heap; each measurement buffers an
    n-word write set through real ``tx.write`` calls, then times the
    three commit-pipeline steps on the SAME descriptor both ways: the
    word-at-a-time scalar loop (``bulk_min`` forced past the write set)
    vs the batched pipeline (one ``try_lock_bulk`` CAS sweep + one heap
    scatter + one ``unlock_bulk``).  Asserts both leave identical heap
    state; returns timing rows.
    """
    from repro_torch.core.engine import commit as Cm

    tm = make_tm(backend, n_threads=1,
                 params=MultiverseParams(lock_table_bits=16),
                 array_heap=True, device=device)
    base = tm.alloc(max(sizes), 0)
    raw = tm.raw
    rows = []
    inf = 1 << 60
    for n in sizes:
        def pipeline(bulk_min):
            tx = raw.begin(0)
            for i in range(n):
                tx.write(base + i, i + 1)
            d = tx._ctx
            t0 = time.perf_counter()
            locked = Cm.acquire_write_locks(raw, d, bulk_min=bulk_min)
            wv = raw.clock.increment()
            Cm.write_back(raw, d, bulk_min=bulk_min)
            Cm.release_locks(raw, locked, wv, bulk_min=bulk_min)
            dt = time.perf_counter() - t0
            snap = host_words(raw.heap.gather(
                np.arange(base, base + n, dtype=np.int64)))
            d.reset()
            d.active = False
            return dt, snap

        def timeit(bulk_min):
            best, snap = float("inf"), None
            for _ in range(repeats):
                dt, snap = pipeline(bulk_min)
                best = min(best, dt)
            return best, snap

        t_scalar, snap_s = timeit(inf)
        t_bulk, snap_b = timeit(0)
        assert (snap_s == snap_b).all(), \
            "scalar and bulk commit pipelines disagree"
        rows.append({"writes": n, "scalar_us": t_scalar * 1e6,
                     "bulk_us": t_bulk * 1e6,
                     "speedup": t_scalar / max(t_bulk, 1e-12)})
    tm.stop()
    return rows


def structrq_microbench(n_keys=4096, n_buckets=1 << 10, repeats=3,
                        device=None):
    """Struct long read: frontier-at-a-time walk vs the scalar traversal.

    A quiescent hashmap with ``n_keys`` keys over ``n_buckets`` chained
    buckets (load factor 4, so chains are real).  The frontier walk is
    the shipped ``HashMap.size_query`` (bucket heads in one ``read_bulk``
    batch, then every chain advancing in lockstep via
    ``engine.traverse.chase_bulk``); the scalar reference hops each
    chain word-at-a-time through ``tx.read`` — the pre-traversal-layer
    implementation.  Asserts the two agree; returns timing rows.  The
    bucket heads come home in one copy (``traverse.host_words``) before
    the scalar walk starts, as a traversal round's words do.
    """
    from repro_torch.structs import HashMap

    tm = make_tm("multiverse", n_threads=1,
                 params=MultiverseParams(lock_table_bits=16),
                 array_heap=True, device=device)
    h = HashMap(tm, n_buckets=n_buckets)
    for k in range(n_keys):
        run(tm, lambda tx, k=k: h.insert(tx, k, k), tid=0)

    def scalar_sq(tx):
        total = 0
        heads = host_words(
            tx.read_bulk(range(h.table, h.table + h.n_buckets)))
        for node in heads:
            node = int(node)
            while node:
                total += 1
                node = int(tx.read(node + 2))
        return total

    def timeit(fn):
        best, val = float("inf"), None
        for _ in range(repeats):
            t0 = time.perf_counter()
            val = run(tm, fn, tid=0)
            best = min(best, time.perf_counter() - t0)
        return val, best

    v_f, t_frontier = timeit(h.size_query)
    v_s, t_scalar = timeit(scalar_sq)
    assert v_f == v_s == n_keys, (v_f, v_s)
    tm.stop()
    return [{"keys": n_keys, "scalar_us": t_scalar * 1e6,
             "frontier_us": t_frontier * 1e6,
             "speedup": t_scalar / max(t_frontier, 1e-12)}]


def groupcommit_microbench(n_txns=(2, 4, 8), words=256, repeats=9,
                           backend="tl2", device=None):
    """Group commit: N solo commit pipelines vs ONE fused group window.

    N ready transactions each buffer a disjoint ``words``-word block
    (consecutive addresses — collision-free under the Fibonacci lock
    hash at ``lock_table_bits=16``, so the batcher forms one group).
    Each measurement builds the same N write sets twice on the SAME
    heap and times only the commit phase: the solo loop (N full batched
    pipelines, N clock ticks) vs ``CommitBatcher.commit_all`` (one
    striped verdict+claim window, ONE clock tick, one scatter, one
    release sweep).  Asserts every commit succeeded, that the batcher
    really grouped, and that both paths leave the heap exactly at the
    payload both were asked to write.
    """
    from repro_torch.core.engine.groupcommit import CommitBatcher

    tm = make_tm(backend, n_threads=max(n_txns) + 1,
                 params=MultiverseParams(lock_table_bits=16),
                 array_heap=True, device=device)
    raw = tm.raw
    base = tm.alloc(max(n_txns) * words, 0)
    rows = []
    payload = [0]

    def build(n):
        payload[0] += 1
        txs = []
        for t in range(n):
            tx = raw.begin(t)
            lo = base + t * words
            for i in range(words):
                tx.write(lo + i, payload[0] * 1000000 + t * words + i)
            txs.append(tx)
        return txs

    def check(n):
        got = host_words(raw.heap.gather(
            np.arange(base, base + n * words, dtype=np.int64)))
        want = payload[0] * 1000000 + np.arange(n * words)
        assert (got == want).all(), "commit left the heap wrong"

    for n in n_txns:
        def solo():
            txs = build(n)
            t0 = time.perf_counter()
            for tx in txs:
                raw._try_commit(tx._ctx)
            dt = time.perf_counter() - t0
            check(n)
            return dt

        def grouped():
            txs = build(n)
            b = CommitBatcher(raw)
            for tx in txs:
                b.add(tx)
            t0 = time.perf_counter()
            ok = b.commit_all()
            dt = time.perf_counter() - t0
            assert all(ok), "group commit aborted a disjoint member"
            assert b.stats["groups"] == 1 and b.stats["grouped"] == n, \
                f"disjoint blocks did not form one group: {b.stats}"
            check(n)
            return dt

        t_solo = min(solo() for _ in range(repeats))
        t_grp = min(grouped() for _ in range(repeats))
        rows.append({"txns": n, "words": words, "solo_us": t_solo * 1e6,
                     "grouped_us": t_grp * 1e6,
                     "speedup": t_solo / max(t_grp, 1e-12)})
    tm.stop()
    return rows


def main(argv=None):
    """Runs the bake-off and the five microbenchmarks (the reference's
    sizes, ``--quick`` cuts and assertions) and returns their rows by
    table: ``bake``, ``validation``, ``read_bulk``, ``commit``,
    ``group_commit`` and ``structrq``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--backends", nargs="*", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke: short runs, fewer backends")
    ap.add_argument("--skip-validate-bench", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"bake": []}
    if args.quick:
        args.seconds = min(args.seconds, 0.3)
    if args.backends is None:
        args.backends = (["multiverse", "tl2", "norec"] if args.quick
                         else list(backend_names()))
    print(f"{'backend':10s} {'transfers':>9s} {'audits':>6s} "
          f"{'failed':>6s} {'aborts':>7s} {'versioned':>9s} mode")
    for b in args.backends:
        r = bake(b, args.seconds, device=dev)
        out["bake"].append(r)
        print(f"{r['backend']:10s} {r['transfers']:9d} {r['audits']:6d} "
              f"{r['failed_audits']:6d} {r['aborts']:7d} "
              f"{r['versioned_commits']:9d} {r['mode']}")
    if args.skip_validate_bench:
        return out
    print("\nread-set revalidation: scalar loop vs bulk vectorized path")
    print(f"{'reads':>7s} {'scalar_us':>10s} {'bulk_us':>9s} "
          f"{'speedup':>8s}")
    sizes = (1024, 4096) if args.quick else (256, 1024, 4096, 16384)
    beats_at_1k = None
    out["validation"] = validation_microbench(sizes=sizes, device=dev)
    for row in out["validation"]:
        print(f"{row['reads']:7d} {row['scalar_us']:10.1f} "
              f"{row['bulk_us']:9.1f} {row['speedup']:7.1f}x")
        if row["reads"] >= 1024 and beats_at_1k is None:
            beats_at_1k = row["speedup"] > 1.0
    assert beats_at_1k, "bulk validation did not beat the scalar loop"

    print("\nlong-running read: scalar tx.read loop vs one tx.read_bulk")
    print(f"{'reads':>7s} {'scalar_us':>10s} {'bulk_us':>9s} "
          f"{'speedup':>8s}")
    sizes = (1024, 4096) if args.quick else (1024, 4096, 16384)
    beats_at_4k = None
    out["read_bulk"] = readbulk_microbench(sizes=sizes, device=dev)
    for row in out["read_bulk"]:
        print(f"{row['reads']:7d} {row['scalar_us']:10.1f} "
              f"{row['bulk_us']:9.1f} {row['speedup']:7.1f}x")
        if row["reads"] >= 4096 and beats_at_4k is None:
            beats_at_4k = row["speedup"] >= 4.0
    assert beats_at_4k, "read_bulk did not beat the scalar loop 4x at 4k"

    print("\ncommit pipeline: scalar loop vs batched "
          "acquire/write-back/release")
    print(f"{'writes':>7s} {'scalar_us':>10s} {'bulk_us':>9s} "
          f"{'speedup':>8s}")
    sizes = (1024,) if args.quick else (256, 1024, 4096)
    beats_at_1k = None
    out["commit"] = commitbulk_microbench(sizes=sizes, device=dev)
    for row in out["commit"]:
        print(f"{row['writes']:7d} {row['scalar_us']:10.1f} "
              f"{row['bulk_us']:9.1f} {row['speedup']:7.1f}x")
        if row["writes"] >= 1024 and beats_at_1k is None:
            beats_at_1k = row["speedup"] >= 3.0
    assert beats_at_1k, \
        "bulk commit did not beat the scalar pipeline 3x at 1k writes"

    print("\ngroup commit: N solo commit pipelines vs one fused group")
    print(f"{'txns':>5s} {'words':>6s} {'solo_us':>9s} {'grouped_us':>10s} "
          f"{'speedup':>8s}")
    n_txns = (8,) if args.quick else (2, 4, 8)
    beats_at_8 = None
    out["group_commit"] = groupcommit_microbench(n_txns=n_txns,
                                                 device=dev)
    for row in out["group_commit"]:
        print(f"{row['txns']:5d} {row['words']:6d} {row['solo_us']:9.1f} "
              f"{row['grouped_us']:10.1f} {row['speedup']:7.1f}x")
        if row["txns"] >= 8 and beats_at_8 is None:
            beats_at_8 = row["speedup"] >= 3.0
    assert beats_at_8, \
        "group commit did not beat the solo loop 3x at 8 txns"

    print("\nstruct long read: scalar chain walk vs frontier-at-a-time")
    print(f"{'keys':>7s} {'scalar_us':>10s} {'frontier_us':>11s} "
          f"{'speedup':>8s}")
    out["structrq"] = structrq_microbench(n_keys=4096, device=dev)
    for row in out["structrq"]:
        print(f"{row['keys']:7d} {row['scalar_us']:10.1f} "
              f"{row['frontier_us']:11.1f} {row['speedup']:7.1f}x")
        assert row["speedup"] >= 3.0, \
            "frontier walk did not beat the scalar traversal 3x at 4k keys"
    return out


if __name__ == "__main__":
    main()
