"""Workload generators for the paper's long-running-read experiments.

Seven families, all runnable on any registered backend through one driver
(``repro_torch.eval.driver``), with the heap, lock words and store blocks
on the card unless the caller names another device:

  * ``longread``  — the headline regime (paper Figs. 1/6/7): dedicated
    updater threads commit word transfers while scanner threads run ONE
    transaction each that reads an entire region via ``Txn.read_bulk``
    (chunked, so updaters genuinely interleave mid-scan).  Variants scale
    the scan size; every completed scan checks the balance invariant, so
    throughput and snapshot consistency are measured together.  This is
    the workload where unversioned TMs starve and Multiverse/MVStore pull
    ahead — the paper's central claim.
  * ``rwmix``     — the WRITE-HEAVY headline (paper SS5's update
    throughput): dedicated updater threads commit whole-block rewrites
    (write sets large enough to engage the batched commit pipeline —
    bulk lock-acquire, scatter write-back, bulk release) over disjoint
    block sets, while a checker thread bulk-reads random blocks and
    verifies the block-sum invariant (a torn commit snapshot counts as
    a violation and fails the CLI).  The headline asks whether
    Multiverse's update throughput stays within 2x of the best
    unversioned baseline.
  * ``serving``   — the SERVING headline (the paper's production
    scenario): the ``repro_torch.serve`` subsystem answers open-loop
    request traffic from MVStore parameter snapshots while a trainer
    thread commits every few milliseconds.  "Backends" here are serving
    policies over the same store — ``multiverse`` (Mode-U ring,
    per-request pinned clocks), ``modeq`` (Mode-Q validation: a commit
    since pin aborts the request, which restarts at a fresh clock) and
    ``unversioned`` (always read live, never abort — requests silently
    mix parameter versions).  Rows carry qps + p50/p95/p99 latency +
    shed/abort counts from the serving telemetry.
  * ``structrq``  — data-structure long reads over ``repro_torch.structs``
    (hashmap / extbst / abtree): reader threads run whole-structure
    range queries (size queries on the hashmap) while a dedicated
    updater commits size-preserving key moves, the Fig. 6/7 shape.
    Every completed query checks the size invariant (``violations``),
    and each trial ends with a quiescent reference measurement — the
    same backend scanning an EQUAL number of flat words through
    ``read_bulk`` — so the headline ratio (``rq_vs_scan``) states how
    close the frontier-at-a-time struct traversal comes to an array
    scan of the same volume.
  * ``shardscale`` — rwmix's geometry on the sharded store
    (``shardstore``) at 1 / 2 / 4 shards: two updaters whose blocks lie
    on disjoint shards from two shards up, so the per-shard clocks
    remove the abort/retry waste one shared clock causes; the 1-shard
    row carries ``parity_ok`` (the same history through shardstore(1)
    and mvstore gives the same heap).

  * ``reliability`` — rwmix's rotations while a seeded fault schedule
    kills an updater mid-commit every ~``kill_every`` commits; the dead
    worker's slot runs crash recovery and rejoins (``durable``: with an
    fsync'd write-ahead log attached).
  * ``durability`` — rwmix's rotations in memory vs with the write-ahead
    log (solo and group commit), each durable trial ending in a restart
    drill that replays the log into a fresh engine.


Workload objects expose ``variants(quick)`` -> [TrialSpec] and
``run_trial(backend, spec, seed, device=None)`` -> row dict; the driver
owns threads, warmup and the results file.  Every RNG derives from the
trial seed, so a results row names the exact op stream it measured.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List

import numpy as np
import torch

from repro_torch.api import MaxRetriesExceeded, make_tm, run
from repro_torch.configs.paper_stm import MultiverseParams
from repro_torch.core.engine.traverse import host_words
from repro_torch.structs import STRUCTS

#: every backend the eval drives by default (the paper's comparison set)
DEFAULT_BACKENDS = ("multiverse", "tl2", "dctl", "norec", "tinystm",
                    "mvstore")
#: unversioned baselines (the "every baseline starves" side of the claim)
UNVERSIONED = ("tl2", "dctl", "norec", "tinystm")

INITIAL = 100          # per-word prefill: transfers preserve region sums
AMOUNT = 5


@dataclasses.dataclass(frozen=True)
class TrialSpec:
    """One (workload variant x backend) trial, fully named."""

    workload: str
    variant: str                 # display label ("scan4096", "hashmap")
    n_readers: int
    n_updaters: int
    duration_s: float
    warmup_s: float
    params: Dict                 # workload-specific knobs

    @property
    def total_threads(self) -> int:
        return self.n_readers + self.n_updaters


def _tm_params() -> MultiverseParams:
    # K thresholds count ATTEMPTS; eval scans cost ~ms per attempt (vs
    # ~0.1ms on the paper's EPYC), so thresholds scale down to keep the
    # same wall-clock engagement point.  K3=3: a Mode-Q versioned scanner
    # can abort on every fresh-written unversioned address, so the
    # Q->QtoU CAS must engage within a few attempts or short trials
    # measure the livelock, not the steady state
    return MultiverseParams(k1=2, k2=3, k3=3, lock_table_bits=12)


def _make(backend: str, n_threads: int, params=None, device=None):
    params = params or _tm_params()
    if backend in ("mvstore", "shardstore"):
        return make_tm(backend, n_threads, params=params, device=device)
    # numeric word workloads run on the int64 array heap so read_bulk
    # gathers are single kernel launches
    return make_tm(backend, n_threads, params=params, array_heap=True,
                   device=device)


def _batch_sum(vals) -> int:
    """The sum of one ``read_bulk`` batch: a tensor (on the card, a clean
    batch) in one reduction and one copy home, a list element by
    element."""
    if isinstance(vals, (torch.Tensor, np.ndarray)):
        return int(vals.sum())
    return sum(int(v) for v in vals)


# ---------------------------------------------------------------------------
# longread: frequent updaters + whole-region scanners
# ---------------------------------------------------------------------------


class LongReadWorkload:
    name = "longread"
    metric = "scans_per_sec"

    def variants(self, quick: bool = False) -> List[TrialSpec]:
        if quick:
            # window must outlive the Q->QtoU->U transition transient or
            # the smoke measures the mode machinery engaging, not the TM
            sizes, dur, warm = (512,), 0.8, 0.3
        else:
            sizes, dur, warm = (256, 1024, 4096), 1.5, 0.3
        return [TrialSpec(
            workload=self.name, variant=f"scan{n}", n_readers=1,
            n_updaters=2, duration_s=dur, warmup_s=warm,
            params=dict(scan_size=n, chunk=256, scanner_retries=60,
                        updater_retries=2000),
        ) for n in sizes]

    def run_trial(self, backend: str, spec: TrialSpec, seed: int,
                  device=None) -> Dict:
        from repro_torch.eval.driver import time_trial
        p = spec.params
        scan, chunk = p["scan_size"], p["chunk"]
        tm = _make(backend, spec.total_threads, device=device)
        base = tm.alloc(scan, INITIAL)
        expected = scan * INITIAL

        def scanner(tid, stop, c):
            def scan_tx(tx):
                tot = 0
                for off in range(0, scan, chunk):
                    hi = min(off + chunk, scan)
                    tot += _batch_sum(tx.read_bulk(
                        range(base + off, base + hi)))
                return tot
            while not stop.is_set():
                try:
                    tot = run(tm, scan_tx, tid=tid,
                              max_retries=p["scanner_retries"])
                    c["scans"] += 1
                    if tot != expected:
                        c["violations"] += 1
                except MaxRetriesExceeded:
                    c["failed_scans"] += 1

        def updater(tid, stop, c):
            r = random.Random(seed * 10007 + 100 + tid)

            def transfer(tx):
                i = r.randrange(scan)
                j = r.randrange(scan - 1)
                if j >= i:
                    j += 1
                a = tx.read(base + i)
                b = tx.read(base + j)
                tx.write(base + i, a - AMOUNT)
                tx.write(base + j, b + AMOUNT)
            while not stop.is_set():
                try:
                    run(tm, transfer, tid=tid,
                        max_retries=p["updater_retries"])
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1

        workers = [lambda stop, c, t=t: scanner(t, stop, c)
                   for t in range(spec.n_readers)]
        workers += [lambda stop, c, t=t: updater(spec.n_readers + t,
                                                 stop, c)
                    for t in range(spec.n_updaters)]
        counters, dt = time_trial(workers, spec)
        stats = tm.stats()
        tm.stop()
        return {
            "workload": self.name, "backend": backend,
            "tm": backend, "variant": spec.variant, "seed": seed,
            "scan_size": scan, "chunk": chunk,
            "scans_per_sec": counters["scans"] / dt,
            "failed_scans": counters["failed_scans"],
            "violations": counters["violations"],
            "updates_per_sec": counters["updates"] / dt,
            "failed_updates": counters["failed_updates"],
            "mode_transitions": stats.get("mode_transitions", 0),
            "stm_stats": stats,
        }


# ---------------------------------------------------------------------------
# rwmix: whole-block rotations + a block-sum checker
# ---------------------------------------------------------------------------


def _rotated(vals, shift: int = 1):
    """A block's values shifted by ``shift``: on the block's device for
    a tensor batch, on the host for a list."""
    if isinstance(vals, torch.Tensor):
        return torch.roll(vals, shift)
    return np.roll(np.asarray(vals, np.int64), shift)


class RWMixWorkload:
    """Write-heavy blocks + a consistency checker (see module docstring).

    The region is ``n_blocks`` aligned blocks of ``write_words`` words,
    prefilled so every block sums to ``write_words * INITIAL``.  Each
    updater owns the blocks congruent to its id (disjoint write sets —
    the measured quantity is the commit pipeline, not inter-updater
    conflict resolution) and commits a sum-preserving ROTATION of one
    block per transaction: one ``read_bulk`` of the block, one
    ``write_bulk`` of its values shifted by one.  The checker
    bulk-reads random blocks; a completed read whose sum is off is a
    torn commit snapshot (``violations`` — the CLI exits non-zero on
    any).

    The lock table is LARGE (2^16): block-disjoint address sets still
    alias in a hashed lock table, and at 2^12 two concurrent 1k-word
    claims share hundreds of lock words — the trial would measure
    aliasing thrash, not the commit pipeline.
    """

    name = "rwmix"
    metric = "updates_per_sec"

    def variants(self, quick: bool = False) -> List[TrialSpec]:
        sizes = (512,) if quick else (256, 1024)
        dur, warm = (0.8, 0.3) if quick else (1.2, 0.3)
        return [TrialSpec(
            workload=self.name, variant=f"w{wb}", n_readers=1,
            n_updaters=2, duration_s=dur, warmup_s=warm,
            params=dict(write_words=wb, n_blocks=8, max_retries=2000),
        ) for wb in sizes]

    def run_trial(self, backend: str, spec: TrialSpec, seed: int,
                  device=None) -> Dict:
        from repro_torch.eval.driver import time_trial
        p = spec.params
        wb, n_blocks = p["write_words"], p["n_blocks"]
        n_upd = spec.n_updaters
        # update-heavy steady state = the paper's Mode-Q regime: keep the
        # go-versioned / mode-CAS thresholds high so a checker that races
        # a block rewrite just retries unversioned (its re-read is cheap)
        # instead of versioning whole blocks and dragging every updater
        # onto the version-append path
        tm = _make(backend, spec.total_threads,
                   params=MultiverseParams(k1=30, k2=200, k3=200,
                                           lock_table_bits=16),
                   device=device)
        base = tm.alloc(wb * n_blocks, INITIAL)
        block_sum = wb * INITIAL

        def updater(tid, stop, c):
            r = random.Random(seed * 10007 + 300 + tid)
            mine = [b for b in range(n_blocks) if b % n_upd == tid]

            def rotate(tx):
                off = base + wb * mine[r.randrange(len(mine))]
                vals = tx.read_bulk(range(off, off + wb))
                tx.write_bulk(range(off, off + wb), _rotated(vals))
            while not stop.is_set():
                try:
                    run(tm, rotate, tid=tid,
                        max_retries=p["max_retries"])
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1

        def checker(tid, stop, c):
            r = random.Random(seed * 10007 + 900 + tid)

            def check(tx):
                off = base + wb * r.randrange(n_blocks)
                return _batch_sum(tx.read_bulk(range(off, off + wb)))
            while not stop.is_set():
                try:
                    got = run(tm, check, tid=tid,
                              max_retries=p["max_retries"])
                    c["checks"] += 1
                    if got != block_sum:
                        c["violations"] += 1
                except MaxRetriesExceeded:
                    c["failed_checks"] += 1

        workers = [lambda stop, c, t=t: updater(t, stop, c)
                   for t in range(n_upd)]
        workers += [lambda stop, c, t=t: checker(n_upd + t, stop, c)
                    for t in range(spec.n_readers)]
        counters, dt = time_trial(workers, spec)
        stats = tm.stats()
        tm.stop()
        return {
            "workload": self.name, "backend": backend, "tm": backend,
            "variant": spec.variant, "seed": seed,
            "write_words": wb, "n_blocks": n_blocks,
            "updates_per_sec": counters["updates"] / dt,
            "failed_updates": counters["failed_updates"],
            "checks_per_sec": counters["checks"] / dt,
            "failed_checks": counters["failed_checks"],
            "violations": counters["violations"],
            "mode_transitions": stats.get("mode_transitions", 0),
            "stm_stats": stats,
        }


# ---------------------------------------------------------------------------
# shardscale: disjoint-block updaters across 1/2/4 store shards
# ---------------------------------------------------------------------------


def _shard_parity_check(seed: int, wb: int, n_blocks: int, params,
                        device=None) -> bool:
    """Drive one deterministic single-thread history through BOTH
    ``shardstore(n_shards=1, span=wb)`` and ``mvstore`` and compare the
    final heaps bit-for-bit.

    At one shard the address routing is the identity and the shard-local
    clock IS the store clock, so the sharded store must be
    indistinguishable from the unsharded one — the conformance anchor
    the scaling claim hangs off (the 2- and 4-shard rows are only
    meaningful if shard==1 is exactly the baseline)."""
    r = random.Random(seed * 7919 + 17)
    ops = [(r.randrange(n_blocks), 1 + r.randrange(wb - 1))
           for _ in range(24)]
    heaps = []
    for backend, kw in (("mvstore", {}),
                        ("shardstore", dict(n_shards=1, span=wb))):
        tm = make_tm(backend, 1, params=params, device=device, **kw)
        base = tm.alloc(wb * n_blocks, INITIAL)

        def ramp(tx):
            # constant prefill would make rotations invisible; stamp a
            # per-word ramp so any routing slip changes the final heap
            tx.write_bulk(range(base, base + wb * n_blocks),
                          np.arange(wb * n_blocks, dtype=np.int64) * 3 + 7)
        run(tm, ramp, tid=0)
        for b, k in ops:
            off = base + wb * b

            def rot(tx, off=off, k=k):
                vals = tx.read_bulk(range(off, off + wb))
                tx.write_bulk(range(off, off + wb), _rotated(vals, k))
            run(tm, rot, tid=0)

        def dump(tx):
            return np.asarray(host_words(tx.read_bulk(
                range(base, base + wb * n_blocks))), np.int64)
        heaps.append(run(tm, dump, tid=0))
        tm.stop()
    return bool(np.array_equal(heaps[0], heaps[1]))


class ShardScaleWorkload:
    """Disjoint-block scaling across store shards (the two-level clock's
    payoff).

    Same geometry as rwmix — ``n_blocks`` span-aligned blocks of
    ``write_words`` words, two updaters owning the blocks congruent to
    their id, a sum checker — but the store is a ``shardstore`` with
    ``span=write_words``, so block ``b`` lives wholly on shard
    ``b % n_shards`` and the two updaters' footprints land on DISJOINT
    shards for every ``n_shards >= 2``.  At one shard both updaters
    share a single commit clock: every interleaved publish stales the
    other's pin and forces a full re-read/re-write attempt.  At two
    shards each updater ticks its own shard-local clock and commits
    conflict-free — the measured speedup is exactly the abort/retry
    waste the per-shard clocks eliminate (total heap words are IDENTICAL
    at every shard count; nothing else changes).

    The shard==1 row additionally carries ``parity_ok``: a deterministic
    dual-drive of the same history through shardstore(1) and mvstore
    comparing final heaps bit-for-bit (the conformance anchor)."""

    name = "shardscale"
    metric = "updates_per_sec"
    default_backends = ("shardstore",)
    #: CLI override (``--shards``); None = the variant defaults below
    shards = None

    def variants(self, quick: bool = False) -> List[TrialSpec]:
        counts = self.shards or ((1, 2) if quick else (1, 2, 4))
        wb = 512
        dur, warm = (0.8, 0.3) if quick else (1.2, 0.3)
        return [TrialSpec(
            workload=self.name, variant=f"s{n}", n_readers=1,
            n_updaters=2, duration_s=dur, warmup_s=warm,
            params=dict(n_shards=n, write_words=wb, n_blocks=8,
                        max_retries=2000),
        ) for n in counts]

    def run_trial(self, backend: str, spec: TrialSpec, seed: int,
                  device=None) -> Dict:
        from repro_torch.eval.driver import time_trial
        p = spec.params
        wb, n_blocks = p["write_words"], p["n_blocks"]
        n_shards = p["n_shards"]
        n_upd = spec.n_updaters
        params = MultiverseParams(k1=30, k2=200, k3=200,
                                  lock_table_bits=16)
        if backend == "shardstore":
            tm = make_tm(backend, spec.total_threads, params=params,
                         n_shards=n_shards, span=wb, device=device)
        else:
            # unsharded comparison rows (n_shards is recorded but moot)
            tm = _make(backend, spec.total_threads, params=params,
                       device=device)
        base = tm.alloc(wb * n_blocks, INITIAL)
        block_sum = wb * INITIAL

        def updater(tid, stop, c):
            r = random.Random(seed * 10007 + 300 + tid)
            mine = [b for b in range(n_blocks) if b % n_upd == tid]

            def rotate(tx):
                off = base + wb * mine[r.randrange(len(mine))]
                vals = tx.read_bulk(range(off, off + wb))
                tx.write_bulk(range(off, off + wb), _rotated(vals))
            while not stop.is_set():
                try:
                    run(tm, rotate, tid=tid,
                        max_retries=p["max_retries"])
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1

        def checker(tid, stop, c):
            r = random.Random(seed * 10007 + 900 + tid)

            def check(tx):
                off = base + wb * r.randrange(n_blocks)
                return _batch_sum(tx.read_bulk(range(off, off + wb)))
            while not stop.is_set():
                try:
                    got = run(tm, check, tid=tid,
                              max_retries=p["max_retries"])
                    c["checks"] += 1
                    if got != block_sum:
                        c["violations"] += 1
                except MaxRetriesExceeded:
                    c["failed_checks"] += 1

        workers = [lambda stop, c, t=t: updater(t, stop, c)
                   for t in range(n_upd)]
        workers += [lambda stop, c, t=t: checker(n_upd + t, stop, c)
                    for t in range(spec.n_readers)]
        counters, dt = time_trial(workers, spec)
        stats = tm.stats()
        tm.stop()
        parity = None
        if backend == "shardstore" and n_shards == 1:
            parity = _shard_parity_check(seed, wb, n_blocks, params,
                                         device=device)
        return {
            "workload": self.name, "backend": backend, "tm": backend,
            "variant": spec.variant, "seed": seed,
            "n_shards": n_shards, "write_words": wb,
            "n_blocks": n_blocks,
            "updates_per_sec": counters["updates"] / dt,
            "failed_updates": counters["failed_updates"],
            "checks_per_sec": counters["checks"] / dt,
            "failed_checks": counters["failed_checks"],
            "violations": counters["violations"],
            "cross_shard_commits": stats.get("cross_shard_commits", 0),
            "parity_ok": parity,
            "mode_transitions": stats.get("mode_transitions", 0),
            "stm_stats": stats,
        }


# ---------------------------------------------------------------------------
# structrq: data-structure ops with range queries as the long reads
# ---------------------------------------------------------------------------


class StructRQWorkload:
    name = "structrq"
    metric = "rqs_per_sec"
    #: store-level substrate works too but every struct op is a whole
    #: commit — prefill-bound; opt in via --backends
    default_backends = ("multiverse", "tl2", "dctl", "norec", "tinystm")

    def variants(self, quick: bool = False) -> List[TrialSpec]:
        structs = ("hashmap",) if quick else ("hashmap", "extbst",
                                              "abtree")
        dur, warm = (0.5, 0.15) if quick else (1.5, 0.3)
        prefill = 200 if quick else 800
        return [TrialSpec(
            workload=self.name, variant=s, n_readers=2, n_updaters=1,
            duration_s=dur, warmup_s=warm,
            params=dict(structure=s, prefill=prefill,
                        key_range=prefill * 4, chunk=256,
                        max_retries=150, ref_window_s=0.25),
        ) for s in structs]

    def run_trial(self, backend: str, spec: TrialSpec, seed: int,
                  device=None) -> Dict:
        import time

        from repro_torch.eval.driver import time_trial
        p = spec.params
        kind = p["structure"]
        prefill = p["prefill"]
        # structs store only ints here, so word backends run on the
        # int64 array heap — same substrate the flat-scan reference uses
        tm = _make(backend, spec.total_threads, device=device)
        cls = STRUCTS[kind]
        s = cls(tm, n_buckets=1 << 10) if kind == "hashmap" else cls(tm)
        rnd = random.Random(42 + seed)
        filled = 0
        while filled < prefill:
            k = rnd.randrange(p["key_range"])
            if run(tm, lambda tx, k=k: s.insert(tx, k, k), tid=0):
                filled += 1

        # the long read: whole-structure range/size query.  The size is
        # invariant under the updater's key moves, so a completed query
        # that does not see exactly `prefill` keys is a torn snapshot.
        if kind == "hashmap":
            def rq(tx):
                return s.size_query(tx)
        else:
            def rq(tx):
                return len(s.range_query(tx, 0, prefill + 1))

        def reader(tid, stop, c):
            while not stop.is_set():
                try:
                    got = run(tm, rq, tid=tid,
                              max_retries=p["max_retries"])
                    c["rqs"] += 1
                    if got != prefill:
                        c["violations"] += 1
                except MaxRetriesExceeded:
                    c["failed_ops"] += 1

        def updater(tid, stop, c):
            r = random.Random(seed * 10007 + 700 + tid)

            def move(tx):
                ka = r.randrange(p["key_range"])
                kb = r.randrange(p["key_range"])
                if s.delete(tx, ka):
                    if not s.insert(tx, kb, kb):
                        s.insert(tx, ka, ka)   # kb existed: put ka back
            while not stop.is_set():
                try:
                    run(tm, move, tid=tid, max_retries=p["max_retries"])
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1

        workers = [lambda stop, c, t=t: reader(t, stop, c)
                   for t in range(spec.n_readers)]
        workers += [lambda stop, c, t=t: updater(spec.n_readers + t,
                                                 stop, c)
                    for t in range(spec.n_updaters)]
        counters, dt = time_trial(workers, spec)

        # quiescent reference: the SAME backend + heap, single thread —
        # the struct query vs a flat read_bulk scan over exactly as many
        # words, chunked like the longread scanner.  The ratio is the
        # headline: how close a pointer-chasing long read comes to an
        # equivalent-size array scan now that it traverses in batches.
        words = {}

        def probe(tx):
            got = rq(tx)
            words["n"] = tx.read_count
            return got

        violations = counters["violations"]
        if run(tm, probe, tid=0) != prefill:
            violations += 1
        rq_words = int(words["n"])
        chunk = p["chunk"]
        flat = tm.alloc(rq_words, 1)

        def scan(tx):
            tot = 0
            for off in range(0, rq_words, chunk):
                hi = min(off + chunk, rq_words)
                tot += _batch_sum(tx.read_bulk(
                    range(flat + off, flat + hi)))
            return tot

        def solo_rate(fn):
            run(tm, fn, tid=0)                 # warm (mode/clock settle)
            n, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < p["ref_window_s"]:
                run(tm, fn, tid=0)
                n += 1
            return n / (time.perf_counter() - t0)

        rq_solo = solo_rate(rq)
        scan_solo = solo_rate(scan)
        stats = tm.stats()
        tm.stop()
        return {
            "workload": self.name, "backend": backend, "tm": backend,
            "variant": spec.variant, "seed": seed, "structure": kind,
            "rqs_per_sec": counters["rqs"] / dt,
            "failed_ops": counters["failed_ops"],
            "violations": violations,
            "updates_per_sec": counters["updates"] / dt,
            "failed_updates": counters["failed_updates"],
            "rq_words": rq_words,
            "rq_solo_per_sec": rq_solo,
            "arrayscan_per_sec": scan_solo,
            "rq_vs_scan": rq_solo / max(scan_solo, 1e-12),
            "mode_transitions": stats.get("mode_transitions", 0),
            "stm_stats": stats,
        }


# ---------------------------------------------------------------------------
# serving: open-loop request traffic from snapshots under live commits
# ---------------------------------------------------------------------------


class ServingWorkload:
    """Continuous-batching service vs serving-policy baselines.

    Each trial runs ``repro_torch.serve.SnapshotService.synthetic`` — a
    committing trainer thread + the slot scheduler answering open-loop
    traffic — under one serving policy, with the store on the trial's
    device.  The trial's knobs pin the starvation geometry: the commit
    interval sits just above the request span, so Mode-Q requests
    usually meet a commit mid-flight and pay the abort/restart tax while
    Mode-U requests ride the ring.  The service owns its loop, so
    ``run_trial`` does not go through ``time_trial``.
    """

    name = "serving"
    metric = "p99_ms"
    default_backends = ("multiverse", "modeq", "unversioned")
    POLICY = {"multiverse": "U", "modeq": "Q", "unversioned": "live"}

    def variants(self, quick: bool = False) -> List[TrialSpec]:
        # commit interval ABOVE the ~20ms request span = the one-abort
        # latency-tax regime; BELOW it = the starvation regime where
        # Mode-Q requests abort until admission fails them (see
        # serve/service.py).  The headline reads the HIGHEST-qps point,
        # so quick and full both end on the starvation geometry
        if quick:
            points = ((50.0, 1.2, 0.012),)
        else:
            points = ((60.0, 2.5, 0.028), (120.0, 2.5, 0.012))
        return [TrialSpec(
            workload=self.name, variant=f"qps{int(qps)}", n_readers=4,
            n_updaters=1, duration_s=dur, warmup_s=0.0,
            params=dict(target_qps=qps, n_slots=4, max_new=12,
                        work_s=0.0015, commit_interval_s=ci,
                        queue_depth=64, wait_budget_s=0.5,
                        max_request_aborts=8),
        ) for qps, dur, ci in points]

    def config(self, backend: str, spec: TrialSpec, seed: int,
               **overrides):
        """The ``ServiceConfig`` of ``backend``'s trial at ``spec``;
        ``overrides`` set further fields (the store's size, its ring)."""
        from repro_torch.serve import ServiceConfig
        try:
            policy = self.POLICY[backend]
        except KeyError:
            raise ValueError(
                f"serving backend must be one of "
                f"{sorted(self.POLICY)}, got {backend!r}") from None
        p = spec.params
        return ServiceConfig(
            mode=policy, n_slots=p["n_slots"], max_new=p["max_new"],
            queue_depth=p["queue_depth"],
            wait_budget_s=p["wait_budget_s"],
            max_request_aborts=p["max_request_aborts"],
            target_qps=p["target_qps"], duration_s=spec.duration_s,
            commit_interval_s=p["commit_interval_s"],
            work_s=p["work_s"], seed=seed, **overrides)

    def run_trial(self, backend: str, spec: TrialSpec, seed: int,
                  device=None) -> Dict:
        from repro_torch.serve import SnapshotService
        svc = SnapshotService.synthetic(self.config(backend, spec, seed),
                                        device=device)
        row = svc.run_open_loop()
        row["stm_stats"]["backend"] = backend
        row.update({
            "workload": self.name, "backend": backend, "tm": backend,
            "variant": spec.variant, "seed": seed,
            "mode_transitions": 0,
        })
        return row


# ---------------------------------------------------------------------------
# reliability: rwmix under a seeded kill schedule + crash recovery
# ---------------------------------------------------------------------------


class ReliabilityWorkload:
    """rwmix's sum-preserving rotations while a seeded ``FaultSchedule``
    kills an updater roughly every ``kill_every`` commits mid-publish.

    Each kill leaves the crash image intact (held locks, a possibly
    half-published commit); the dying worker's slot runs recovery
    (``recover_engine`` — roll the decided commit forward or the
    undecided one back, sweep orphaned locks, repair torn mirror rows),
    consults ``runtime/elastic.rescale_plan`` for the degraded and
    re-admitted fleet shapes, and rejoins under the same tid — the
    supervisor restart loop collapsed into the worker thread.

    Correctness is the rwmix checker (any completed read whose block sum
    is off is a torn snapshot) PLUS a post-trial invariant sweep: lock
    table empty, no torn mirror rows, clock monotone, every block sum
    conserved.  Both land in ``violations`` so the CLI's exit gate sees
    them.  The ``nofault`` variant is the same trial without a schedule:
    the headline asks what fraction of fault-free throughput survives
    the kill/recover cycle.
    """

    name = "reliability"
    metric = "updates_per_sec"
    default_backends = ("multiverse", "tl2", "dctl")
    #: CLI ``--durable``: journal every commit to an fsync'd WAL during
    #: the trial, and hand the log to recovery so rolled-forward commits
    #: get their COMPLETE marker — the kill/recover cycle measured WITH
    #: the durability tax it would pay in production
    durable = False

    def variants(self, quick: bool = False) -> List[TrialSpec]:
        dur, warm = (0.6, 0.2) if quick else (1.2, 0.3)
        kill_every = 60 if quick else 200   # quick trials are short:
        #                                     keep several kills in frame
        return [TrialSpec(
            workload=self.name, variant=v, n_readers=1, n_updaters=2,
            duration_s=dur, warmup_s=warm,
            params=dict(write_words=256, n_blocks=8, max_retries=2000,
                        kill_every=k),
        ) for v, k in (("nofault", 0), (f"kill{kill_every}", kill_every))]

    def run_trial(self, backend: str, spec: TrialSpec, seed: int,
                  device=None) -> Dict:
        import shutil
        import tempfile

        from repro_torch.eval.driver import time_trial
        from repro_torch.reliability import faultpoints as FP
        from repro_torch.reliability.recovery import (
            check_engine_invariants, recover_engine)
        from repro_torch.reliability.wal import WriteAheadLog, attach_wal
        from repro_torch.runtime.elastic import rescale_plan
        p = spec.params
        wb, n_blocks = p["write_words"], p["n_blocks"]
        n_upd = spec.n_updaters
        # same sizing rationale as rwmix: large lock table, thresholds
        # that keep the checker unversioned (see RWMixWorkload notes)
        tm = _make(backend, spec.total_threads,
                   params=MultiverseParams(k1=30, k2=200, k3=200,
                                           lock_table_bits=16),
                   device=device)
        base = tm.alloc(wb * n_blocks, INITIAL)
        block_sum = wb * INITIAL
        eng = getattr(tm, "raw", tm)
        clock0 = eng.clock.load()
        wal_dir = None
        if self.durable:
            wal_dir = tempfile.mkdtemp(prefix="repro-wal-")
            attach_wal(tm, WriteAheadLog(wal_dir, group_sync=True))
        sched = None
        if p["kill_every"]:
            # one commit = one pre_claim + one pre_release arrival, so
            # 2*kill_every arrivals ~= a kill every kill_every commits;
            # the point mix exercises BOTH recovery directions (pre_claim
            # kills roll back, pre_release kills roll forward)
            sched = FP.FaultSchedule(
                seed=seed, kill_every=2 * p["kill_every"],
                points=("pre_claim", "pre_release"), action="kill")
            FP.install(sched)

        def updater(tid, stop, c):
            r = random.Random(seed * 10007 + 300 + tid)
            mine = [b for b in range(n_blocks) if b % n_upd == tid]

            def rotate(tx):
                off = base + wb * mine[r.randrange(len(mine))]
                vals = tx.read_bulk(range(off, off + wb))
                tx.write_bulk(range(off, off + wb), _rotated(vals))
            while not stop.is_set():
                try:
                    run(tm, rotate, tid=tid,
                        max_retries=p["max_retries"])
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1
                except FP.SimulatedCrash:
                    # worker dies mid-publish: recover its slot, plan the
                    # degraded + re-admitted fleet, rejoin at the same tid
                    try:
                        rep = recover_engine(tm, [tid], wal=eng.wal
                                             if wal_dir else None)
                        rescale_plan(n_devices=max(1, n_upd - 1),
                                     model_parallel=1,
                                     global_batch=n_blocks,
                                     old_microbatches=1)
                        rescale_plan(n_devices=n_upd, model_parallel=1,
                                     global_batch=n_blocks,
                                     old_microbatches=1)
                    except BaseException:
                        c["kills"] += 1        # a kill left unrecovered
                        raise
                    # the kill and its recovery in ONE dict update, so
                    # ``time_trial``'s warm-up snapshot (``dict(c)``, on
                    # another thread) never falls between them
                    c.update(kills=c["kills"] + 1,
                             recoveries=c["recoveries"] + 1,
                             rolled_forward=c["rolled_forward"]
                             + len(rep.rolled_forward),
                             rolled_back=c["rolled_back"]
                             + len(rep.rolled_back))

        def checker(tid, stop, c):
            r = random.Random(seed * 10007 + 900 + tid)

            def check(tx):
                off = base + wb * r.randrange(n_blocks)
                return _batch_sum(tx.read_bulk(range(off, off + wb)))
            while not stop.is_set():
                try:
                    got = run(tm, check, tid=tid,
                              max_retries=p["max_retries"])
                    c["checks"] += 1
                    if got != block_sum:
                        c["violations"] += 1
                except MaxRetriesExceeded:
                    c["failed_checks"] += 1

        workers = [lambda stop, c, t=t: updater(t, stop, c)
                   for t in range(n_upd)]
        workers += [lambda stop, c, t=t: checker(n_upd + t, stop, c)
                    for t in range(spec.n_readers)]
        try:
            counters, dt = time_trial(workers, spec)
        finally:
            if sched is not None:
                FP.uninstall()
                FP.reset_thread()
        post = check_engine_invariants(
            tm, clock_at_least=clock0,
            expect_sums=[(base + wb * b, wb, block_sum)
                         for b in range(n_blocks)])
        stats = tm.stats()
        wal_stats = {}
        if wal_dir is not None:
            wal_stats = eng.wal.stats()
            eng.wal.close()
            eng.wal = None
            shutil.rmtree(wal_dir, ignore_errors=True)
        tm.stop()
        return {
            "workload": self.name, "backend": backend, "tm": backend,
            "variant": spec.variant, "seed": seed,
            "write_words": wb, "n_blocks": n_blocks,
            "durable": bool(self.durable), "wal_stats": wal_stats,
            "kill_every": p["kill_every"],
            "updates_per_sec": counters["updates"] / dt,
            "failed_updates": counters["failed_updates"],
            "checks_per_sec": counters["checks"] / dt,
            "failed_checks": counters["failed_checks"],
            "kills": counters["kills"],
            "recoveries": counters["recoveries"],
            "rolled_forward": counters["rolled_forward"],
            "rolled_back": counters["rolled_back"],
            "violations": counters["violations"] + len(post),
            "post_invariant_failures": post,
            "mode_transitions": stats.get("mode_transitions", 0),
            "stm_stats": stats,
        }


# ---------------------------------------------------------------------------
# durability: rwmix commit throughput with vs without the fsync'd WAL,
# plus a whole-process restart drill on the durable log
# ---------------------------------------------------------------------------


class DurabilityWorkload:
    """rwmix's sum-preserving rotations, in-memory vs durable.

    Two variants on identical op streams: ``inmem`` is the plain rwmix
    commit pipeline; ``durable`` attaches a ``reliability.wal``
    WriteAheadLog, so every commit buffers a PREPARE before its claim
    and fsyncs a DECIDE at the publish flip.  The headline asks what
    fraction of in-memory commit throughput survives the durability tax
    (>= 0.5x — the fsync batches with group commit, it doesn't gate
    every scatter).

    The durable trial ends with a RESTART DRILL: the engine that ran
    the trial is discarded wholesale, a FRESH engine on the same device
    replays the log via ``recover_from_wal``, and every block sum must
    still be conserved on the rebuilt heap.  Drill failures land in
    ``violations`` so the CLI's non-zero-exit gate sees them alongside
    the live checker's torn-snapshot count.
    """

    name = "durability"
    metric = "updates_per_sec"
    # tl2 = the buffered WAL hook (PREPARE before claim, DECIDE at the
    # publish flip), dctl = the encounter hook (prepare+decide collapse
    # at the decide point) — together they cover both journaling
    # flavors, and both policies have a fused group-commit path so the
    # *-group variants measure the amortized configuration the headline
    # gates on.  multiverse's durable operation is exercised by
    # ``reliability --durable`` (its versioned write sets commit solo).
    default_backends = ("tl2", "dctl")

    def variants(self, quick: bool = False) -> List[TrialSpec]:
        dur, warm = (0.6, 0.2) if quick else (1.2, 0.3)
        return [TrialSpec(
            workload=self.name, variant=v, n_readers=1, n_updaters=2,
            duration_s=dur, warmup_s=warm,
            params=dict(write_words=256, n_blocks=8, max_retries=2000,
                        durable=d, grouped=g),
        ) for v, d, g in (("inmem", False, False),
                          ("durable", True, False),
                          ("inmem-group", False, True),
                          ("durable-group", True, True))]

    def run_trial(self, backend: str, spec: TrialSpec, seed: int,
                  device=None) -> Dict:
        import shutil
        import tempfile

        from repro_torch.core.engine.errors import AbortTx
        from repro_torch.core.engine.groupcommit import CommitBatcher
        from repro_torch.eval.driver import time_trial
        from repro_torch.reliability.recovery import check_engine_invariants
        from repro_torch.reliability.wal import (WriteAheadLog, attach_wal,
                                                 recover_from_wal)
        p = spec.params
        wb, n_blocks = p["write_words"], p["n_blocks"]
        n_upd = spec.n_updaters
        grouped = bool(p.get("grouped"))
        mk_params = MultiverseParams(k1=30, k2=200, k3=200,
                                     lock_table_bits=16)
        # group variants hand every batch member its own descriptor:
        # member tids are the block ids, checkers sit above them
        n_threads = (n_blocks + spec.n_readers if grouped
                     else spec.total_threads)
        tm = _make(backend, n_threads, params=mk_params, device=device)
        base = tm.alloc(wb * n_blocks, INITIAL)
        block_sum = wb * INITIAL
        eng = getattr(tm, "raw", tm)
        clock0 = eng.clock.load()
        wal_dir = None
        if p["durable"]:
            wal_dir = tempfile.mkdtemp(prefix="repro-wal-")
            attach_wal(tm, WriteAheadLog(wal_dir, group_sync=True))

        def updater(tid, stop, c):
            r = random.Random(seed * 10007 + 300 + tid)
            mine = [b for b in range(n_blocks) if b % n_upd == tid]

            def rotate(tx):
                off = base + wb * mine[r.randrange(len(mine))]
                vals = tx.read_bulk(range(off, off + wb))
                tx.write_bulk(range(off, off + wb), _rotated(vals))
            while not stop.is_set():
                try:
                    run(tm, rotate, tid=tid,
                        max_retries=p["max_retries"])
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1

        def group_updater(worker, stop, c):
            # one txn per owned block, disjoint write sets -> one fused
            # publish and (durable) ONE journal fsync per batch
            mine = [b for b in range(n_blocks) if b % n_upd == worker]
            batcher = CommitBatcher(eng)
            while not stop.is_set():
                txs = []
                for b in mine:
                    off = base + wb * b
                    for _attempt in range(4):
                        tx = eng.begin(b)
                        try:
                            vals = tx.read_bulk(range(off, off + wb))
                            tx.write_bulk(range(off, off + wb),
                                          _rotated(vals))
                            txs.append(tx)
                            break
                        except AbortTx:
                            continue
                for tx in txs:
                    batcher.add(tx)
                ok = batcher.commit_all()
                good = sum(ok)
                c["updates"] += good
                c["failed_updates"] += len(ok) - good
            c["groups"] = batcher.stats["groups"]
            c["grouped_members"] = batcher.stats["grouped"]

        def checker(tid, stop, c):
            r = random.Random(seed * 10007 + 900 + tid)

            def check(tx):
                off = base + wb * r.randrange(n_blocks)
                return _batch_sum(tx.read_bulk(range(off, off + wb)))
            while not stop.is_set():
                try:
                    got = run(tm, check, tid=tid,
                              max_retries=p["max_retries"])
                    c["checks"] += 1
                    if got != block_sum:
                        c["violations"] += 1
                except MaxRetriesExceeded:
                    c["failed_checks"] += 1

        upd_fn = group_updater if grouped else updater
        chk_base = n_blocks if grouped else n_upd
        workers = [lambda stop, c, t=t: upd_fn(t, stop, c)
                   for t in range(n_upd)]
        workers += [lambda stop, c, t=t: checker(chk_base + t, stop, c)
                    for t in range(spec.n_readers)]
        counters, dt = time_trial(workers, spec)
        sums = [(base + wb * b, wb, block_sum) for b in range(n_blocks)]
        post = check_engine_invariants(tm, clock_at_least=clock0,
                                       expect_sums=sums)
        stats = tm.stats()
        wal_stats: Dict = {}
        replayed = 0
        drill_failures: List = []
        if wal_dir is not None:
            wal_stats = eng.wal.stats()
            eng.wal.close()
            eng.wal = None
            tm.stop()
            # restart drill: the process image is gone — only the log
            # survives, and the fresh engine must conserve every block
            fresh = _make(backend, 1, params=mk_params, device=device)
            fresh.alloc(wb * n_blocks, INITIAL)
            rep = recover_from_wal(wal_dir, fresh)
            replayed = rep.wal_records_replayed
            drill_failures = check_engine_invariants(fresh,
                                                     expect_sums=sums)
            fresh.stop()
            shutil.rmtree(wal_dir, ignore_errors=True)
        else:
            tm.stop()
        return {
            "workload": self.name, "backend": backend, "tm": backend,
            "variant": spec.variant, "seed": seed,
            "write_words": wb, "n_blocks": n_blocks,
            "durable": bool(p["durable"]), "grouped": grouped,
            "commit_groups": counters.get("groups", 0),
            "grouped_members": counters.get("grouped_members", 0),
            "updates_per_sec": counters["updates"] / dt,
            "failed_updates": counters["failed_updates"],
            "checks_per_sec": counters["checks"] / dt,
            "failed_checks": counters["failed_checks"],
            "violations": (counters["violations"] + len(post)
                           + len(drill_failures)),
            "post_invariant_failures": post,
            "restart_drill_failures": drill_failures,
            "wal_records_replayed": replayed,
            "wal_stats": wal_stats,
            "mode_transitions": stats.get("mode_transitions", 0),
            "stm_stats": stats,
        }


WORKLOADS = {w.name: w for w in (LongReadWorkload(), RWMixWorkload(),
                                 ShardScaleWorkload(), StructRQWorkload(),
                                 ServingWorkload(),
                                 ReliabilityWorkload(),
                                 DurabilityWorkload())}
