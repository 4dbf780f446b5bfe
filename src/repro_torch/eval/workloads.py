"""Workload generators for the paper's long-running-read experiments.

Three families, all runnable on any registered backend through one driver
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

The JAX package's other four workloads (``shardscale``, ``serving``,
``reliability``, ``durability``) wait for the modules they drive;
``NOT_PORTED`` names the ROADMAP.md item that ports each.

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
from repro_torch.structs import STRUCTS

#: every backend the eval drives by default (the paper's comparison set)
DEFAULT_BACKENDS = ("multiverse", "tl2", "dctl", "norec", "tinystm",
                    "mvstore")
#: unversioned baselines (the "every baseline starves" side of the claim)
UNVERSIONED = ("tl2", "dctl", "norec", "tinystm")

#: the JAX package's workloads this port does not run yet, with the
#: ROADMAP.md item that ports each
NOT_PORTED = {
    "shardscale": "ROADMAP.md Queue 1 item 4, the sharded store",
    "reliability": "ROADMAP.md Queue 1 item 5, reliability",
    "durability": "ROADMAP.md Queue 1 item 5, reliability",
    "serving": "ROADMAP.md Queue 1 item 6, the serving service",
}

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
    if backend == "mvstore":
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


def _rotated(vals):
    """A block's values shifted by one: on the block's device for a
    tensor batch, on the host for a list."""
    if isinstance(vals, torch.Tensor):
        return torch.roll(vals, 1)
    return np.roll(np.asarray(vals, np.int64), 1)


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


WORKLOADS = {w.name: w for w in (LongReadWorkload(), RWMixWorkload(),
                                 StructRQWorkload())}
