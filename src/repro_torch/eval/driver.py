"""Unified eval driver: any ported workload x any registered backend.

``run_eval`` is the one entry point: it expands a workload's variants,
runs each against each backend with per-thread workers, a warmup window
(excluded from measurement) and fine-grained interpreter switching, and
writes the rows through ``repro_torch.eval.results`` — one normalized
file per workload.

    from repro_torch.eval import run_eval
    rows, path = run_eval("longread", quick=True)            # the card
    rows, path = run_eval("structrq", quick=True, device="cpu")

Thread accounting: each worker owns a private counter dict (no locks on
the hot path); the driver snapshots counters at the warmup boundary and
reports deltas over the measured window, so throughput excludes warmup
(mode transitions triggered during warmup do persist — that is the
steady state the paper measures).
"""
from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.engine import resolve_device
from repro_torch.eval.results import save_results
from repro_torch.eval.workloads import (
    DEFAULT_BACKENDS,
    UNVERSIONED,
    WORKLOADS,
    TrialSpec,
)

__all__ = ["run_eval", "time_trial", "longread_headline",
           "rwmix_headline", "shardscale_headline", "structrq_headline",
           "serving_headline", "reliability_headline",
           "durability_headline"]


def time_trial(workers: Sequence[Callable], spec: TrialSpec,
               switch_interval: float = 2e-5) -> Tuple[Dict, float]:
    """Run ``workers[i](stop_event, counters[i])`` threads for one trial.

    Returns ``(counters, measured_seconds)`` where ``counters`` holds the
    per-key deltas accumulated AFTER the warmup window — except
    ``violations``, which is reported as the RAW total: a torn snapshot
    during warmup is still a correctness failure, never a number to
    warm up past.  The switch interval is dropped so updaters genuinely
    interleave into long reads (without it an entire scan often runs
    between two interpreter switches and the paper's contention
    disappears into scheduler artifacts).
    """
    old_si = sys.getswitchinterval()
    sys.setswitchinterval(switch_interval)
    stop = threading.Event()
    counters = [defaultdict(int) for _ in workers]
    threads = [threading.Thread(target=w, args=(stop, c), daemon=True)
               for w, c in zip(workers, counters)]
    try:
        [t.start() for t in threads]
        time.sleep(spec.warmup_s)
        baseline = [dict(c) for c in counters]
        t0 = time.perf_counter()
        time.sleep(spec.duration_s)
        dt = time.perf_counter() - t0
    finally:
        stop.set()
        [t.join() for t in threads]
        sys.setswitchinterval(old_si)
    total: Dict[str, int] = defaultdict(int)
    for c, base in zip(counters, baseline):
        for k, v in c.items():
            total[k] += v if k == "violations" else v - base.get(k, 0)
    return total, dt


def run_eval(workload: str, backends: Optional[Sequence[str]] = None,
             seed: int = 0, quick: bool = False,
             out_dir: Optional[str] = None, save: bool = True,
             progress: Optional[Callable[[Dict], None]] = None,
             device=None) -> Tuple[List[Dict], Optional[str]]:
    """Run one workload family across backends; returns (rows, path).

    ``backends=None`` uses the workload's default set (all six registered
    backends unless the workload narrows it); ``quick=True`` shrinks
    variants and durations to a CI smoke.  ``progress`` is called with
    each finished row.  ``device=None`` runs on the card and raises
    before any trial without one; ``device="cpu"`` runs every kernel's
    plain version on the CPU.
    """
    try:
        w = WORKLOADS[workload]
    except KeyError:
        raise ValueError(
            f"unknown workload {workload!r}; available: "
            f"{sorted(WORKLOADS)}") from None
    device = resolve_device(device)
    names = list(backends or getattr(w, "default_backends",
                                     DEFAULT_BACKENDS))
    rows: List[Dict] = []
    for spec in w.variants(quick):
        for backend in names:
            row = w.run_trial(backend, spec, seed, device=device)
            rows.append(row)
            if progress is not None:
                progress(row)
    path = None
    if save:
        path = save_results(workload, rows, seed, out_dir=out_dir,
                            extra_meta={"workload": workload,
                                        "quick": quick,
                                        "device": str(device)})
    return rows, path


def longread_headline(rows: List[Dict]) -> Dict:
    """The paper's central claim, extracted from longread rows.

    At the LARGEST scan size: does Multiverse's completed-scan throughput
    exceed every unversioned baseline's?  Returns the comparison (the CLI
    prints it).
    """
    sizes = {r["scan_size"] for r in rows if "scan_size" in r}
    if not sizes:
        return {}
    largest = max(sizes)
    at = {r["backend"]: r["scans_per_sec"] for r in rows
          if r.get("scan_size") == largest}
    mv = at.get("multiverse", 0.0)
    baselines = {b: at[b] for b in UNVERSIONED if b in at}
    return {
        "scan_size": largest,
        "multiverse_scans_per_sec": mv,
        "baseline_scans_per_sec": baselines,
        "multiverse_wins": bool(baselines) and all(
            mv > v for v in baselines.values()),
    }


def rwmix_headline(rows: List[Dict]) -> Dict:
    """The paper's SECOND headline claim, extracted from rwmix rows.

    At the LARGEST write-set size: does Multiverse's committed-update
    throughput stay within 2x of the BEST unversioned baseline's, with
    zero consistency violations?  (Unversioned STMs are supposed to win
    the update-heavy regime; Multiverse matching them shows the
    versioning machinery is pay-as-you-go.)
    """
    sizes = {r["write_words"] for r in rows if "write_words" in r}
    if not sizes:
        return {}
    largest = max(sizes)
    at = {r["backend"]: r["updates_per_sec"] for r in rows
          if r.get("write_words") == largest}
    mv = at.get("multiverse", 0.0)
    baselines = {b: at[b] for b in UNVERSIONED if b in at}
    best = max(baselines.values()) if baselines else 0.0
    ratio = mv / best if best > 0 else 0.0
    return {
        "write_words": largest,
        "multiverse_updates_per_sec": mv,
        "baseline_updates_per_sec": baselines,
        "best_unversioned": best,
        "ratio_vs_best": ratio,
        "within_2x": bool(baselines) and ratio >= 0.5,
        # the MULTIVERSE claim's own violations — a baseline backend's
        # torn snapshot must not print as multiverse's; the CLI's global
        # exit gate still sums every row's violations separately
        "violations": sum(r.get("violations", 0) for r in rows
                          if r.get("backend") == "multiverse"),
    }


def shardscale_headline(rows: List[Dict]) -> Dict:
    """The SHARDING claim, extracted from shardscale rows.

    Same total heap words, same two disjoint-block updaters: does the
    2-shard store's committed-update throughput reach >=1.6x the
    1-shard store's?  At one shard both updaters share a commit clock
    and every interleaved publish forces an abort/retry; at two shards
    the per-shard clocks make the same workload conflict-free, so the
    ratio measures exactly the waste the two-level clock removes.  The
    shard==1 row's ``parity_ok`` (bit-identical dual-drive vs mvstore)
    must hold for the comparison to mean anything, and violations must
    be zero — a speedup bought with torn snapshots is a bug, not a
    result.
    """
    at = {r["n_shards"]: r for r in rows
          if r.get("backend") == "shardstore" and "n_shards" in r}
    if 1 not in at or 2 not in at:
        return {}
    base = at[1]["updates_per_sec"]
    ratio = at[2]["updates_per_sec"] / base if base > 0 else 0.0
    violations = sum(r.get("violations", 0) for r in at.values())
    return {
        "updates_per_sec": {n: r["updates_per_sec"]
                            for n, r in sorted(at.items())},
        "failed_updates": {n: r["failed_updates"]
                           for n, r in sorted(at.items())},
        "ratio_2_shards": ratio,
        "scales_1_6x": ratio >= 1.6,
        "parity_ok": bool(at[1].get("parity_ok")),
        "violations": violations,
        "holds": bool(ratio >= 1.6 and at[1].get("parity_ok")
                      and violations == 0),
    }


def serving_headline(rows: List[Dict]) -> Dict:
    """The SERVING claim, extracted from serving rows.

    At the HIGHEST target QPS: does multiverse (Mode-U ring) sustain
    the offered load — >=95% of offered requests completed, nothing
    shed, zero torn reads — while at least one baseline policy shows
    measurably degraded latency (p99 or p50 inflated vs multiverse)
    or abort-driven shedding (requests failed after repeated Mode-Q
    snapshot aborts, or shed by admission control because aborts ate
    the slot throughput)?  NaN percentiles (a baseline that starved
    outright, completing nothing) count as degraded via its
    failed/shed counters, never as a pass.
    """
    targets = {r["target_qps"] for r in rows if "target_qps" in r}
    if not targets:
        return {}
    top = max(targets)
    at = {r["backend"]: r for r in rows if r.get("target_qps") == top}
    mv = at.get("multiverse")
    if mv is None:
        return {}
    offered = max(mv.get("offered", 0), 1)
    sustained = (mv["completed"] >= 0.95 * offered
                 and mv["shed"] == 0 and mv["failed_aborts"] == 0
                 and mv["violations"] == 0)
    baselines: Dict[str, Dict] = {}
    for b, r in at.items():
        if b == "multiverse":
            continue
        p99_ratio = (r["p99_ms"] / mv["p99_ms"]
                     if mv["p99_ms"] > 0 else float("nan"))
        p50_ratio = (r["p50_ms"] / mv["p50_ms"]
                     if mv["p50_ms"] > 0 else float("nan"))
        degraded = bool(p99_ratio >= 1.25 or p50_ratio >= 1.2
                        or r["failed_aborts"] > 0 or r["shed"] > 0)
        baselines[b] = {
            "qps": r["qps"], "p50_ms": r["p50_ms"],
            "p99_ms": r["p99_ms"], "p99_ratio": p99_ratio,
            "snapshot_aborts": r["snapshot_aborts"],
            "failed_aborts": r["failed_aborts"], "shed": r["shed"],
            "mixed_version_requests": r["mixed_version_requests"],
            "degraded": degraded,
        }
    return {
        "target_qps": top,
        "multiverse_qps": mv["qps"],
        "multiverse_p50_ms": mv["p50_ms"],
        "multiverse_p99_ms": mv["p99_ms"],
        "multiverse_sustains": sustained,
        "violations": mv["violations"],
        "baselines": baselines,
        "baseline_degraded": any(d["degraded"]
                                 for d in baselines.values()),
    }


def reliability_headline(rows: List[Dict]) -> Dict:
    """The crash-recovery claim, extracted from reliability rows.

    Per backend, compare the faulted variant (a worker killed
    mid-publish every ~kill_every commits, recovered, re-admitted)
    against the fault-free twin: recovery must actually have run
    (kills > 0, every kill recovered), the trial must stay within 2x of
    fault-free throughput (ratio >= 0.5), and violations — torn checker
    reads AND post-trial invariant failures — must be zero.  The CLI
    exits non-zero on any violation; ``holds`` summarizes the rest.
    """
    per: Dict[str, Dict] = {}
    for r in rows:
        if "kill_every" not in r:
            continue
        slot = per.setdefault(r["backend"], {})
        key = "faulted" if r["kill_every"] else "nofault"
        slot[key] = r
    out: Dict[str, Dict] = {}
    for backend, slot in per.items():
        nf, f = slot.get("nofault"), slot.get("faulted")
        if nf is None or f is None:
            continue
        base = nf["updates_per_sec"]
        ratio = f["updates_per_sec"] / base if base > 0 else 0.0
        violations = nf["violations"] + f["violations"]
        out[backend] = {
            "kill_every": f["kill_every"],
            "kills": f["kills"],
            "recoveries": f["recoveries"],
            "rolled_forward": f["rolled_forward"],
            "rolled_back": f["rolled_back"],
            "nofault_updates_per_sec": base,
            "faulted_updates_per_sec": f["updates_per_sec"],
            "ratio_vs_nofault": ratio,
            "violations": violations,
            "holds": bool(f["kills"] > 0
                          and f["recoveries"] == f["kills"]
                          and ratio >= 0.5 and violations == 0),
        }
    return out


def durability_headline(rows: List[Dict]) -> Dict:
    """The durable-commit claim, extracted from durability rows.

    Per backend, compare durable variants (fsync'd WAL on the commit
    path + end-of-trial restart drill) against their in-memory twins.
    The gate runs on the GROUP-COMMIT pair when the backend actually
    fused groups — that is the amortized configuration the durability
    layer is designed around (one journal fsync per disjoint batch);
    the solo pair is reported alongside as ``solo_ratio_vs_inmem``, the
    unamortized fsync-per-commit tax.  ``holds`` requires the gated
    ratio >= 0.5, a restart drill that replayed records into a fresh
    engine, and zero violations — torn checker reads, post-trial
    invariant failures AND restart-drill failures — across all four
    variants.
    """
    per: Dict[str, Dict] = {}
    for r in rows:
        if "durable" not in r or r.get("workload") != "durability":
            continue
        per.setdefault(r["backend"], {})[r["variant"]] = r
    out: Dict[str, Dict] = {}
    for backend, slot in per.items():
        im, du = slot.get("inmem"), slot.get("durable")
        img, dug = slot.get("inmem-group"), slot.get("durable-group")
        solo_ratio = None
        if im is not None and du is not None and \
                im["updates_per_sec"] > 0:
            solo_ratio = du["updates_per_sec"] / im["updates_per_sec"]
        # gate on the group pair when it genuinely grouped; otherwise
        # (backend without a fused path, or group rows absent) the solo
        # pair is all there is
        use_group = (img is not None and dug is not None
                     and dug.get("grouped_members", 0) > 0
                     and img["updates_per_sec"] > 0)
        gate_im, gate_du = (img, dug) if use_group else (im, du)
        if gate_im is None or gate_du is None:
            continue
        base = gate_im["updates_per_sec"]
        ratio = gate_du["updates_per_sec"] / base if base > 0 else 0.0
        violations = sum(r["violations"] for r in slot.values())
        replayed = gate_du["wal_records_replayed"]
        out[backend] = {
            "gated_on": "group" if use_group else "solo",
            "inmem_updates_per_sec": base,
            "durable_updates_per_sec": gate_du["updates_per_sec"],
            "ratio_vs_inmem": ratio,
            "solo_ratio_vs_inmem": solo_ratio,
            "wal_records_replayed": replayed,
            "fsyncs": gate_du.get("wal_stats", {}).get("fsyncs", 0),
            "commit_groups": gate_du.get("commit_groups", 0),
            "violations": violations,
            "holds": bool(ratio >= 0.5 and violations == 0
                          and replayed > 0),
        }
    return out


def structrq_headline(rows: List[Dict]) -> Dict:
    """Struct long reads vs equivalent-size array scans, per structure.

    Each structrq row carries a quiescent single-thread reference pair
    (`rq_solo_per_sec` vs `arrayscan_per_sec` over the SAME word count
    on the same backend+heap); the headline extracts Multiverse's ratio
    per structure and whether it lands within 5x of the flat scan.
    Returns ``{structure: {...}}``.
    """
    out: Dict[str, Dict] = {}
    for r in rows:
        if r.get("backend") == "multiverse" and "rq_vs_scan" in r:
            ratio = r["rq_vs_scan"]
            out[r["structure"]] = {
                "rq_words": r["rq_words"],
                "rq_solo_per_sec": r["rq_solo_per_sec"],
                "arrayscan_per_sec": r["arrayscan_per_sec"],
                "rq_vs_scan": ratio,
                "within_5x": ratio >= 0.2,
            }
    return out
