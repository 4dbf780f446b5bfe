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
    NOT_PORTED,
    UNVERSIONED,
    WORKLOADS,
    TrialSpec,
)

__all__ = ["run_eval", "time_trial", "longread_headline",
           "rwmix_headline", "structrq_headline"]


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
    if workload in NOT_PORTED:
        raise NotImplementedError(
            f"workload {workload!r} is not ported yet "
            f"({NOT_PORTED[workload]})")
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
