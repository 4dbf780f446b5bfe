"""CLI for the port's eval subsystem: ``python -m repro_torch.eval``.

    python -m repro_torch.eval --workload longread          # the card
    python -m repro_torch.eval --workload rwmix --quick
    python -m repro_torch.eval --workload structrq --quick --device cpu
    python -m repro_torch.eval --list                       # what exists

Writes ``results/eval_<workload>.json`` and prints one table line per
trial.  Without ``--device`` the trials run on the card and the command
fails when there is none.  Exit status is non-zero if any completed long
read observed an inconsistent snapshot — the CLI doubles as a
correctness gate, not just a stopwatch.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.eval.driver import longread_headline, run_eval, \
    rwmix_headline, structrq_headline
from repro_torch.eval.workloads import NOT_PORTED, WORKLOADS


def _fmt_row(row: dict) -> str:
    extra = ""
    if "scans_per_sec" in row:
        extra = (f"scans/s={row['scans_per_sec']:8.1f} "
                 f"failed={row['failed_scans']:4d} "
                 f"updates/s={row['updates_per_sec']:8.0f}")
    elif "rqs_per_sec" in row:
        extra = (f"rqs/s={row['rqs_per_sec']:7.1f} "
                 f"failed={row['failed_ops']:4d} "
                 f"rq-vs-scan={row.get('rq_vs_scan', 0.0):5.2f}x")
    elif "write_words" in row:
        extra = (f"updates/s={row['updates_per_sec']:8.1f} "
                 f"failed={row['failed_updates']:4d} "
                 f"checks/s={row['checks_per_sec']:7.1f} "
                 f"violations={row['violations']:3d}")
    mode = row["stm_stats"].get("mode", "-")
    return (f"{row['workload']}/{row['variant']:<9s} "
            f"{row['backend']:<10s} {extra} mode={mode}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval",
        description="paper-figure evaluation: workloads x backends")
    ap.add_argument("--workload", default="longread",
                    choices=sorted(set(WORKLOADS) | set(NOT_PORTED)))
    ap.add_argument("--backends", nargs="*", default=None,
                    help="registered backend names "
                         "(default: the workload's full set)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke: fewer variants, short windows")
    ap.add_argument("--device", default=None,
                    help="where the heaps and kernels run (default: the "
                         "card; 'cpu' runs each kernel's plain version)")
    ap.add_argument("--out", default=None,
                    help="results directory (default: results/)")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--list", action="store_true",
                    help="list workloads and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name, w in sorted(WORKLOADS.items()):
            variants = ", ".join(s.variant for s in w.variants())
            print(f"{name:<10s} metric={w.metric:<14s} "
                  f"variants: {variants}")
        for name, where in sorted(NOT_PORTED.items()):
            print(f"{name:<10s} not ported yet ({where})")
        return 0

    rows, path = run_eval(
        args.workload, backends=args.backends, seed=args.seed,
        quick=args.quick, out_dir=args.out, save=not args.no_save,
        progress=lambda r: print(_fmt_row(r), flush=True),
        device=args.device)

    violations = sum(r.get("violations", 0) for r in rows)
    if args.workload == "longread":
        h = longread_headline(rows)
        if h:
            verdict = "WINS" if h["multiverse_wins"] else "does NOT win"
            base = ", ".join(f"{b}={v:.1f}" for b, v in
                             h["baseline_scans_per_sec"].items())
            print(f"\nheadline @ scan{h['scan_size']}: multiverse="
                  f"{h['multiverse_scans_per_sec']:.1f} scans/s {verdict} "
                  f"vs [{base}]")
    if args.workload == "rwmix":
        h = rwmix_headline(rows)
        if h:
            verdict = ("within 2x of the best unversioned baseline"
                       if h["within_2x"] else
                       "NOT within 2x of the best unversioned baseline")
            base = ", ".join(f"{b}={v:.1f}" for b, v in
                             h["baseline_updates_per_sec"].items())
            print(f"\nheadline @ w{h['write_words']}: multiverse="
                  f"{h['multiverse_updates_per_sec']:.1f} updates/s "
                  f"({h['ratio_vs_best']:.2f}x of best) — {verdict} "
                  f"[{base}] violations={h['violations']}")
    if args.workload == "structrq":
        h = structrq_headline(rows)
        for struct, d in sorted(h.items()):
            verdict = ("within 5x of the array scan" if d["within_5x"]
                       else "NOT within 5x of the array scan")
            print(f"\nheadline @ {struct}: multiverse rq="
                  f"{d['rq_solo_per_sec']:.1f}/s vs flat scan of "
                  f"{d['rq_words']} words={d['arrayscan_per_sec']:.1f}/s "
                  f"-> {d['rq_vs_scan']:.2f}x ({verdict})")
    if path:
        print(f"results -> {path}")
    if violations:
        print(f"CONSISTENCY VIOLATIONS: {violations}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
