"""CLI for the port's eval subsystem: ``python -m repro_torch.eval``.

    python -m repro_torch.eval --workload longread          # the card
    python -m repro_torch.eval --workload rwmix --quick
    python -m repro_torch.eval --workload structrq --quick --device cpu
    python -m repro_torch.eval --workload shardscale --shards 1 2 4
    python -m repro_torch.eval --workload reliability [--durable]
    python -m repro_torch.eval --workload durability --quick --device cpu
    python -m repro_torch.eval --workload serving --quick --device cpu
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

from repro_torch.eval.driver import durability_headline, \
    longread_headline, reliability_headline, run_eval, rwmix_headline, \
    serving_headline, shardscale_headline, structrq_headline
from repro_torch.eval.workloads import WORKLOADS


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
    elif "kills" in row:
        extra = (f"updates/s={row['updates_per_sec']:8.1f} "
                 f"kills={row['kills']:3d} "
                 f"recovered={row['recoveries']:3d} "
                 f"fwd={row['rolled_forward']:3d} "
                 f"back={row['rolled_back']:3d} "
                 f"violations={row['violations']:3d}")
    elif "n_shards" in row:
        parity = row.get("parity_ok")
        extra = (f"shards={row['n_shards']:2d} "
                 f"updates/s={row['updates_per_sec']:8.1f} "
                 f"failed={row['failed_updates']:4d} "
                 f"checks/s={row['checks_per_sec']:7.1f} "
                 f"violations={row['violations']:3d}"
                 + (f" parity={'ok' if parity else 'FAIL'}"
                    if parity is not None else ""))
    elif "write_words" in row:
        extra = (f"updates/s={row['updates_per_sec']:8.1f} "
                 f"failed={row['failed_updates']:4d} "
                 f"checks/s={row['checks_per_sec']:7.1f} "
                 f"violations={row['violations']:3d}")
    elif "p99_ms" in row:
        extra = (f"qps={row['qps']:6.1f}/{row['target_qps']:<4.0f}"
                 f"p50={row['p50_ms']:6.1f}ms p99={row['p99_ms']:7.1f}ms "
                 f"shed={row['shed']:3d} failed={row['failed_aborts']:3d} "
                 f"aborts={row['snapshot_aborts']:4d}")
    mode = row["stm_stats"].get("mode", "-")
    return (f"{row['workload']}/{row['variant']:<9s} "
            f"{row['backend']:<10s} {extra} mode={mode}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval",
        description="paper-figure evaluation: workloads x backends")
    ap.add_argument("--workload", default="longread",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--backends", nargs="*", default=None,
                    help="registered backend names "
                         "(default: the workload's full set)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", nargs="*", type=int, default=None,
                    help="shardscale only: shard counts to sweep "
                         "(default: 1 2 4, or 1 2 with --quick)")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke: fewer variants, short windows")
    ap.add_argument("--durable", action="store_true",
                    help="reliability only: journal every commit to an "
                         "fsync'd WAL during the kill/recover trials")
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
        return 0

    if args.shards:
        WORKLOADS["shardscale"].shards = tuple(args.shards)
    if args.durable:
        WORKLOADS["reliability"].durable = True
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
    if args.workload == "shardscale":
        h = shardscale_headline(rows)
        if h:
            verdict = (">=1.6x at 2 shards" if h["scales_1_6x"]
                       else "does NOT reach 1.6x at 2 shards")
            ups = ", ".join(f"s{n}={v:.1f}" for n, v in
                            h["updates_per_sec"].items())
            parity = "ok" if h["parity_ok"] else "FAIL"
            print(f"\nheadline: shardstore [{ups}] updates/s -> "
                  f"{h['ratio_2_shards']:.2f}x ({verdict}) "
                  f"parity@1shard={parity} "
                  f"violations={h['violations']}")
    if args.workload == "serving":
        h = serving_headline(rows)
        if h:
            verdict = ("SUSTAINS target QPS" if h["multiverse_sustains"]
                       else "does NOT sustain target QPS")
            print(f"\nheadline @ qps{h['target_qps']:.0f}: multiverse="
                  f"{h['multiverse_qps']:.1f} qps "
                  f"p99={h['multiverse_p99_ms']:.1f}ms {verdict} "
                  f"(violations={h['violations']})")
            for b, d in sorted(h["baselines"].items()):
                tag = "DEGRADED" if d["degraded"] else "not degraded"
                print(f"  vs {b:<12s} p99={d['p99_ms']:8.1f}ms "
                      f"({d['p99_ratio']:.2f}x) shed={d['shed']} "
                      f"failed={d['failed_aborts']} "
                      f"aborts={d['snapshot_aborts']} "
                      f"mixed-versions={d['mixed_version_requests']} "
                      f"-> {tag}")
    if args.workload == "reliability":
        h = reliability_headline(rows)
        for backend, d in sorted(h.items()):
            verdict = ("recovers within 2x of fault-free" if d["holds"]
                       else "does NOT hold")
            print(f"\nheadline @ kill{d['kill_every']}: {backend} "
                  f"faulted={d['faulted_updates_per_sec']:.1f} vs "
                  f"nofault={d['nofault_updates_per_sec']:.1f} updates/s "
                  f"({d['ratio_vs_nofault']:.2f}x) kills={d['kills']} "
                  f"recovered={d['recoveries']} "
                  f"(fwd={d['rolled_forward']} back={d['rolled_back']}) "
                  f"violations={d['violations']} -> {verdict}")
    if args.workload == "durability":
        h = durability_headline(rows)
        for backend, d in sorted(h.items()):
            verdict = (">=0.5x of in-memory with a clean restart drill"
                       if d["holds"] else "does NOT hold")
            solo = (f" solo={d['solo_ratio_vs_inmem']:.2f}x"
                    if d.get("solo_ratio_vs_inmem") is not None else "")
            print(f"\nheadline [{d['gated_on']}]: {backend} durable="
                  f"{d['durable_updates_per_sec']:.1f} vs inmem="
                  f"{d['inmem_updates_per_sec']:.1f} updates/s "
                  f"({d['ratio_vs_inmem']:.2f}x{solo}) "
                  f"fsyncs={d['fsyncs']} groups={d['commit_groups']} "
                  f"replayed={d['wal_records_replayed']} "
                  f"violations={d['violations']} -> {verdict}")
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
