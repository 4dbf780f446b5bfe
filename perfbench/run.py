#!/usr/bin/env python3
"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` (a
separate run, under the profiler) its per-layer metrics and a breakdown.
The last lines of standard error give each number the check compared
beside its limit; the last line of standard output is the JSON result.
Without a card, with fewer cards than the cell asks for, or with the JAX
stack loaded at the end, the run fails and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.time()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import common  # noqa: E402

os.environ.update(common.cache_env())
sys.path.insert(0, str(common.ROOT / "src"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def context(args, **kw) -> common.Context:
    wl = common.load_json("workloads", args.workload)
    return common.Context(
        cell=args.workload, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), workload=wl,
        config=common.load_json("configs", wl["config"]),
        traffic=common.load_json("traffic", wl["traffic"]),
        t_process=min(common.process_start(), T_START), **kw)


def metrics_of(ctx: common.Context, out: common.Outcome, spec: dict):
    """``(name, unit, value)`` of every metric the cell prints; a
    per-layer reader that finds nothing to read leaves its metric out."""
    rows = []
    for m in common.cell_metrics(spec, ctx.cell, ctx.trace):
        if ctx.trace:
            reader = common.load_module("layer_metrics", m["name"])
            v = reader.read(out, ctx)
            if v is None:
                continue
        else:
            v = out.e2e[m["name"]]
        rows.append((m["name"], m["unit"], float(v)))
    return rows


def main(argv=None) -> int:
    args = parse(argv)
    ctx = context(args)
    import torch
    need = int(ctx.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"error: the cell needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    spec = common.benchmark_spec()
    driver = common.load_module("drivers", ctx.traffic["driver"])
    out = driver.run(ctx)
    rows = metrics_of(ctx, out, spec)
    bad = common.forbidden_modules()
    if bad:
        print(f"error: modules loaded that a run may not hold: {bad}",
              file=sys.stderr)
        return 3
    for note in out.notes:
        print(note, file=sys.stderr)
    print("readings " + json.dumps(
        {k: v for k, v in out.readings.items()
         if isinstance(v, (int, float, str)) or v is None}),
        file=sys.stderr)
    red = out.readings.get("trace")
    if red is not None:
        print(f"trace: {red.lost} launch calls with no device record; "
              f"host labels {red.label_counts}", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(common.result_line(out, rows), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
