#!/usr/bin/env python3
"""Read the numbers the limits of ``correct`` are set from: a cell run on
several seeds in one process (one start and one build), each run also
reading the control (the reference in float8 e4m3 in the program's
place, judged as ``correct`` judges the program: ``control_correct``)
and, for a training cell, two faults: the reference trained on half of
each batch, and each checked version read from the ring's slot of the
version before it.  Not part of a benchmark run.

    python3 perfbench/calibrate.py --workload <cell> --seed <first> \
        --runs <n> --seconds <s>

One JSON line a seed: the checks as the run compared them, the control's
and the fault's readings, and the end-to-end figures.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench  # noqa: E402

from perfbench.harness import common, model  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    for i in range(args.runs):
        # each seed's program runs as in a process of its own, before the
        # reference turned TF32 off
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        a = argparse.Namespace(workload=args.workload, seed=args.seed + i,
                               seconds=args.seconds, trace=0)
        ctx = bench.context(a, calibrate=True)
        driver = common.load_module("drivers", ctx.traffic["driver"])
        out = driver.run(ctx)
        keep = {k: v for k, v in out.readings.items()
                if isinstance(v, (int, float, dict)) or v is None}
        print(json.dumps({"seed": a.seed, "correct": out.correct,
                          "control_correct": out.control_correct,
                          "checks": {c.name: c.value for c in out.checks},
                          "readings": keep, "e2e": out.e2e,
                          "peak": out.memory_peak}), flush=True)
        del out
        model.free()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
