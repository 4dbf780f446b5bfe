#!/usr/bin/env python3
"""Compare another tree of this repository with this one on one GPU, in
paired turns (other first in even pairs, this tree first in odd ones).

    git archive <commit> | tar -x -C build/parent
    python3 scripts/ab_turns.py build/parent [pairs]

Each turn is its own process with that tree's ``chip_smoke.py`` and
``src`` on the path (each tree builds its kernels into its own
``build/kernels``), and prints one JSON line:

  * ``scatter_write_dev`` (both columns on the card) at N = 1024 and
    1,000,000 unique random indices into a 1,000,000-word int64 row:
    wall ms per call (CUDA events over 200 calls) and the kernel's device
    ms per call (``torch.profiler`` over 50 calls);
  * the tree's ``longread_trial`` on multiverse: ``longread_scan4096``
    (6 s window after 1 s of warm-up: scans/s, updates/s) and
    ``longread_scan1M`` (until its first scan: seconds to it);
  * its ``rwmix_trial`` on multiverse, ``rwmix_w1024`` (6 s window after
    1 s of warm-up: updates/s, checks/s).

The last line is a summary: per metric, both trees' medians and
quartiles, and how many pairs this tree won.  Needs a CUDA card and
``nvcc``; about 35-55 s a turn.
"""
import json
import os
import subprocess
import sys

#: metric -> whether a larger value is better
METRICS = {"scatter_1024_device_ms": False, "scatter_1M_device_ms": False,
           "scatter_1024_ms": False, "scatter_1M_ms": False,
           "scan4096_scans_per_s": True, "scan4096_updates_per_s": True,
           "scan1M_first_scan_s": False, "rwmix_updates_per_s": True,
           "rwmix_checks_per_s": True}


def one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import chip_smoke as C
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _lib
    from repro_torch.kernels import scatter_write as SW

    _lib.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    h = 1_000_000
    row = _lib.to_device(rng.integers(-(1 << 62), 1 << 62, h), dev)
    out = {"tree": tree}
    for n, tag in ((1024, "1024"), (h, "1M")):
        idx = _lib.to_device(rng.permutation(h)[:n].astype(np.int64), dev)
        val = _lib.to_device(rng.integers(-(1 << 62), 1 << 62, n), dev)

        def fn():
            SW.scatter_write_dev(row, idx, val)
        out[f"scatter_{tag}_ms"] = C.time_ms(torch, fn)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
        out[f"scatter_{tag}_device_ms"] = sum(
            k.self_device_time_total for k in prof.key_averages()
            if "scatter" in k.key) / 50 / 1e3
    r = C.longread_trial(torch, "longread_scan4096", 4096, 12, 6.0, 1.0)
    out["scan4096_scans_per_s"] = r["scans_per_s"]
    out["scan4096_updates_per_s"] = r["updates_per_s"]
    r = C.longread_trial(torch, "longread_scan1M", 1_000_000, 16, 60.0, 0.0,
                         min_scans=1)
    out["scan1M_first_scan_s"] = r["first_scan_s"]
    r = C.rwmix_trial(torch, "rwmix_w1024", 1024, 6.0, 1.0)
    out["rwmix_updates_per_s"] = r["updates_per_s"]
    out["rwmix_checks_per_s"] = r["checks_per_s"]
    return out


def summary(turns: list, other: str, here: str) -> dict:
    import numpy as np

    out = {}
    pairs = [(turns[i], turns[i + 1]) for i in range(0, len(turns), 2)]
    for m, larger in METRICS.items():
        vals = {}
        for tree in (other, here):
            v = [t[m] for t in turns if t["tree"] == tree
                 and t[m] is not None]
            vals[tree] = v
        wins = 0
        for a, b in pairs:
            mine, theirs = (a, b) if a["tree"] == here else (b, a)
            if mine[m] is not None and theirs[m] is not None and \
                    mine[m] != theirs[m]:
                wins += (mine[m] > theirs[m]) == larger
        out[m] = {k: {"median": float(np.median(v)),
                      "q1": float(np.percentile(v, 25)),
                      "q3": float(np.percentile(v, 75))} if v else None
                  for k, v in (("other", vals[other]), ("this", vals[here]))}
        out[m]["this_wins"] = f"{wins}/{len(pairs)}"
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pairs = int(sys.argv[2]) if len(sys.argv) == 3 else 10
    turns = []
    for p in range(pairs):
        for tree in ((other, here) if p % 2 == 0 else (here, other)):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree],
                check=True, stdout=subprocess.PIPE, text=True)
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            turns.append(json.loads(line))
    print(json.dumps({"summary": summary(turns, other, here)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
