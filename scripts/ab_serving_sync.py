#!/usr/bin/env python3
"""Compare the snapshot service's decode-step resolve with ONE sync (its
``ok`` and the torn-read flag come home in one copy: ``StoreExecutor`` as
shipped) against TWO (``ok`` home, then the flag home), on one GPU, in
paired turns (one-sync first in even pairs, two-sync first in odd ones).

    python3 scripts/ab_serving_sync.py [pairs]

Each turn is its own process and runs, on the card, two cells of
``repro_torch.eval``'s ``serving`` workload under the multiverse policy
(Mode U): its qps120 cell as the eval runs it (4 blocks of 64 int32
words, an 8-slot ring, 2.5 s, a commit every 12 ms) and its qps60 cell
over 36 blocks of 1,048,576 words (``chip_smoke.py``'s
``service_36x1M_U``).  It prints one JSON line: per cell, qps, shed, p99
ms and the mean host ms of a decode step.  The last line is a summary:
per metric, both variants' medians and how many pairs the one-sync
variant won.  Needs a CUDA card and ``nvcc``; about 20 s a turn.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: metric -> whether a larger value is better
METRICS = {"qps120_qps": True, "qps120_shed": False, "qps120_p99_ms": False,
           "qps120_decode_ms": False, "36x1M_qps": True, "36x1M_shed": False,
           "36x1M_p99_ms": False, "36x1M_decode_ms": False}


def one(variant: str) -> dict:
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    from repro_torch.eval import WORKLOADS
    from repro_torch.serve import SnapshotService, StoreExecutor
    from repro_torch.serve.scheduler import StepResult
    from repro_torch.serve.service import torn_flag

    class TwoSyncExecutor(StoreExecutor):
        """The decode step with ``ok`` and the torn flag brought home one
        after the other."""

        def decode(self, slots, clocks):
            state = self.state_fn()
            if self.work_s:
                time.sleep(self.work_s)
            resolved = {}
            for rc in set(clocks):
                view, ok, served = self._resolve(state, rc)
                if ok and self.check and bool(torn_flag(view)) \
                        and self.metrics is not None:
                    self.metrics.on_violation()
                resolved[rc] = (ok, served)
            return [StepResult(*resolved[rc]) for rc in clocks]

    work = WORKLOADS["serving"]
    qps60, qps120 = work.variants()
    cells = {"qps120": work.config("multiverse", qps120, 0),
             "36x1M": work.config("multiverse", qps60, 0, n_blocks=36,
                                  block_size=1 << 20, ring_slots=8)}
    out = {"variant": variant}
    for name, cfg in cells.items():
        svc = SnapshotService.synthetic(cfg)
        ex = svc.executor
        if variant == "two":
            ex.__class__ = TwoSyncExecutor
        spent = [0.0, 0]
        decode = ex.decode

        def timed(*a):
            t0 = time.perf_counter()
            try:
                return decode(*a)
            finally:
                spent[0] += time.perf_counter() - t0
                spent[1] += 1

        ex.decode = timed
        row = svc.run_open_loop()
        torch.cuda.synchronize()
        assert row["violations"] == 0 and row["snapshot_aborts"] == 0, row
        out.update({f"{name}_qps": row["qps"], f"{name}_shed": row["shed"],
                    f"{name}_p99_ms": row["p99_ms"],
                    f"{name}_decode_ms": 1e3 * spent[0] / max(spent[1], 1)})
        del svc, ex
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    rows = {"one": [], "two": []}
    for p in range(pairs):
        for variant in (("one", "two") if p % 2 == 0 else ("two", "one")):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn",
                 variant], capture_output=True, text=True, cwd=HERE)
            if res.returncode:
                print(res.stdout + res.stderr, file=sys.stderr)
                return res.returncode
            row = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps(row), flush=True)
            rows[variant].append(row)
    summary = {}
    for m, larger in METRICS.items():
        a = [r[m] for r in rows["one"]]
        b = [r[m] for r in rows["two"]]
        won = sum((x > y) if larger else (x < y) for x, y in zip(a, b))
        summary[m] = {"one_sync_median": statistics.median(a),
                      "two_sync_median": statistics.median(b),
                      "one_sync_won": f"{won}/{pairs}"}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
