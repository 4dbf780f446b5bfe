#!/usr/bin/env python3
"""Compare the two spellings of an STM scalar read of a device word on
one GPU, in paired turns within one process:

  * ``held``: ``kernels/_lib.read_word``, one call that keeps the
    interpreter lock while the word comes home (what the port runs);
  * ``torch``: ``int(row[idx])``, whose index and copy each release it.

    python3 scripts/ab_scalar_read.py [pairs]

The ``torch`` turns put ``int(row[idx])`` in place of ``read_word`` in
``core/engine/arrayheap.py`` and ``api/mvhandle.py`` (every scalar read
of the heap, the lock words and the MVStore block).  Each pair runs both
turns, ``held`` first in even pairs and ``torch`` first in odd ones;
each turn prints one JSON line:

  * ``read_us``: microseconds a read of a 1,048,576-word int64 row
    (3,000 reads, one thread);
  * ``chip_smoke.longread_trial`` (1 scanner, 2 updaters, 4,096 words,
    2 s after 0.5 s of warm-up) on tl2, dctl, tinystm, norec and
    multiverse: scans/s and updates/s;
  * ``chip_smoke.rwmix_trial`` on tl2 (1,024 words, the same window):
    updates/s and checks/s;
  * the quickstart's audit (``repro_torch.examples.quickstart``: two
    transfer threads, five audits alternating scalar and bulk) on tl2,
    tinystm and norec, each audit bounded at 120 attempts: audits
    committed of five, and seconds.

The last line is a summary: per metric, both variants' medians and how
many pairs ``held`` won.  Needs a CUDA card and ``nvcc``; about 50 s a
pair.
"""
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]

SCAN_BACKENDS = ("tl2", "dctl", "tinystm", "norec", "multiverse")
QUICKSTART_BACKENDS = ("tl2", "tinystm", "norec")


def _torch_read(row, idx):
    return int(row[idx])


def _audits(backend, attempts=120):
    """The quickstart's run with each audit bounded at ``attempts``:
    ``(audits committed of 5, seconds)``."""
    from repro_torch.api import MaxRetriesExceeded, make_tm, run
    from repro_torch.configs.paper_stm import MultiverseParams
    from repro_torch.examples import quickstart as Q

    tm = make_tm(backend, n_threads=3,
                 params=MultiverseParams(k1=4, lock_table_bits=10),
                 array_heap=True)
    base = tm.alloc(Q.N_ACCOUNTS, Q.INITIAL)
    transfer = Q.make_transfer(tm, base)
    stop = threading.Event()

    def worker(tid):
        i = 0
        while not stop.is_set():
            src, dst = Q.pair(i)
            if src != dst:
                transfer(src, dst, 5, tid=tid)
            i += 1

    def audit(tx):
        return sum(tx.read(base + i) for i in range(Q.N_ACCOUNTS))

    def audit_bulk(tx):
        return Q.bulk_total(tx.read_bulk(range(base, base + Q.N_ACCOUNTS)))

    ths = [threading.Thread(target=worker, args=(t,)) for t in (0, 1)]
    [t.start() for t in ths]
    done, t0 = 0, time.perf_counter()
    try:
        for trial in range(5):
            try:
                total = run(tm, audit_bulk if trial % 2 else audit, tid=2,
                            max_retries=attempts)
            except MaxRetriesExceeded:
                continue
            assert total == Q.N_ACCOUNTS * Q.INITIAL, "torn read!"
            done += 1
            time.sleep(0.1)
    finally:
        stop.set()
        [t.join() for t in ths]
        tm.stop()
    return done, time.perf_counter() - t0


def turn(variant: str) -> dict:
    import torch

    import chip_smoke as C
    from repro_torch.api import mvhandle
    from repro_torch.core.engine import arrayheap
    from repro_torch.kernels._lib import read_word

    read = read_word if variant == "held" else _torch_read
    arrayheap.read_word = mvhandle.read_word = read
    row = torch.arange(1 << 20, dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for i in range(3000):
        read(row, i)
    out = {"variant": variant,
           "read_us": (time.perf_counter() - t0) / 3000 * 1e6}
    for b in SCAN_BACKENDS:
        r = C.longread_trial(torch, f"ab_{b}", 4096, 12, 2.0, 0.5,
                             backend=b)
        out[f"{b}_scans_per_s"] = r["scans_per_s"]
        out[f"{b}_updates_per_s"] = r["updates_per_s"]
    r = C.rwmix_trial(torch, "ab_rwmix_tl2", 1024, 2.0, 0.5, backend="tl2")
    out["rwmix_tl2_updates_per_s"] = r["updates_per_s"]
    out["rwmix_tl2_checks_per_s"] = r["checks_per_s"]
    for b in QUICKSTART_BACKENDS:
        out[f"quickstart_{b}_audits"], out[f"quickstart_{b}_s"] = \
            _audits(b)
    return out


def main() -> int:
    import numpy as np

    from repro_torch.kernels import _lib

    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    _lib.library()
    rows = []
    for p in range(pairs):
        for variant in (("held", "torch") if p % 2 == 0
                        else ("torch", "held")):
            row = turn(variant)
            row["pair"] = p
            print(json.dumps(row), flush=True)
            rows.append(row)
    summary = {}
    for key in rows[0]:
        if key in ("variant", "pair"):
            continue
        by = {v: [r[key] for r in rows if r["variant"] == v]
              for v in ("held", "torch")}
        lower = key == "read_us" or (key.startswith("quickstart_")
                                     and key.endswith("_s"))
        wins = sum((h < t) if lower else (h > t)
                   for h, t in zip(by["held"], by["torch"]))
        summary[key] = {"held": float(np.median(by["held"])),
                        "torch": float(np.median(by["torch"])),
                        "held_wins": f"{wins}/{len(by['held'])}"}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
