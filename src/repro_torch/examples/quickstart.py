"""Quickstart: the unified transactional API in 60 lines.

Two threads move money between accounts while a third takes consistent
snapshots of all balances — the paper's long-running read.  The SAME code
runs on any backend: pass `--backend tl2` (or dctl/norec/tinystm) to watch
an unversioned TM handle the audit, or `--backend mvstore` (or
`shardstore`) to run it on the Layer-B parameter store.  The heap and its
lock words live on the card (``array_heap=True``; the MVStore's block is
always there).  Run:

    python -m repro_torch.examples.quickstart [--backend multiverse]
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

An audit retries until it commits, as in the reference.  A scalar read
of a word on the card keeps the interpreter lock while it waits for the
word (``kernels/_lib.read_word``), as a read of the reference's host
heap does, so the transfer threads cannot commit between two of an
audit's reads.
"""
import argparse
import threading
import time

import torch

from repro_torch.api import atomic, make_tm, run
from repro_torch.configs.paper_stm import MultiverseParams
from repro_torch.core.engine import resolve_device

N_ACCOUNTS = 200
INITIAL = 100


def make_transfer(tm, base):
    """The transfer transaction: move ``amt`` from account ``src`` to
    ``dst`` (``transfer(src, dst, amt, tid=...)``)."""
    @atomic(tm)
    def transfer(tx, src, dst, amt):
        a = tx.read(base + src)
        b = tx.read(base + dst)
        tx.write(base + src, a - amt)
        tx.write(base + dst, b + amt)
    return transfer


def pair(i: int):
    """The ``i``-th transfer's (source, destination) accounts."""
    return i % N_ACCOUNTS, (i * 13 + 7) % N_ACCOUNTS


def bulk_total(vals) -> int:
    """The sum of a ``read_bulk`` result as one host integer: a tensor
    is reduced where it lives and one scalar comes home (iterating it
    would copy element by element); a host list is summed as is."""
    if isinstance(vals, torch.Tensor):
        return int(vals.sum(dtype=torch.int64))
    return int(sum(vals))


def main(argv=None):
    """Runs the example; returns the audits' totals and the TM's
    stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="multiverse")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    tm = make_tm(args.backend, n_threads=3,
                 params=MultiverseParams(k1=4, lock_table_bits=10),
                 array_heap=True, device=resolve_device(args.device))
    base = tm.alloc(N_ACCOUNTS, INITIAL)
    stop = threading.Event()
    transfer = make_transfer(tm, base)

    def transfer_worker(tid):
        i = 0
        while not stop.is_set():
            src, dst = pair(i)
            if src != dst:
                transfer(src, dst, 5, tid=tid)
            i += 1

    workers = [threading.Thread(target=transfer_worker, args=(t,))
               for t in (0, 1)]
    [w.start() for w in workers]

    # long-running reads: sum every balance, atomically, while transfers
    # fly — alternating the word-at-a-time spelling with the batched one
    # (read_bulk snapshots the whole range in one gather)
    def audit(tx):
        return sum(tx.read(base + i) for i in range(N_ACCOUNTS))

    def audit_bulk(tx):
        return bulk_total(tx.read_bulk(range(base, base + N_ACCOUNTS)))

    totals = []
    try:
        for trial in range(5):
            total = run(tm, audit_bulk if trial % 2 else audit, tid=2)
            assert total == N_ACCOUNTS * INITIAL, "torn read!"
            totals.append(total)
            print(f"audit {trial}: total={total} (consistent) "
                  f"mode={tm.stats()['mode']}")
            time.sleep(0.1)
    finally:
        stop.set()
        [w.join() for w in workers]
    s = tm.stats()
    print(f"backend={s['backend']} commits={s['commits']} "
          f"aborts={s['aborts']} versioned_commits={s['versioned_commits']} "
          f"mode_transitions={s['mode_transitions']}")
    tm.stop()
    return {"totals": totals, "stats": s}


if __name__ == "__main__":
    main()
