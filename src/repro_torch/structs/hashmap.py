"""Hashmap with chained buckets on the STM word heap (paper Appendix A).

Node layout: [0]=key, [1]=value, [2]=next.  Size queries (SQ) — atomic
count over every bucket — replace range queries for this structure, as in
the paper (no order-preserving hash).

Structures are substrate-agnostic: `tm` is anything with the
`repro_torch.api.Substrate` alloc surface and ops take the uniform `Txn`
handle, so the same structure runs on Multiverse and on every baseline.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.core.engine.traverse import chase_bulk, host_words

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.api.substrate import Substrate, Txn

NULL = 0


class HashMap:
    def __init__(self, tm: "Substrate", n_buckets: int = 1 << 16):
        self.tm = tm
        self.n_buckets = n_buckets
        tm.alloc(1)                      # burn address 0 (NULL)
        self.table = tm.alloc(n_buckets, NULL)

    def _bucket(self, key: int) -> int:
        return self.table + ((key * 0x9E3779B1) % self.n_buckets)

    def search(self, tx: "Txn", key: int) -> Optional[object]:
        node = tx.read(self._bucket(key))
        while node != NULL:
            if tx.read(node) == key:
                return tx.read(node + 1)
            node = tx.read(node + 2)
        return None

    def insert(self, tx: "Txn", key: int, value) -> bool:
        head_addr = self._bucket(key)
        node = tx.read(head_addr)
        while node != NULL:
            if tx.read(node) == key:
                tx.write(node + 1, value)
                return False
            node = tx.read(node + 2)
        new = tx.alloc(3)
        tx.write(new, key)
        tx.write(new + 1, value)
        tx.write(new + 2, tx.read(head_addr))
        tx.write(head_addr, new)
        return True

    def delete(self, tx: "Txn", key: int) -> bool:
        head_addr = self._bucket(key)
        prev = NULL
        node = tx.read(head_addr)
        while node != NULL:
            if tx.read(node) == key:
                nxt = tx.read(node + 2)
                if prev == NULL:
                    tx.write(head_addr, nxt)
                else:
                    tx.write(prev + 2, nxt)
                return True
            prev, node = node, tx.read(node + 2)
        return False

    def upsert_touch(self, tx: "Txn", key: int, value) -> None:
        """Dedicated-updater op: always writes."""
        self.insert(tx, key, value)

    def size_query(self, tx: "Txn") -> int:
        """Atomic size: the long-running read-only transaction (SQ).

        Fully frontier-at-a-time: the contiguous bucket-head array is ONE
        ``read_bulk`` batch, then every overflow chain advances in
        lockstep — round ``r`` gathers the ``r``-th next-pointer of ALL
        live chains in one batch (``engine.traverse.chase_bulk``), so the
        whole sweep costs ``O(max chain length)`` batched reads instead
        of ``O(keys)`` scalar hops.  Advancement is pure numpy; chains
        that end simply drop out of the cursor set.  The bucket heads come
        home in one copy (a head array on the card read word by word
        would cost a copy and a wait per bucket).
        """
        heads = np.asarray(host_words(
            tx.read_bulk(range(self.table, self.table + self.n_buckets))),
            dtype=np.int64)
        total = 0

        def advance(cur, vals):
            nonlocal total
            total += cur.size              # one live node per cursor
            nxt = np.asarray(vals, dtype=np.int64)
            return nxt[nxt != NULL] + 2    # follow the survivors' next ptr

        chase_bulk(tx, heads[heads != NULL] + 2, advance)
        return total
