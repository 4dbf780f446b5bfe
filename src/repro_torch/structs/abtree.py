"""(a,b)-tree on the STM word heap (the paper's main benchmark, SS5).

Node layout (contiguous words):
  [0] is_leaf, [1] nkeys, [2:2+b] keys,
  leaf:     [2+b : 2+2b]   values
  internal: [2+b : 2+2b+1] children (nkeys+1 used)

Insertion splits full nodes preemptively on the way down (classic B-tree);
deletion is relaxed (keys removed in place, no merging) — a documented
simplification that preserves the workload's read/write shape.  Range
queries DFS the subtree in key order: the long read-only transactions the
paper studies.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple

from repro_torch.core.engine.traverse import traverse_bulk

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.api.substrate import Substrate, Txn

NULL = 0


class ABTree:
    def __init__(self, tm: "Substrate", a: int = 4, b: int = 16):
        self.tm = tm
        self.a, self.b = a, b
        self.node_words = 2 + b + (b + 1)
        tm.alloc(1)                       # burn address 0 (NULL sentinel)
        self.root_ptr = tm.alloc(1, NULL)

    # -- node helpers (operate through a tx) -------------------------------
    def _new_node(self, tx: "Txn", is_leaf: bool) -> int:
        base = tx.alloc(self.node_words, None)
        tx.write(base, 1 if is_leaf else 0)
        tx.write(base + 1, 0)
        return base

    def _keys_off(self, i: int) -> int:
        return 2 + i

    def _vals_off(self, i: int) -> int:
        return 2 + self.b + i

    def _child_off(self, i: int) -> int:
        return 2 + self.b + i

    def _node_keys(self, tx: "Txn", node: int) -> List[int]:
        n = tx.read(node + 1)
        return [tx.read(node + self._keys_off(i)) for i in range(n)]

    # -- operations --------------------------------------------------------
    def search(self, tx: "Txn", key: int) -> Optional[object]:
        node = tx.read(self.root_ptr)
        if node == NULL:
            return None
        while True:
            is_leaf = tx.read(node)
            n = tx.read(node + 1)
            if is_leaf:
                for i in range(n):
                    if tx.read(node + self._keys_off(i)) == key:
                        return tx.read(node + self._vals_off(i))
                return None
            ci = 0
            while ci < n and key >= tx.read(node + self._keys_off(ci)):
                ci += 1
            node = tx.read(node + self._child_off(ci))

    def _split_child(self, tx: "Txn", parent: int, ci: int, child: int) -> None:
        """Split a full child; parent is guaranteed non-full."""
        b = self.b
        is_leaf = tx.read(child)
        mid = b // 2
        right = self._new_node(tx, bool(is_leaf))
        # move upper half keys (and values/children) to `right`
        if is_leaf:
            sep = tx.read(child + self._keys_off(mid))
            rn = b - mid
            for i in range(rn):
                tx.write(right + self._keys_off(i),
                         tx.read(child + self._keys_off(mid + i)))
                tx.write(right + self._vals_off(i),
                         tx.read(child + self._vals_off(mid + i)))
            tx.write(right + 1, rn)
            tx.write(child + 1, mid)
        else:
            sep = tx.read(child + self._keys_off(mid))
            rn = b - mid - 1
            for i in range(rn):
                tx.write(right + self._keys_off(i),
                         tx.read(child + self._keys_off(mid + 1 + i)))
            for i in range(rn + 1):
                tx.write(right + self._child_off(i),
                         tx.read(child + self._child_off(mid + 1 + i)))
            tx.write(right + 1, rn)
            tx.write(child + 1, mid)
        # shift parent entries right of ci
        pn = tx.read(parent + 1)
        for i in range(pn - 1, ci - 1, -1):
            tx.write(parent + self._keys_off(i + 1),
                     tx.read(parent + self._keys_off(i)))
        for i in range(pn, ci, -1):
            tx.write(parent + self._child_off(i + 1),
                     tx.read(parent + self._child_off(i)))
        tx.write(parent + self._keys_off(ci), sep)
        tx.write(parent + self._child_off(ci + 1), right)
        tx.write(parent + 1, pn + 1)

    def insert(self, tx: "Txn", key: int, value) -> bool:
        """Returns True if inserted, False if key existed (value updated)."""
        b = self.b
        root = tx.read(self.root_ptr)
        if root == NULL:
            leaf = self._new_node(tx, True)
            tx.write(leaf + self._keys_off(0), key)
            tx.write(leaf + self._vals_off(0), value)
            tx.write(leaf + 1, 1)
            tx.write(self.root_ptr, leaf)
            return True
        if tx.read(root + 1) == b:               # split full root
            new_root = self._new_node(tx, False)
            tx.write(new_root + self._child_off(0), root)
            self._split_child(tx, new_root, 0, root)
            tx.write(self.root_ptr, new_root)
            root = new_root
        node = root
        while True:
            n = tx.read(node + 1)
            if tx.read(node):                     # leaf
                pos = 0
                while pos < n and tx.read(node + self._keys_off(pos)) < key:
                    pos += 1
                if pos < n and tx.read(node + self._keys_off(pos)) == key:
                    tx.write(node + self._vals_off(pos), value)
                    return False
                for i in range(n - 1, pos - 1, -1):
                    tx.write(node + self._keys_off(i + 1),
                             tx.read(node + self._keys_off(i)))
                    tx.write(node + self._vals_off(i + 1),
                             tx.read(node + self._vals_off(i)))
                tx.write(node + self._keys_off(pos), key)
                tx.write(node + self._vals_off(pos), value)
                tx.write(node + 1, n + 1)
                return True
            ci = 0
            while ci < n and key >= tx.read(node + self._keys_off(ci)):
                ci += 1
            child = tx.read(node + self._child_off(ci))
            if tx.read(child + 1) == b:
                self._split_child(tx, node, ci, child)
                if key >= tx.read(node + self._keys_off(ci)):
                    child = tx.read(node + self._child_off(ci + 1))
            node = child

    def delete(self, tx: "Txn", key: int) -> bool:
        """Relaxed delete: remove from leaf, no rebalancing."""
        node = tx.read(self.root_ptr)
        if node == NULL:
            return False
        while True:
            n = tx.read(node + 1)
            if tx.read(node):
                for i in range(n):
                    if tx.read(node + self._keys_off(i)) == key:
                        for j in range(i, n - 1):
                            tx.write(node + self._keys_off(j),
                                     tx.read(node + self._keys_off(j + 1)))
                            tx.write(node + self._vals_off(j),
                                     tx.read(node + self._vals_off(j + 1)))
                        tx.write(node + 1, n - 1)
                        return True
                return False
            ci = 0
            while ci < n and key >= tx.read(node + self._keys_off(ci)):
                ci += 1
            node = tx.read(node + self._child_off(ci))

    def upsert_touch(self, tx: "Txn", key: int, value) -> None:
        """Dedicated-updater op: ALWAYS writes (never read-only, SS5)."""
        if not self.insert(tx, key, value):
            pass                                   # insert wrote the value

    def range_query(self, tx: "Txn", lo: int, count: int) -> List[Tuple[int,
                                                                 object]]:
        """Collect up to `count` pairs with key >= lo (in key order).

        Frontier-at-a-time (``engine.traverse.traverse_bulk``): per
        round, ONE ``read_bulk`` batch gathers the contiguous words of
        EVERY pending node (header + keys + values/children — unused
        slots ride along, a slightly wider conflict surface paid for the
        vectorized long read), and nodes expand in place into in-order
        children / leaf emissions, so a query costs one batch per tree
        LEVEL instead of one per node.
        """
        root = tx.read(self.root_ptr)
        if root == NULL:
            return []

        def expand(state, words, emit, push):
            n = int(words[1])
            if int(words[0]):                 # leaf
                for i in range(n):
                    k = int(words[self._keys_off(i)])
                    if k >= lo:
                        emit((k, words[self._vals_off(i)]))
            else:
                for ci in range(n + 1):
                    # child ci holds keys < keys[ci]: skip if all < lo
                    if ci < n and int(words[self._keys_off(ci)]) <= lo:
                        continue
                    child = int(words[self._child_off(ci)])
                    if child != NULL:
                        push(child, self.node_words)

        return traverse_bulk(tx, [(root, self.node_words)], expand,
                             limit=count)
