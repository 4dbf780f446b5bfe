"""External (leaf-oriented) BST on the STM word heap (paper Appendix A).

Node layout: [0]=is_leaf, [1]=key, [2]=left, [3]=right, [4]=value.
Internal nodes route (keys < k go left); leaves hold the actual pairs.
Delete unlinks the leaf and replaces its parent with the sibling.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple

from repro_torch.core.engine.traverse import traverse_bulk

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.api.substrate import Substrate, Txn

NULL = 0


class ExternalBST:
    NODE = 5

    def __init__(self, tm: "Substrate"):
        self.tm = tm
        tm.alloc(1)
        self.root_ptr = tm.alloc(1, NULL)

    def _leaf(self, tx: "Txn", key, value) -> int:
        n = tx.alloc(self.NODE)
        tx.write(n, 1)
        tx.write(n + 1, key)
        tx.write(n + 2, NULL)
        tx.write(n + 3, NULL)
        tx.write(n + 4, value)
        return n

    def _internal(self, tx: "Txn", key, left, right) -> int:
        n = tx.alloc(self.NODE)
        tx.write(n, 0)
        tx.write(n + 1, key)
        tx.write(n + 2, left)
        tx.write(n + 3, right)
        # routing nodes carry no value; NULL (not None) keeps the node
        # representable on numeric heaps (ArrayHeap / MVStore blocks)
        tx.write(n + 4, NULL)
        return n

    def search(self, tx: "Txn", key: int) -> Optional[object]:
        node = tx.read(self.root_ptr)
        if node == NULL:
            return None
        while not tx.read(node):
            node = tx.read(node + 2) if key < tx.read(node + 1) \
                else tx.read(node + 3)
        if tx.read(node + 1) == key:
            return tx.read(node + 4)
        return None

    def insert(self, tx: "Txn", key: int, value) -> bool:
        node = tx.read(self.root_ptr)
        if node == NULL:
            tx.write(self.root_ptr, self._leaf(tx, key, value))
            return True
        parent, went_left = NULL, False
        while not tx.read(node):
            parent = node
            went_left = key < tx.read(node + 1)
            node = tx.read(node + 2) if went_left else tx.read(node + 3)
        lk = tx.read(node + 1)
        if lk == key:
            tx.write(node + 4, value)
            return False
        new_leaf = self._leaf(tx, key, value)
        if key < lk:
            inner = self._internal(tx, lk, new_leaf, node)
        else:
            inner = self._internal(tx, key, node, new_leaf)
        if parent == NULL:
            tx.write(self.root_ptr, inner)
        else:
            tx.write(parent + (2 if went_left else 3), inner)
        return True

    def delete(self, tx: "Txn", key: int) -> bool:
        node = tx.read(self.root_ptr)
        if node == NULL:
            return False
        parent, grand, p_left, g_left = NULL, NULL, False, False
        while not tx.read(node):
            grand, g_left = parent, p_left
            parent = node
            p_left = key < tx.read(node + 1)
            node = tx.read(node + 2) if p_left else tx.read(node + 3)
        if tx.read(node + 1) != key:
            return False
        if parent == NULL:
            tx.write(self.root_ptr, NULL)
            return True
        sibling = tx.read(parent + (3 if p_left else 2))
        if grand == NULL:
            tx.write(self.root_ptr, sibling)
        else:
            tx.write(grand + (2 if g_left else 3), sibling)
        return True

    def upsert_touch(self, tx: "Txn", key: int, value) -> None:
        self.insert(tx, key, value)

    def range_query(self, tx: "Txn", lo: int, count: int) -> List[Tuple[int,
                                                                 object]]:
        """Collect up to `count` pairs with key >= lo (in key order).

        Frontier-at-a-time: the recursive DFS is an explicit ordered
        worklist (``engine.traverse.traverse_bulk``) — per round, ONE
        ``read_bulk`` batch gathers every pending node's 5 words, and
        each node expands in place into its in-order children / leaf
        emission.  Emission order and the ``count`` cutoff match the
        scalar DFS exactly, and tree depth costs worklist length, not
        Python stack — a degenerate (sorted-insert) tree deeper than
        ``sys.getrecursionlimit()`` traverses fine.
        """
        root = tx.read(self.root_ptr)
        if root == NULL:
            return []

        def expand(state, w, emit, push):
            if w[0]:                          # leaf
                k = w[1]
                if k >= lo:
                    emit((k, w[4]))
            else:                             # internal: keys < w[1] left
                if lo < w[1]:
                    push(w[2], self.NODE)
                push(w[3], self.NODE)

        return traverse_bulk(tx, [(root, self.NODE)], expand, limit=count)
