"""The port's frontier-at-a-time traversal against the JAX package's.

* The assertions of ``tests/test_traverse.py`` (DFS order and ``limit``,
  chase round counts, an extbst deeper than the recursion limit,
  read-set dedup across rounds, batched against scalar walks on all six
  backends) hold on ``repro_torch`` on the CPU.
* The same seeded key sets through ``repro`` and ``repro_torch``: equal
  range-query and size-query outputs, equal emission order and equal
  ``read_bulk`` round counts, on multiverse, tl2, dctl, norec, tinystm
  and mvstore.
* Callbacks see host words: an ndarray slice on a clean batch (the
  device tensor comes home once a round), a list slice when the batch
  re-read some element through the scalar protocol.
"""
import random
import sys

import numpy as np
import pytest

import repro.api as J
from repro.configs.paper_stm import MultiverseParams as JParams
from repro.structs import STRUCTS as JSTRUCTS
from repro_torch import api as T
from repro_torch.configs.paper_stm import MultiverseParams as TParams
from repro_torch.core.engine.traverse import (
    chase_bulk,
    host_words,
    traverse_bulk,
)
from repro_torch.structs import STRUCTS as TSTRUCTS
from repro_torch.structs import ExternalBST, HashMap

WORD_BACKENDS = ["multiverse", "tl2", "dctl", "norec", "tinystm"]
ALL_BACKENDS = WORD_BACKENDS + ["mvstore"]


def _port_tm(backend, n_threads=2, **kw):
    """The port's counterpart of ``tests/_backends.make_test_tm``."""
    params = TParams(k1=2, k2=50, k3=50, lock_table_bits=8)
    if backend == "mvstore":
        kw.setdefault("ring_slots", 16)
        kw.setdefault("start_bg", False)
    return T.make_tm(backend, n_threads, params=params, device="cpu", **kw)


def _pair(backend):
    """The same backend in both packages, numeric heaps (the int64 array
    heap for the word backends, the MVStore's int32 block)."""
    kw = {} if backend == "mvstore" else {"array_heap": True}
    if backend in ("multiverse", "mvstore"):
        kw["start_bg"] = False
    jtm = J.make_tm(backend, 1, params=JParams(k1=2, k2=50, k3=50,
                                               lock_table_bits=8), **kw)
    ttm = T.make_tm(backend, 1, params=TParams(k1=2, k2=50, k3=50,
                                               lock_table_bits=8),
                    device="cpu", **kw)
    return jtm, ttm


class _Counting:
    """A transaction handle that counts the ``read_bulk`` calls (the
    traversal's rounds) and scalar reads made through it."""

    def __init__(self, tx):
        self._tx = tx
        self._ctx = tx._ctx
        self.rounds = 0
        self.reads = 0

    def read(self, addr):
        self.reads += 1
        return self._tx.read(addr)

    def read_bulk(self, addrs):
        self.rounds += 1
        return self._tx.read_bulk(addrs)


# ---------------------------------------------------------------------------
# tests/test_traverse.py's unit cases, on the port
# ---------------------------------------------------------------------------


def _binary_tree(tm):
    tm.alloc(1)                              # burn address 0 (NULL)

    # node layout: [0]=value, [1]=left, [2]=right (0 = null)
    def node(v, l=0, r=0):
        base = tm.alloc(3, 0)
        tm.run(lambda tx: (tx.write(base, v), tx.write(base + 1, l),
                           tx.write(base + 2, r)))
        return base
    #        4
    #      2   6
    #     1 3 5 7
    n1, n3, n5, n7 = node(1), node(3), node(5), node(7)
    n2, n6 = node(2, n1, n3), node(6, n5, n7)
    return node(4, n2, n6)


def _inorder(state, w, emit, push):
    if int(w[1]):
        push(w[1], 3, state + 1)
    emit((int(w[0]), state))
    if int(w[2]):
        push(w[2], 3, state + 1)


@pytest.mark.parametrize("array_heap", [False, True], ids=["object", "array"])
def test_traverse_bulk_preserves_dfs_order_and_limit(array_heap):
    """A hand-built binary tree: emission must be exactly the in-order
    walk, and ``limit`` must truncate it mid-traversal."""
    tm = _port_tm("tl2", n_threads=1, array_heap=array_heap)
    n4 = _binary_tree(tm)
    out = T.run(tm, lambda tx: traverse_bulk(tx, [(n4, 3, 0)], _inorder))
    assert [v for v, _ in out] == [1, 2, 3, 4, 5, 6, 7]
    assert [d for _, d in out] == [2, 1, 2, 0, 2, 1, 2]   # depth state
    out = T.run(tm, lambda tx: traverse_bulk(tx, [(n4, 3, 0)], _inorder,
                                             limit=4))
    assert [v for v, _ in out] == [1, 2, 3, 4]
    # the handle's method is the same traversal
    assert T.run(tm, lambda tx: tx.traverse_bulk([(n4, 3, 0)], _inorder,
                                                 limit=4)) == out
    assert T.run(tm, lambda tx: tx.traverse_bulk([], _inorder)) == []
    tm.stop()


@pytest.mark.parametrize("array_heap", [False, True], ids=["object", "array"])
def test_chase_bulk_counts_rounds(array_heap):
    tm = _port_tm("tl2", n_threads=1, array_heap=array_heap)
    tm.alloc(1)                              # burn address 0 (NULL)

    # three chains of length 1, 3, 5 — cells: [0]=next
    def chain(n):
        addrs = [tm.alloc(1, 0) for _ in range(n)]
        for a, b in zip(addrs, addrs[1:]):
            tm.run(lambda tx, a=a, b=b: tx.write(a, b))
        return addrs[0]
    heads = [chain(1), chain(3), chain(5)]
    seen = []

    def advance(cur, vals):
        seen.append(cur.size)
        if array_heap:                       # a clean batch: host int64
            assert isinstance(vals, np.ndarray) and vals.dtype == np.int64
        nxt = np.asarray(vals, np.int64)
        return nxt[nxt != 0]

    rounds = T.run(tm, lambda tx: chase_bulk(tx, heads, advance))
    assert rounds == 5                       # longest chain
    assert seen == [3, 2, 2, 1, 1]           # lockstep attrition
    seen.clear()
    assert T.run(tm, lambda tx: tx.chase_bulk(heads, advance)) == 5
    tm.stop()


def test_extbst_range_query_survives_depth_past_recursion_limit():
    """Sorted inserts build a degenerate (linked-list) BST; the iterative
    frontier walk must traverse deeper than the Python recursion limit
    allows."""
    tm = _port_tm("tl2", n_threads=1, array_heap=True)
    s = ExternalBST(tm)
    n = 300
    for k in range(n):
        T.run(tm, lambda tx, k=k: s.insert(tx, k, -k), tid=0)

    def stack_depth():
        f, d = sys._getframe(), 0
        while f:
            d += 1
            f = f.f_back
        return d

    old = sys.getrecursionlimit()
    # leave ~150 frames of headroom — far less than the tree's ~300
    # levels, so a recursive walk would blow the stack here
    sys.setrecursionlimit(stack_depth() + 150)
    try:
        out = T.run(tm, lambda tx: s.range_query(tx, 0, n), tid=0)
    finally:
        sys.setrecursionlimit(old)
    assert [int(k) for k, _ in out] == list(range(n))
    assert [int(v) for _, v in out] == [-k for k in range(n)]
    tm.stop()


@pytest.mark.parametrize("array_heap", [False, True], ids=["object", "array"])
def test_traversal_readset_dedup_across_rounds(array_heap):
    """Repeated frontier visits must not inflate the read set, while a
    plain read_bulk outside the traversal keeps appending (flag
    restored)."""
    tm = _port_tm("tl2", n_threads=1, array_heap=array_heap)
    tm.alloc(1)                              # burn address 0 (NULL)
    addrs = [tm.alloc(1, 0) for _ in range(5)]
    for a, b in zip(addrs, addrs[1:]):
        T.run(tm, lambda tx, a=a, b=b: tx.write(a, b))
    head = addrs[0]

    def advance(cur, vals):
        nxt = np.asarray(vals, np.int64)
        return nxt[nxt != 0]

    def body(tx):
        d = tx._ctx
        chase_bulk(tx, [head], advance)
        n1 = len(d.read_set)
        assert n1 > 0
        chase_bulk(tx, [head], advance)      # SAME chain again
        assert len(d.read_set) == n1         # deduped across rounds
        out = traverse_bulk(
            tx, [(head, 1)],
            lambda s, w, emit, push: (emit(int(w[0])),
                                      push(int(w[0]), 1)
                                      if int(w[0]) else None))
        assert len(out) == 5
        assert len(d.read_set) == n1
        assert not d.dedup_read_set          # flag restored on exit
        tx.read_bulk([head])                 # plain batch: appends again
        assert len(d.read_set) == n1 + 1
    T.run(tm, body)
    tm.stop()


# ---------------------------------------------------------------------------
# batched == scalar walk, all six backends (tests/test_traverse.py:200-245)
# ---------------------------------------------------------------------------


def _scalar_bst_range(s, tx, lo, count):
    """The recursive scalar DFS, as the parity oracle."""
    out = []
    root = tx.read(s.root_ptr)
    if root == 0:
        return out

    def dfs(node):
        if tx.read(node):
            k = tx.read(node + 1)
            if k >= lo:
                out.append((int(k), int(tx.read(node + 4))))
                if len(out) >= count:
                    return True
            return False
        if lo < tx.read(node + 1):
            if dfs(tx.read(node + 2)):
                return True
        return dfs(tx.read(node + 3))

    dfs(root)
    return out


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_extbst_range_query_batch_matches_scalar(backend):
    tm = _port_tm(backend, n_threads=1)
    s = ExternalBST(tm)
    keys = random.Random(5).sample(range(5000), 140)
    for k in keys:
        T.run(tm, lambda tx, k=k: s.insert(tx, k, k * 2), tid=0)
    for lo, count in ((0, 1000), (2500, 40), (4999, 5), (6000, 10)):
        batch = T.run(tm, lambda tx: s.range_query(tx, lo, count), tid=0)
        scalar = T.run(tm, lambda tx: _scalar_bst_range(s, tx, lo, count),
                       tid=0)
        assert [(int(k), int(v)) for k, v in batch] == scalar
    tm.stop()


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_hashmap_size_query_batch_matches_scalar(backend):
    """16 buckets x 120 keys: every bucket chains several nodes deep, so
    the lockstep chain chase is exercised on every backend."""
    tm = _port_tm(backend, n_threads=1)
    h = HashMap(tm, n_buckets=16)
    keys = random.Random(9).sample(range(10000), 120)
    for k in keys:
        T.run(tm, lambda tx, k=k: h.insert(tx, k, k), tid=0)

    def scalar_size(tx):
        total = 0
        for b in range(h.n_buckets):
            node = int(tx.read(h.table + b))
            while node:
                total += 1
                node = int(tx.read(node + 2))
        return total

    assert T.run(tm, h.size_query, tid=0) == \
        T.run(tm, scalar_size, tid=0) == len(keys)
    for k in keys[::3]:
        T.run(tm, lambda tx, k=k: h.delete(tx, k), tid=0)
    assert T.run(tm, h.size_query, tid=0) == \
        T.run(tm, scalar_size, tid=0) == len(keys) - len(keys[::3])
    tm.stop()


# ---------------------------------------------------------------------------
# the same seeded key sets through both packages
# ---------------------------------------------------------------------------


def _queries(kind):
    if kind == "hashmap":
        return [("size", None, None)]
    return [("range", 0, 10_000), ("range", 1500, 60), ("range", 3999, 7),
            ("range", 9000, 5)]


@pytest.mark.parametrize("kind", ["hashmap", "extbst", "abtree"])
@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_queries_match_reference(backend, kind):
    """Equal outputs, equal emission order and equal ``read_bulk`` round
    counts for the same seeded key set (inserts 25 to a transaction, then
    deletes in one; the reference's MVStore compiles a commit for every
    new write-set shape and grows its block at every node allocation, so
    it takes few transactions and a smaller key set)."""
    n_keys = 40 if backend == "mvstore" else 150
    results = []
    for pkg, structs, tm in zip((J, T), (JSTRUCTS, TSTRUCTS),
                                _pair(backend)):
        cls = structs[kind]
        s = cls(tm, n_buckets=32) if kind == "hashmap" else cls(tm)
        keys = random.Random(17).sample(range(4000), n_keys)
        for i in range(0, len(keys), 25):
            pkg.run(tm, lambda tx, ks=keys[i:i + 25]: [
                s.insert(tx, k, 3 * k + 1) for k in ks], tid=0)
        pkg.run(tm, lambda tx: [s.delete(tx, k) for k in keys[::4]], tid=0)
        got = []
        for q, lo, count in _queries(kind):
            def body(tx, lo=lo, count=count):
                c = _Counting(tx)
                if q == "size":
                    out = s.size_query(c)
                else:
                    out = [(int(k), int(v))
                           for k, v in s.range_query(c, lo, count)]
                return out, c.rounds, c.reads
            got.append(pkg.run(tm, body, tid=0))
        results.append(got)
        tm.stop()
    assert results[1] == results[0]
    assert all(rounds > 1 for _, rounds, _ in results[1])


@pytest.mark.parametrize("backend", ["tl2", "mvstore"])
def test_callbacks_see_list_slices_after_a_scalar_reread(backend):
    """A buffered write in the same transaction makes ``read_bulk`` return
    a list (TL2's read-own-writes batch, the MVStore's overlay): the
    traversal hands list slices to ``expand`` and the walk sees its own
    write.  A clean batch hands ndarray slices."""
    tm = _port_tm(backend, n_threads=1, **({} if backend == "mvstore"
                                          else {"array_heap": True}))
    n4 = _binary_tree(tm)
    kinds = []

    def expand(state, w, emit, push):
        kinds.append(type(w))
        _inorder(state, w, emit, push)

    out = T.run(tm, lambda tx: traverse_bulk(tx, [(n4, 3, 0)], expand))
    assert [v for v, _ in out] == [1, 2, 3, 4, 5, 6, 7]
    assert set(kinds) == {np.ndarray}
    kinds.clear()

    def body(tx):
        tx.write(n4, 40)                     # the root's value, buffered
        return traverse_bulk(tx, [(n4, 3, 0)], expand)

    out = T.run(tm, body)
    assert [v for v, _ in out] == [1, 2, 3, 40, 5, 6, 7]
    assert list in set(kinds)
    tm.stop()


def test_host_words_brings_a_tensor_home_once():
    import torch

    t = torch.arange(5, dtype=torch.int64)
    w = host_words(t)
    assert isinstance(w, np.ndarray) and w.tolist() == [0, 1, 2, 3, 4]
    assert host_words(t.to(torch.int32)).dtype == np.int32
    lst = [1, 2]
    assert host_words(lst) is lst
