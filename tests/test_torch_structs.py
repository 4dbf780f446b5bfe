"""The port's transactional data structures against a dict and against the
JAX package's.

* ``tests/test_structs.py``'s dict equivalence on ``repro_torch``, every
  backend (the five word TMs on the int64 array heap and on the object
  heap, and the MVStore) and every structure.
* The same seeded op stream through ``repro`` and ``repro_torch``: equal
  answers op by op, and bit-identical heaps (blocks), lock words, clocks
  and, on multiverse, PackedVLT mirrors at the end — which pins the
  allocation order of every insert.
* Ordered range queries, an atomic size query beside a churning writer,
  and a deep (a,b)-tree, as in ``tests/test_structs.py``.
"""
import random
import threading

import numpy as np
import pytest

import repro.api as J
from repro.configs.paper_stm import MultiverseParams as JParams
from repro.structs import STRUCTS as JSTRUCTS
from repro_torch import api as T
from repro_torch.configs.paper_stm import MultiverseParams as TParams
from repro_torch.structs import STRUCTS, ABTree, ExternalBST, HashMap

WORD_BACKENDS = ["multiverse", "tl2", "dctl", "norec", "tinystm"]
ALL_BACKENDS = WORD_BACKENDS + ["mvstore"]
KINDS = ["abtree", "hashmap", "extbst"]


def _build(structs, kind, tm):
    cls = structs[kind]
    return cls(tm, 64) if kind == "hashmap" else cls(tm)


def _make(pkg, backend, array_heap=True):
    kw = {} if backend == "mvstore" else {"array_heap": array_heap}
    if backend in ("multiverse", "mvstore"):
        kw["start_bg"] = False
    if pkg is J:
        return J.make_tm(backend, 2, params=JParams(lock_table_bits=10),
                         **kw)
    return T.make_tm(backend, 2, params=TParams(lock_table_bits=10),
                     device="cpu", **kw)


def _ops(seed, n):
    rnd = random.Random(seed)
    out = []
    for _ in range(n):
        op = rnd.random()
        k = rnd.randrange(200)
        out.append(("insert" if op < 0.5 else "delete" if op < 0.75
                    else "search", k))
    return out


def test_registry_names():
    assert set(STRUCTS) == set(JSTRUCTS) == {"abtree", "hashmap", "extbst"}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend,array_heap",
                         [(b, True) for b in ALL_BACKENDS]
                         + [(b, False) for b in WORD_BACKENDS],
                         ids=[f"{b}-array" for b in ALL_BACKENDS]
                         + [f"{b}-object" for b in WORD_BACKENDS])
def test_struct_matches_dict(backend, array_heap, kind):
    tm = _make(T, backend, array_heap)
    s = _build(STRUCTS, kind, tm)
    ref = {}
    for op, k in _ops(7, 400):
        if op == "insert":
            T.run(tm, lambda tx, k=k: s.insert(tx, k, k * 3), tid=0)
            ref[k] = k * 3
        elif op == "delete":
            T.run(tm, lambda tx, k=k: s.delete(tx, k), tid=0)
            ref.pop(k, None)
        else:
            got = T.run(tm, lambda tx, k=k: s.search(tx, k), tid=0)
            assert got == ref.get(k), (k, got, ref.get(k))
    # final sweep, in one transaction
    got = T.run(tm, lambda tx: [s.search(tx, k) for k in range(200)], tid=0)
    assert got == [ref.get(k) for k in range(200)]
    tm.stop()


def _state(tm, backend):
    """Heap (block), lock words, clock and multiverse's mirror as numpy,
    for either package."""
    if backend == "mvstore":
        clock, live = tm._snap[0], tm._snap[1]
        live = live.cpu().numpy() if hasattr(live, "cpu") else live
        return {"block": np.asarray(live).copy(), "clock": int(clock)}
    eng = tm.raw
    if hasattr(eng, "device"):           # the port
        return T.dump_numpy_state(tm)
    out = {"heap": eng.heap._buf[:len(eng.heap)].copy(),
           "lock_words": eng.locks._words.copy(),
           "clock": eng.clock.load()}
    vlt = getattr(eng.policy, "vlt", None)
    if vlt is not None:
        m = vlt.mirror
        out.update(mirror_seq=m._seq.copy(), mirror_addr=m._addr.copy(),
                   mirror_ts=m._ts.copy(), mirror_data=m._data.copy())
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_op_stream_leaves_the_reference_heap(backend, kind):
    """The same seeded op stream, ten ops to a transaction: the same
    answer to every op and bit-identical final state.  The reference's
    MVStore compiles a commit for every new write-set shape and grows its
    block at every allocation, so it takes a shorter stream in fewer
    transactions."""
    answers, states = [], []
    n_ops, per_txn = (80, 20) if backend == "mvstore" else (240, 10)
    ops = _ops(11, n_ops)
    for pkg, structs in ((J, JSTRUCTS), (T, STRUCTS)):
        tm = _make(pkg, backend)
        s = _build(structs, kind, tm)

        def batch(tx, chunk):
            out = []
            for op, k in chunk:
                if op == "insert":
                    out.append(s.insert(tx, k, 5 * k + 1))
                elif op == "delete":
                    out.append(s.delete(tx, k))
                else:
                    got = s.search(tx, k)
                    out.append(None if got is None else int(got))
            return out

        got = [pkg.run(tm, lambda tx, c=ops[i:i + per_txn]: batch(tx, c),
                       tid=0)
               for i in range(0, len(ops), per_txn)]
        answers.append(got)
        states.append(_state(tm, backend))
        tm.stop()
    assert answers[1] == answers[0]
    assert set(states[1]) == set(states[0])
    for key in states[0]:
        np.testing.assert_array_equal(np.asarray(states[1][key]),
                                      np.asarray(states[0][key]),
                                      err_msg=key)


@pytest.mark.parametrize("cls", [ABTree, ExternalBST],
                         ids=["abtree", "extbst"])
def test_range_query_ordered_and_complete(cls):
    tm = _make(T, "multiverse")
    s = cls(tm)
    keys = random.Random(3).sample(range(10000), 500)
    for i in range(0, len(keys), 50):
        T.run(tm, lambda tx, ks=keys[i:i + 50]: [s.insert(tx, k, k)
                                                 for k in ks], tid=0)
    lo = 2500
    out = T.run(tm, lambda tx: s.range_query(tx, lo, 100), tid=0)
    expect = sorted(k for k in keys if k >= lo)[:100]
    assert [int(k) for k, _ in out] == expect
    assert [int(v) for _, v in out] == expect
    tm.stop()


@pytest.mark.parametrize("backend", ["multiverse", "mvstore"])
def test_hashmap_size_query_atomicity(backend):
    tm = _make(T, backend)
    h = HashMap(tm, 64)
    T.run(tm, lambda tx: [h.insert(tx, k, k) for k in range(100)], tid=0)
    stop = threading.Event()

    def churn():
        i = 0
        while not stop.is_set():
            # insert+delete one key in ONE txn: size must stay 100
            def txn(tx):
                h.insert(tx, 1000 + (i % 7), 1)
                h.delete(tx, 1000 + (i % 7))
            T.run(tm, txn, tid=1)
            i += 1

    th = threading.Thread(target=churn)
    th.start()
    try:
        sizes = [T.run(tm, h.size_query, tid=0) for _ in range(5)]
    finally:
        stop.set()
        th.join()
        tm.stop()
    assert sizes == [100] * 5


def test_abtree_splits_deep_tree():
    tm = _make(T, "multiverse")
    t = ABTree(tm, a=2, b=4)          # tiny fanout -> deep tree
    n = 300
    for i in range(0, n, 50):
        T.run(tm, lambda tx, i=i: [t.insert(tx, k, -k)
                                   for k in range(i, i + 50)], tid=0)
    got = T.run(tm, lambda tx: [t.search(tx, k) for k in range(0, n, 17)],
                tid=0)
    assert got == [-k for k in range(0, n, 17)]
    out = T.run(tm, lambda tx: t.range_query(tx, 0, n), tid=0)
    assert [int(k) for k, _ in out] == list(range(n))
    tm.stop()
