"""The port's group commit (``CommitBatcher``, ``partition_disjoint``)
against the JAX package's.

* ``partition_disjoint``, ``pack_segments`` and ``np_commit_decide``
  equal the reference's on random inputs.
* A TL2 group and a DCTL group commit to the same heap, lock words and
  clock in both packages; grouped equals solo; a TL2 group ticks the
  clock once and DCTL adds no tick; a failed member claims and scatters
  nothing; overlapping and ineligible batches commit solo.
* The TL2 group publishes through ``commit_fused`` (its plain version on
  the CPU) and refuses to release when the kernel's verdict differs from
  the host's.
* The ``mid_scatter`` fault splits the group scatter over the surviving
  rows exactly as the reference's numpy version does.
"""
import numpy as np
import pytest
import torch

import repro.api as J
from repro.configs.paper_stm import MultiverseParams as JParams
from repro.core.engine import groupcommit as JG
from repro.kernels import commit_fused as J_CF
from repro.reliability import faultpoints as JFP
from repro_torch import api as T
from repro_torch.configs.paper_stm import MultiverseParams as TParams
from repro_torch.core.engine import commit as C
from repro_torch.core.engine import groupcommit as TG
from repro_torch.kernels import commit_fused as CF
from repro_torch.reliability import faultpoints as TFP

N_TXNS, WORDS = 4, 24


def _tm(pkg, backend, n_threads=N_TXNS, array_heap=True):
    if pkg is J:
        return J.make_tm(backend, n_threads, array_heap=array_heap,
                         params=JParams(k1=2, k2=50, k3=50,
                                        lock_table_bits=8))
    return T.make_tm(backend, n_threads, array_heap=array_heap,
                     device="cpu",
                     params=TParams(k1=2, k2=50, k3=50, lock_table_bits=8))


def _heap(raw, base, n):
    return np.asarray(raw.heap.gather(np.arange(base, base + n,
                                                dtype=np.int64)))


def _locks(raw):
    w = raw.locks._words
    return w.numpy() if isinstance(w, torch.Tensor) else w


# ---------------------------------------------------------------------------
# host helpers: equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_partition_and_decide_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    span = int(rng.choice([16, 64, 1 << 20, 1 << 41]))
    ws = [rng.integers(0, span, rng.integers(0, 6)).astype(np.int64)
          for _ in range(n)]
    rs = [rng.integers(0, span, rng.integers(0, 6)).astype(np.int64)
          for _ in range(n)]
    assert TG.partition_disjoint(ws, rs) == JG.partition_disjoint(ws, rs)
    for got, want in zip(CF.pack_segments(ws), J_CF.pack_segments(ws)):
        np.testing.assert_array_equal(got, want)
    L, M = int(rng.integers(0, 12)), int(rng.integers(0, 12))
    args = (rng.integers(0, 30, L), rng.integers(-1, 4, L).astype(np.int32),
            rng.integers(0, 4, L).astype(np.int32), rng.integers(0, n, L),
            rng.integers(0, 30, M), rng.integers(-1, 4, M).astype(np.int32),
            rng.integers(0, 4, M).astype(np.int32), rng.integers(0, 30, M),
            rng.integers(0, n, M), np.arange(n), rng.integers(0, 30, n), n)
    for mode in (0, 1, 2):
        np.testing.assert_array_equal(CF.np_commit_decide(*args, mode),
                                      J_CF.np_commit_decide(*args, mode))


# ---------------------------------------------------------------------------
# engine: group == solo == reference, one tick, degrade, individual abort
# ---------------------------------------------------------------------------


def _ready_batch(tm, base, stamp, bulk=False):
    raw = tm.raw
    txs = []
    for t in range(N_TXNS):
        tx = raw.begin(t)
        addrs = range(base + t * WORDS, base + (t + 1) * WORDS)
        vals = [stamp + t * WORDS + i for i in range(WORDS)]
        if bulk:
            tx.write_bulk(addrs, vals)
        else:
            for a, v in zip(addrs, vals):
                tx.write(a, v)
        txs.append(tx)
    return txs


@pytest.mark.parametrize("array_heap", [True, False])
@pytest.mark.parametrize("backend", ["tl2", "dctl"])
def test_group_matches_solo_reference_and_ticks(backend, array_heap):
    span = N_TXNS * WORDS
    out = {}
    for pkg, batcher in ((J, JG.CommitBatcher), (T, TG.CommitBatcher)):
        tm_g = _tm(pkg, backend, array_heap=array_heap)
        tm_s = _tm(pkg, backend, array_heap=array_heap)
        base_g, base_s = tm_g.alloc(span), tm_s.alloc(span)
        b = batcher(tm_g.raw)
        for tx in _ready_batch(tm_g, base_g, 1000):
            b.add(tx)
        c0 = tm_g.raw.clock.load()
        assert b.commit_all() == [True] * N_TXNS
        c1 = tm_g.raw.clock.load()
        assert b.stats["groups"] == 1 and b.stats["grouped"] == N_TXNS
        # TL2: ONE tick for the whole batch; DCTL's deferred clock none
        assert c1 - c0 == (1 if backend == "tl2" else 0)
        for tx in _ready_batch(tm_s, base_s, 1000):
            tm_s.raw._try_commit(tx._ctx)
        got = _heap(tm_g.raw, base_g, span)
        np.testing.assert_array_equal(got, _heap(tm_s.raw, base_s, span))
        np.testing.assert_array_equal(got, 1000 + np.arange(span))
        out[pkg] = (got, _locks(tm_g.raw), c1, dict(b.stats))
        tm_g.stop()
        tm_s.stop()
    (jh, jl, jc, js), (th, tl, tc, ts) = out[J], out[T]
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tl, jl)
    assert (tc, ts) == (jc, js)


def test_tl2_group_with_reads_matches_reference():
    """Members that read (the full verdict, not the fast path) and write
    through ``write_bulk``: same heap, lock words and clock."""
    out = {}
    for pkg, batcher in ((J, JG.CommitBatcher), (T, TG.CommitBatcher)):
        tm = _tm(pkg, "tl2")
        base = tm.alloc(N_TXNS * WORDS + 8, 3)
        txs = []
        for t in range(N_TXNS):
            tx = tm.raw.begin(t)
            seen = int(tx.read(base + N_TXNS * WORDS + t))
            tx.write_bulk(range(base + t * WORDS, base + (t + 1) * WORDS),
                          [seen + t] * WORDS)
            txs.append(tx)
        b = batcher(tm.raw)
        for tx in txs:
            b.add(tx)
        assert b.commit_all() == [True] * N_TXNS
        out[pkg] = (_heap(tm.raw, base, N_TXNS * WORDS + 8),
                    _locks(tm.raw), tm.raw.clock.load())
        tm.stop()
    for got, want in zip(out[T], out[J]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_overlapping_buffered_degrades_to_solo():
    tm = _tm(T, "tl2")
    raw = tm.raw
    base = tm.alloc(16)
    t1, t2 = raw.begin(0), raw.begin(1)
    t1.write(base, 111)
    t1.write(base + 1, 1)
    t2.write(base, 222)
    t2.write(base + 2, 2)
    b = TG.CommitBatcher(raw)
    b.add(t1)
    b.add(t2)
    assert b.commit_all() == [True, True]
    assert b.stats == {"grouped": 0, "solo": 2, "groups": 0, "failed": 0}
    assert _heap(raw, base, 3).tolist() == [222, 1, 2]
    tm.stop()


def test_group_member_failing_validation_aborts_alone():
    tm = _tm(T, "tl2")
    raw = tm.raw
    base = tm.alloc(16)
    t0 = raw.begin(0)
    assert t0.read(base + 8) == 0
    t0.write(base, 7)
    bump = raw.begin(3)
    bump.write(base + 8, 55)
    raw._try_commit(bump._ctx)
    t1 = raw.begin(1)
    t1.write(base + 1, 8)
    t2 = raw.begin(2)
    t2.write(base + 2, 9)
    b = TG.CommitBatcher(raw)
    for tx in (t0, t1, t2):
        b.add(tx)
    assert b.commit_all() == [False, True, True]
    got = _heap(raw, base, 9)
    assert got[0] == 0 and got[1] == 8 and got[2] == 9 and got[8] == 55
    assert len(raw.locks.held_by(0)) == 0      # claimed nothing
    t3 = raw.begin(0)
    t3.write(base, 77)
    raw._try_commit(t3._ctx)
    assert _heap(raw, base, 1).tolist() == [77]
    tm.stop()


def test_ineligible_descriptors_fall_back_solo():
    tm = _tm(T, "norec", n_threads=2)
    raw = tm.raw
    base = tm.alloc(8)
    t1 = raw.begin(0)
    t1.write(base, 1)
    t2 = raw.begin(1)
    t2.write(base + 1, 2)
    b = TG.CommitBatcher(raw)
    b.add(t1)
    b.add(t2)
    assert b.commit_all() == [True, True]
    assert b.stats["groups"] == 0 and b.stats["solo"] == 2
    assert _heap(raw, base, 2).tolist() == [1, 2]
    tm.stop()


def test_addr_lock_indices_accepts_generator():
    tm = _tm(T, "tl2")
    want = C.addr_lock_indices(tm.raw, np.asarray([3, 17, 255], np.int64))
    got = C.addr_lock_indices(tm.raw, (a for a in [3, 17, 255]))
    np.testing.assert_array_equal(got, want)
    tm.stop()


# ---------------------------------------------------------------------------
# the kernel publish and its verdict guard
# ---------------------------------------------------------------------------


def test_tl2_group_publishes_through_commit_fused(monkeypatch):
    calls = []
    real = CF.commit_fused

    def spy(heap, *a, **k):
        calls.append((heap.data_ptr(), k.get("out_of_place", False)))
        return real(heap, *a, **k)
    monkeypatch.setattr(CF, "commit_fused", spy)
    tm = _tm(T, "tl2")
    base = tm.alloc(N_TXNS * WORDS)
    b = TG.CommitBatcher(tm.raw)
    for tx in _ready_batch(tm, base, 5, bulk=True):
        b.add(tx)
    assert b.commit_all() == [True] * N_TXNS
    assert calls == [(tm.raw.heap.live().data_ptr(), False)]   # in place
    assert len(tm.raw.locks.held_by(0)) == 0
    tm.stop()


def test_kernel_verdict_differing_from_host_raises(monkeypatch):
    real = CF.commit_fused

    def flipped(*a, **k):
        heap, ok, rel = real(*a, **k)
        ok = ok.clone()
        ok[0] = 0
        return heap, ok, rel
    monkeypatch.setattr(CF, "commit_fused", flipped)
    tm = _tm(T, "tl2")
    base = tm.alloc(N_TXNS * WORDS)
    b = TG.CommitBatcher(tm.raw)
    for tx in _ready_batch(tm, base, 5):
        b.add(tx)
    with pytest.raises(RuntimeError, match="host verdict"):
        b.commit_all()
    tm.stop()


def test_mid_scatter_split_matches_reference(monkeypatch):
    """A fault at ``mid_scatter`` inside the fused publish sees the same
    partial-lane image as inside the reference's numpy version: the
    first half of the SURVIVING rows scattered, the rest not."""
    import sys

    heap = np.arange(16, dtype=np.int64)
    w_addr = np.array([1, 2, 3, 9, 10, 11, 12], np.int64)
    w_val = 100 + w_addr
    w_seg = np.array([0, 0, 0, 1, 1, 2, 2], np.int64)
    # member 1's write lock is held by tid 9: it fails
    l_words = np.array([4, (9 + 2) << 2 | 2, 4], np.int64)
    l_seg = np.array([0, 1, 2], np.int64)
    lf = (l_words >> 18, (((l_words >> 2) & 0xFFFF) - 2).astype(np.int32),
          (((l_words >> 1) & 1) | ((l_words & 1) << 1)).astype(np.int32))
    z = np.zeros((0,), np.int64)
    images = []

    class Stop(Exception):
        pass

    def capture(point, tid=-1):
        assert point == "mid_scatter"
        out = sys._getframe(1).f_locals["out"]
        images.append(np.asarray(out).copy())
        raise Stop()

    for FP in (JFP, TFP):
        monkeypatch.setattr(FP, "ACTIVE", FP.FaultSchedule())
        monkeypatch.setattr(FP, "fire", capture)
    with pytest.raises(Stop):
        J_CF.np_commit_fused(heap, w_addr, w_val, w_seg, *lf, l_seg, z,
                             z.astype(np.int32), z.astype(np.int32), z, z,
                             np.arange(3), np.zeros(3, np.int64), 7, 3)
    with pytest.raises(Stop):
        CF.commit_fused(torch.from_numpy(heap.copy()), w_addr, w_val, w_seg,
                        l_words, l_seg, z, z, z, np.arange(3),
                        np.zeros(3, np.int64), 7, 3)
    np.testing.assert_array_equal(images[1], images[0])
    assert images[1][1:3].tolist() == [101, 102] and images[1][3] == 3
    assert images[1][9:].tolist() == list(range(9, 16))


def _reading_batch(tm, base, stamp):
    """Members that read a word each (the full verdict, not the fast
    path) and write their own block."""
    txs = []
    for t in range(N_TXNS):
        tx = tm.raw.begin(t)
        seen = int(tx.read(base + N_TXNS * WORDS + t))
        tx.write_bulk(range(base + t * WORDS, base + (t + 1) * WORDS),
                      [stamp + seen + t] * WORDS)
        txs.append(tx)
    return txs


def test_group_publish_hands_over_gathered_words_and_keeps_the_check(
        monkeypatch):
    """The TL2 group publish gives ``commit_fused`` the lock words it
    gathered inside the stripe window as tensors on the lock table's
    device (on the card they do not cross the bus again): the unclaimed
    words of the write locks and the read entries' words.  A kernel
    verdict that differs from the host's still raises."""
    seen = []
    real = CF.commit_fused

    def spy(heap, w_addr, w_val, w_seg, l_words, l_seg, r_words, *a, **k):
        seen.append((l_words, r_words))
        return real(heap, w_addr, w_val, w_seg, l_words, l_seg, r_words,
                    *a, **k)
    monkeypatch.setattr(CF, "commit_fused", spy)
    tm = _tm(T, "tl2")
    base = tm.alloc(N_TXNS * WORDS + 8, 3)
    b = TG.CommitBatcher(tm.raw)
    for tx in _reading_batch(tm, base, 10):
        b.add(tx)
    assert b.commit_all() == [True] * N_TXNS
    (l_words, r_words), = seen
    row = tm.raw.locks.row
    for w in (l_words, r_words):
        assert isinstance(w, torch.Tensor) and w.dtype == torch.int64
        assert w.device == row.device and w.dim() == 1
    assert r_words.numel() == N_TXNS
    assert not bool(((l_words & 2) != 0).any())     # gathered before claim
    np.testing.assert_array_equal(
        _heap(tm.raw, base, N_TXNS * WORDS),
        np.repeat(10 + 3 + np.arange(N_TXNS), WORDS))

    def flipped(*a, **k):
        heap, ok, rel = real(*a, **k)
        ok = ok.clone()
        ok[N_TXNS - 1] = False
        return heap, ok, rel
    monkeypatch.setattr(CF, "commit_fused", flipped)
    b = TG.CommitBatcher(tm.raw)
    for tx in _reading_batch(tm, base, 20):
        b.add(tx)
    with pytest.raises(RuntimeError, match="host verdict"):
        b.commit_all()
    tm.stop()
