"""The port's commit_fused with its ring refresh, and the bracketed bulk
gather, against the JAX package.

``commit_fused`` takes the reference's optional ring refresh
(``repro/kernels/ops.py``'s ``ring``/``ring_ts``/``ring_slot``): its
plain version and its CPU route must equal the reference's call bit for
bit on the heap, the verdict, the release words, the ring and the
timestamps; ``mv_commit_fused`` must publish through ONE such call and
match the reference's store over a seeded schedule.  The bracketed
gather (``gather_read.gather_bracketed``, ``bulkread.gather_lockver``)
must return what the three gathers it replaces return.  Inputs are
seeded numpy arrays handed to both packages.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MVStoreConfig as JCfg
from repro.core import mvstore as JM
from repro.kernels import gather_read as J_GR
from repro.kernels import ops
from repro_torch import api as T
from repro_torch.configs.base import MVStoreConfig as TCfg
from repro_torch.configs.paper_stm import MultiverseParams as TParams
from repro_torch.core import mvstore as TM
from repro_torch.core.engine import bulkread as B
from repro_torch.kernels import commit_fused as CF
from repro_torch.kernels import gather_read as GR
from repro_torch.reliability import faultpoints as TFP

I32 = (1 << 31) - 1


def _words(ver, own, meta):
    """Packed lock words (ArrayLockTable's layout): version, owner tid,
    meta bit0 locked / bit1 flag."""
    own = np.asarray(own, np.int64)
    meta = np.asarray(meta, np.int64)
    return ((np.asarray(ver, np.int64) << CF.VER_SHIFT)
            | (((own + CF.TID_BIAS) & CF.TID_MASK) << 2)
            | ((meta & 1) << 1) | ((meta >> 1) & 1))


def _batch(rng, n_txn, h):
    """A group with passing and failing members: ragged write sets, lock
    and read entries some of which are locked, flagged or too new."""
    parts = [rng.choice(h, size=int(rng.integers(0, 9)), replace=False)
             for _ in range(n_txn)]
    w_addr, w_seg, _ = CF.pack_segments(parts)
    n_l, n_r = int(rng.integers(1, 4 * n_txn)), int(rng.integers(1, 4 * n_txn))

    def entries(k):
        return _words(rng.integers(0, 50, k), rng.integers(-1, n_txn, k),
                      rng.integers(0, 4, k) * (rng.random(k) < 0.2))
    return dict(w_addr=w_addr.astype(np.int64),
                w_val=rng.integers(-1000, 1000, w_addr.size).astype(np.int64),
                w_seg=w_seg, l_words=entries(n_l),
                l_seg=rng.integers(0, n_txn, n_l).astype(np.int64),
                r_words=entries(n_r),
                r_seen=rng.integers(0, 50, n_r).astype(np.int64),
                r_seg=rng.integers(0, n_txn, n_r).astype(np.int64),
                tids=np.arange(n_txn, dtype=np.int64),
                r_clocks=rng.integers(0, 50, n_txn).astype(np.int64))


def _cols(b):
    return (b["w_addr"], b["w_val"], b["w_seg"], b["l_words"], b["l_seg"],
            b["r_words"], b["r_seen"], b["r_seg"], b["tids"], b["r_clocks"])


@pytest.mark.parametrize("ts_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("mode", [CF.MODE_LT, CF.MODE_LE, CF.MODE_EQ])
def test_commit_fused_ring_matches_reference(mode, dtype, ts_dtype):
    """The wrapper's CPU route and the plain version, with the ring
    refresh, equal the reference's ``ops.commit_fused(..., ring=,
    ring_ts=, ring_slot=)`` bit for bit: heap, verdict, release words,
    ring and timestamps; in place and out of place alike."""
    rng = np.random.default_rng(100 * mode + 10 * (dtype == np.int64)
                                + (ts_dtype == np.int64))
    h, n_txn, r, cv = 48, 4, 3, 77
    for _ in range(3):
        heap = rng.integers(-100, 100, h).astype(dtype)
        ring = rng.integers(-9, 9, (r, h)).astype(dtype)
        ts = np.array([5, -1, 3], ts_dtype)
        slot = int(rng.integers(0, r))
        b = _batch(rng, n_txn, h)
        j_heap, j_ok, j_l, j_ring, j_ts = ops.commit_fused(
            heap.copy(), *_cols(b), cv, n_txn, mode=mode,
            ring=jnp.asarray(ring), ring_ts=jnp.asarray(ts), ring_slot=slot)
        for oop in (False, True):
            t_heap = torch.from_numpy(heap.copy())
            t_ring, t_ts = torch.from_numpy(ring.copy()), \
                torch.from_numpy(ts.copy())
            new, ok, l_out, ring_o, ts_o = CF.commit_fused(
                t_heap, *_cols(b), cv, n_txn, mode=mode, out_of_place=oop,
                ring=t_ring, ring_ts=t_ts, ring_slot=slot)
            assert ring_o is t_ring and ts_o is t_ts     # refreshed in place
            assert (new is t_heap) != oop
            if oop:
                np.testing.assert_array_equal(t_heap.numpy(), heap)
            np.testing.assert_array_equal(new.numpy(),
                                          np.asarray(j_heap).astype(dtype))
            assert ok.dtype == torch.bool
            np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
            np.testing.assert_array_equal(l_out.numpy(), np.asarray(j_l))
            np.testing.assert_array_equal(t_ring.numpy(),
                                          np.asarray(j_ring).astype(dtype))
            np.testing.assert_array_equal(t_ts.numpy(),
                                          np.asarray(j_ts).astype(ts_dtype))
            np.testing.assert_array_equal(t_ring[slot].numpy(), new.numpy())
        # the plain version, called directly, gives the same
        p_ring, p_ts = torch.from_numpy(ring.copy()), \
            torch.from_numpy(ts.copy())
        t = [torch.from_numpy(np.asarray(c)) for c in _cols(b)]
        t[1] = t[1].to(torch.from_numpy(heap).dtype)
        out = CF.commit_fused_plain(torch.from_numpy(heap.copy()), *t, cv,
                                    n_txn, mode, True, p_ring, p_ts, slot)
        np.testing.assert_array_equal(out[0].numpy(),
                                      np.asarray(j_heap).astype(dtype))
        np.testing.assert_array_equal(out[3].numpy(),
                                      np.asarray(j_ring).astype(dtype))
        np.testing.assert_array_equal(out[4].numpy(),
                                      np.asarray(j_ts).astype(ts_dtype))


def test_commit_fused_ring_rejects_bad_arguments():
    """A ring of another dtype or width, a timestamp row of the wrong
    length, a slot outside the ring, or a commit version an int32
    timestamp cannot hold raise before anything is written."""
    heap = torch.zeros(8, dtype=torch.int32)
    ring = torch.zeros((2, 8), dtype=torch.int32)
    ts = torch.full((2,), -1, dtype=torch.int32)
    z = np.zeros((0,), np.int64)
    args = (heap, [1], [5], [0], z, z, z, z, z, [0], [0])
    bad = [(dict(ring=ring.to(torch.int64), ring_ts=ts, ring_slot=0), 3,
            ValueError),
           (dict(ring=torch.zeros((2, 7), dtype=torch.int32), ring_ts=ts,
                 ring_slot=0), 3, ValueError),
           (dict(ring=ring, ring_ts=ts[:1], ring_slot=0), 3, ValueError),
           (dict(ring=ring, ring_ts=ts.to(torch.float32), ring_slot=0), 3,
            ValueError),
           (dict(ring=ring, ring_ts=ts, ring_slot=2), 3, IndexError),
           (dict(ring=ring, ring_ts=ts), 3, ValueError),
           (dict(ring=ring, ring_ts=ts, ring_slot=1), 1 << 31, ValueError)]
    for kw, cv, err in bad:
        with pytest.raises(err):
            CF.commit_fused(*args, cv, 1, **kw)
    assert heap.tolist() == [0] * 8 and ring.abs().sum() == 0
    assert ts.tolist() == [-1, -1]


@pytest.mark.parametrize("ring_slots", [2, 8])
def test_mv_commit_fused_ring_parity(ring_slots):
    """A seeded schedule of sparse publishes on a versioned int32 block:
    the port's store (block, ring, timestamps, clock, block clocks) equals
    the reference's after every publish."""
    rng = np.random.default_rng(ring_slots)
    blk = rng.integers(-1000, 1000, 64).astype(np.int32)
    js = JM.mv_init({"heap": jnp.asarray(blk)}, JCfg(ring_slots=ring_slots),
                    versioned="all")
    ts = TM.mv_init({"heap": torch.from_numpy(blk.copy())},
                    TCfg(ring_slots=ring_slots), versioned="all")
    for _ in range(3 * ring_slots + 1):
        k = int(rng.integers(0, 6))
        addrs = rng.choice(64, k, replace=False)
        vals = rng.integers(-5000, 5000, k)
        js = JM.mv_commit_fused(js, "heap", addrs, vals, local_mode="U",
                                cfg=JCfg(ring_slots=ring_slots))
        ts = TM.mv_commit_fused(ts, "heap", addrs, vals, local_mode="U",
                                cfg=TCfg(ring_slots=ring_slots))
        assert int(js.clock) == ts.clock
        assert {p: int(v) for p, v in js.block_clocks.items()} == \
            ts.block_clocks
        np.testing.assert_array_equal(ts.live["heap"].numpy(),
                                      np.asarray(js.live["heap"]))
        np.testing.assert_array_equal(ts.ring["['heap']"].numpy(),
                                      np.asarray(js.ring["['heap']"]))
        np.testing.assert_array_equal(ts.ring_ts["['heap']"].numpy(),
                                      np.asarray(js.ring_ts["['heap']"]))


def test_mv_commit_fused_is_one_call_with_the_ring(monkeypatch):
    """Every publish of a versioned block is ONE ``commit_fused`` call
    that carries the ring, the timestamps and the slot ``clock' % R``;
    nothing else writes the ring slot."""
    calls = []
    real = CF.commit_fused

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)
    monkeypatch.setattr(CF, "commit_fused", spy)
    cfg = TCfg(ring_slots=4)
    st = TM.mv_init({"heap": torch.arange(16, dtype=torch.int32)}, cfg,
                    versioned="all")
    ring, ring_ts = st.ring["['heap']"], st.ring_ts["['heap']"]
    for step in range(1, 7):
        st = TM.mv_commit_fused(st, "heap", [step], [100 + step],
                                local_mode="U", cfg=cfg)
        assert len(calls) == step
        kw = calls[-1]
        assert kw["ring"] is ring and kw["ring_ts"] is ring_ts
        assert kw["ring_slot"] == step % 4 and kw["out_of_place"]
        np.testing.assert_array_equal(ring[step % 4].numpy(),
                                      st.live["heap"].numpy())
        assert int(ring_ts[step % 4]) == step
    # an unversioned block publishes without a ring
    st = TM.mv_init({"heap": torch.zeros(4, dtype=torch.int32)}, cfg)
    TM.mv_commit_fused(st, "heap", [1], [2], local_mode="Q", cfg=cfg)
    assert "ring" not in calls[-1]


def test_ring_row_at_mid_scatter_holds_the_first_half(monkeypatch):
    """With a fault schedule installed the ring row takes the surviving
    rows in the same two halves as the heap: at ``mid_scatter`` both hold
    the old block plus the first half, never a torn mix of the two."""
    heap = torch.arange(16, dtype=torch.int64)
    ring = torch.full((2, 16), -1, dtype=torch.int64)
    ts = torch.full((2,), -1, dtype=torch.int64)
    images = []

    class Stop(Exception):
        pass

    def capture(point, tid=-1):
        images.append((point, heap.clone(), ring[1].clone(), ts.clone()))
        raise Stop()
    monkeypatch.setattr(TFP, "ACTIVE", object())
    monkeypatch.setattr(TFP, "fire", capture)
    z = np.zeros((0,), np.int64)
    addrs = np.array([1, 2, 3, 9], np.int64)
    with pytest.raises(Stop):
        CF.commit_fused(heap, addrs, 100 + addrs, [0, 0, 0, 0], z, z, z, z,
                        z, [0], [0], 5, 1, ring=ring, ring_ts=ts,
                        ring_slot=1)
    (point, h_img, r_img, t_img), = images
    assert point == "mid_scatter"
    want = np.arange(16)
    want[[1, 2]] = [101, 102]
    np.testing.assert_array_equal(h_img.numpy(), want)
    np.testing.assert_array_equal(r_img.numpy(), want)
    assert t_img.tolist() == [-1, -1]         # stamped after the scatter


# ---------------------------------------------------------------------------
# the bracketed gather
# ---------------------------------------------------------------------------


def _three_gathers(words, heap, idxs, addrs):
    """What gather_lockver issued before the bracket: three gather_read
    calls."""
    pre = GR.gather_read(words, idxs)
    vals = GR.gather_read(heap, addrs)
    post = GR.gather_read(words, idxs)
    return pre, post, vals


@pytest.mark.parametrize("n", [1, 7, 256, 300])
def test_gather_bracketed_matches_three_gathers_and_pallas(n):
    rng = np.random.default_rng(7 + n)
    words = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, 512,
                                          dtype=np.int64))
    heap_np = rng.integers(-I32, I32, 2048).astype(np.int64)
    heap = torch.from_numpy(heap_np.copy())
    idxs = rng.integers(0, 512, n).astype(np.int64)
    addrs = rng.integers(0, 2048, n).astype(np.int64)
    out = GR.gather_bracketed(words, heap, idxs, addrs)
    assert out.shape == (4, n) and out.dtype == torch.int64
    pre, post, vals = _three_gathers(words, heap, idxs, addrs)
    for row, want in zip(out, (pre, post, vals, torch.from_numpy(idxs))):
        np.testing.assert_array_equal(row.numpy(), want.numpy())
    plain = GR.gather_lockver_plain(words, heap, torch.from_numpy(idxs),
                                    torch.from_numpy(addrs))
    np.testing.assert_array_equal(plain.numpy(), out.numpy())
    # the heap row is the reference kernel's gather (interpret mode)
    tile = min(512, 1 << (n - 1).bit_length()) if n > 1 else 1
    padded = np.pad(addrs, (0, (-n) % tile))
    want = np.asarray(J_GR.gather_read_flat(
        jnp.asarray(heap_np.astype(np.int32)),
        jnp.asarray(padded, jnp.int32), tile=tile, interpret=True))[:n]
    np.testing.assert_array_equal(out[2].numpy(), want)


def test_gather_bracketed_rejects_bad_batches():
    words = torch.zeros(16, dtype=torch.int64)
    heap = torch.zeros(32, dtype=torch.int64)
    for idxs, addrs in (([-1], [0]), ([16], [0]), ([0], [-2]), ([0], [32])):
        with pytest.raises(IndexError):
            GR.gather_bracketed(words, heap, idxs, addrs)
    with pytest.raises(ValueError):
        GR.gather_bracketed(words, heap, [0, 1], [0])
    with pytest.raises(ValueError):
        GR.gather_bracketed(words.to(torch.int32), heap, [0], [0])


@pytest.mark.parametrize("array_heap", [True, False])
@pytest.mark.parametrize("backend", ["multiverse", "tl2", "dctl", "tinystm"])
def test_gather_lockver_returns_what_three_gathers_return(backend,
                                                          array_heap):
    """``bulkread.gather_lockver`` keeps its contract ``(idxs, idx_dev,
    words [2, N], vals)`` on every lock-version backend: on an
    ``ArrayHeap`` from one bracketed gather, on an ``ObjectHeap`` from
    the three gathers; both equal three ``gather_read`` calls."""
    tm = T.make_tm(backend, 2, array_heap=array_heap, device="cpu",
                   params=TParams(k1=2, k2=50, k3=50, lock_table_bits=6))
    base = tm.alloc(300, 7)
    T.run(tm, lambda tx: [tx.write(base + i, 1000 + i) for i in range(0, 300,
                                                                     7)],
          tid=0)
    eng = tm.raw
    addrs = np.arange(base, base + 300, dtype=np.int64)[::-1].copy()
    idxs, idx_dev, words, vals = B.gather_lockver(eng, addrs)
    np.testing.assert_array_equal(idxs, eng.locks.index_bulk(addrs))
    np.testing.assert_array_equal(idx_dev.numpy(), idxs)
    assert words.shape == (2, addrs.size)
    pre = GR.gather_read(eng.locks.row, idxs)
    np.testing.assert_array_equal(words[0].numpy(), pre.numpy())
    np.testing.assert_array_equal(words[1].numpy(), pre.numpy())
    want = [eng.heap[int(a)] for a in addrs]
    got = vals.tolist() if isinstance(vals, torch.Tensor) else list(vals)
    assert got == want
    if array_heap:
        np.testing.assert_array_equal(
            vals.numpy(), GR.gather_read(eng.heap.live(), addrs).numpy())
    tm.stop()


def test_bulk_read_takes_one_bracketed_gather_per_chunk(monkeypatch):
    """A read-only scan in 64-word chunks on an ``ArrayHeap``: one
    bracketed gather per chunk and no other gather."""
    tm = T.make_tm("tl2", 2, array_heap=True, device="cpu",
                   params=TParams(k1=2, k2=50, k3=50, lock_table_bits=6))
    base = tm.alloc(256, 3)
    counts = {"bracketed": 0, "plain": 0}
    real_b, real_g = GR.gather_bracketed, GR.gather_read

    def bracketed(*a, **k):
        counts["bracketed"] += 1
        return real_b(*a, **k)

    def plain(*a, **k):
        counts["plain"] += 1
        return real_g(*a, **k)
    monkeypatch.setattr(GR, "gather_bracketed", bracketed)
    monkeypatch.setattr(GR, "gather_read", plain)
    total = T.run(tm, lambda tx: sum(
        int(tx.read_bulk(range(base + off, base + off + 64)).sum())
        for off in range(0, 256, 64)), tid=0)
    assert total == 3 * 256
    assert counts == {"bracketed": 4, "plain": 0}
    tm.stop()
