"""The port's sharded store (``core/shardstore.py``,
``engine/groupcommit.ShardedCommitBatcher``, ``launch/mesh.py``,
``launch/sharding.shard_device_slices``, ``engine/bulkread.
shard_partition``) against the JAX package's.

Every case of ``tests/test_shardstore.py`` runs through both packages on
the same seeded inputs; the port must give the reference's routing,
verdicts, heaps (every shard's block and ring), shard clocks, epoch and
counters bit for bit, and the reference test's own assertions must hold
on the port.  The five schedule tests of
``tests/test_shard_serializability.py`` drive each interleaved schedule
through both packages and compare which transactions committed, the
whole-heap snapshot after every commit, the clocks and the epoch at
every event.  The port runs on the CPU (``device="cpu"``); its
cross-shard ``read_bulk`` answers with a tensor where the reference
answers with a list, so values are compared as int64 arrays.
"""
import random
import types

import numpy as np
import pytest
import torch

import repro.api as JA
import repro_torch.api as TA
from repro.configs.paper_stm import MultiverseParams as JParams
from repro.core.engine import AbortTx as JAbort
from repro.core.engine.bulkread import shard_partition as j_partition
from repro.core.engine.groupcommit import ShardedCommitBatcher as JBatcher
from repro.core.shardstore import ShardStoreHandle as JStore
from repro.launch.sharding import shard_device_slices as j_slices
from repro_torch.configs.paper_stm import MultiverseParams as TParams
from repro_torch.core.engine import AbortTx as TAbort
from repro_torch.core.engine.bulkread import shard_partition
from repro_torch.core.engine.groupcommit import ShardedCommitBatcher
from repro_torch.core.shardstore import ShardStoreHandle, shard_devices
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh
from repro_torch.launch.sharding import shard_device_slices

SHARD_COUNTS = (1, 2, 4)
CPU = torch.device("cpu")

JAX = types.SimpleNamespace(
    name="jax", Store=JStore, Params=JParams, AbortTx=JAbort,
    Batcher=JBatcher, make_tm=JA.make_tm, kw={})
PORT = types.SimpleNamespace(
    name="torch", Store=ShardStoreHandle, Params=TParams, AbortTx=TAbort,
    Batcher=ShardedCommitBatcher, make_tm=TA.make_tm,
    kw={"device": "cpu"})


def ints(vals) -> np.ndarray:
    """A read's values as a host int64 array (tensor, ndarray or list)."""
    if isinstance(vals, torch.Tensor):
        return vals.cpu().numpy().astype(np.int64)
    return np.asarray(vals, np.int64)


def make_store(pkg, n_shards, span=8, n_threads=4, **kw):
    params = pkg.Params(k1=2, k2=50, k3=50, lock_table_bits=8)
    return pkg.Store(n_threads, n_shards=n_shards, span=span,
                     params=params, start_bg=False, **pkg.kw, **kw)


def make_solo(pkg, n_threads=4):
    params = pkg.Params(k1=2, k2=50, k3=50, lock_table_bits=8)
    return pkg.make_tm("mvstore", n_threads, params=params, start_bg=False,
                       **pkg.kw)


def shard_state(st):
    """Every shard's clock, block stamps, block and ring, as numpy."""
    out = []
    for sh in st._shards:
        s = sh._state
        d = {"clock": int(s.clock),
             "block_clocks": sorted((k, int(v)) for k, v in
                                    (s.block_clocks or {}).items()),
             "heap": ints(s.live["heap"])}
        for k in s.ring:
            d["ring" + k] = ints(s.ring[k])
            d["ring_ts" + k] = ints(s.ring_ts[k])
        out.append(d)
    return out


def observed(st):
    """What a store shows: clocks, epoch, the counters, every shard."""
    s = st.stats()
    return {"clocks": st.clocks, "epoch": st.epoch,
            "counters": {k: s[k] for k in ("commits", "aborts",
                                           "ro_commits",
                                           "versioned_commits",
                                           "cross_shard_commits",
                                           "n_shards", "epoch")},
            "shards": shard_state(st)}


def same(a, b, path="record"):
    """Deep equality of two records holding numpy arrays."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def both(scenario, *args):
    """``scenario(pkg, *args)`` on both packages; their records must be
    equal.  Returns the port's record."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    same(want, got)
    return got


def seeded_history(seed, n_words, n_ops=40):
    """A deterministic mixed scalar/bulk history over [0, n_words)."""
    r = np.random.RandomState(seed)
    ops = []
    for i in range(n_ops):
        kind = r.randint(3)
        if kind == 0:                                  # scalar write
            ops.append(("w", int(r.randint(n_words)), int(r.randint(100))))
        elif kind == 1:                                # bulk rotate
            lo = int(r.randint(n_words - 4))
            ln = int(r.randint(2, min(16, n_words - lo) + 1))
            ops.append(("rot", lo, ln))
        else:                                          # bulk stamp
            lo = int(r.randint(n_words - 4))
            ln = int(r.randint(2, min(16, n_words - lo) + 1))
            ops.append(("stamp", lo, ln, int(r.randint(1000))))
    return ops


def step(tm, base, op, tid=0):
    with tm.txn(tid=tid) as tx:
        if op[0] == "w":
            tx.write(base + op[1], op[2])
        elif op[0] == "rot":
            lo, ln = op[1], op[2]
            vals = ints(tx.read_bulk(range(base + lo, base + lo + ln)))
            tx.write_bulk(range(base + lo, base + lo + ln),
                          np.roll(vals, 1))
        else:
            lo, ln, v = op[1], op[2], op[3]
            tx.write_bulk(range(base + lo, base + lo + ln),
                          np.arange(v, v + ln, dtype=np.int64))


def drive(tm, ops, base, n_words, tid=0):
    """Run one op per transaction; return the final full-heap values."""
    for op in ops:
        step(tm, base, op, tid)
    with tm.txn(tid=tid) as tx:
        return ints(tx.read_bulk(range(base, base + n_words)))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_route_identity_at_one_shard():
    def scenario(pkg):
        st = make_store(pkg, 1, span=8)
        a = np.arange(100, dtype=np.int64)
        sid, local = st._route(a)
        st.stop()
        return {"sid": sid, "local": local}
    got = both(scenario)
    assert (got["sid"] == 0).all()
    np.testing.assert_array_equal(got["local"], np.arange(100))


@pytest.mark.parametrize("n_shards", (2, 3, 4))
@pytest.mark.parametrize("span", (1, 4, 8))
def test_route_is_a_bijection(n_shards, span):
    top = span * n_shards * 5 + (span // 2)

    def scenario(pkg):
        st = make_store(pkg, n_shards, span=span)
        a = np.arange(top, dtype=np.int64)
        sid, local = st._route(a)
        rec = {"sid": sid, "local": local,
               "tops": [[st._local_top(s, t) for t in range(top + 1)]
                        for s in range(n_shards)],
               "route1": [st._route1(x) for x in range(top)]}
        st.stop()
        return rec
    got = both(scenario)
    sid, local = got["sid"], got["local"]
    pairs = set(zip(sid.tolist(), local.tolist()))
    assert len(pairs) == top
    tops = [got["tops"][s][top] for s in range(n_shards)]
    for s in range(n_shards):
        assert all(lo < tops[s] for sh, lo in pairs if sh == s)
    assert sum(tops) == top
    for addr in (0, span - 1, span, top - 1):
        assert got["route1"][addr] == (int(sid[addr]), int(local[addr]))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_shard_partition_covers_in_order(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    cases = [(np.array([2, 0, 2, 1, 0]), 4),
             (rng.integers(0, n, int(rng.integers(0, 200))), n)]
    for sid, n_shards in cases:
        got = shard_partition(sid, n_shards)
        want = j_partition(sid, n_shards)
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, p), (_, q) in zip(got, want):
            np.testing.assert_array_equal(p, np.asarray(q))
        covered = sorted(int(i) for _, pos in got for i in pos)
        assert covered == list(range(len(sid)))
    assert [s for s, _ in shard_partition(np.array([2, 0, 2, 1, 0]),
                                          4)] == [0, 1, 2]


def test_shard_devices_single_host_is_noop():
    from repro.core.shardstore import shard_devices as j_devices

    assert shard_devices(3, device="cpu") == [CPU] * 3
    assert len(shard_devices(5, device="cpu")) == len(j_devices(5)) == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            shard_devices(2)


def test_shard_devices_mesh_round_robin():
    """With an explicit mesh, shards stripe over its device slices in
    the reference's order, and a store built over the mesh holds the
    same words as the reference's."""
    from repro.launch.mesh import make_host_mesh as j_host_mesh

    mesh = make_host_mesh(device="cpu")
    assert isinstance(mesh, Mesh) and mesh.axis_names == ("data",)
    assert mesh.devices.shape == (1,)
    assert shard_devices(3, mesh=mesh) == [CPU] * 3
    # the round-robin as a device list: a 2x2 mesh of four cards (no card
    # is touched to name one)
    cards = [torch.device("cuda", i) for i in range(4)]
    grid = make_mesh((2, 2), ("data", "model"), devices=cards)
    assert grid.devices.shape == (2, 2)
    assert shard_device_slices(grid, 6) == j_slices(grid, 6) == \
        [cards[s % 4] for s in range(6)]
    with pytest.raises(ValueError):
        make_mesh((3,), ("data",), devices=cards)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()

    def scenario(pkg):
        m = mesh if pkg is PORT else j_host_mesh()
        st = make_store(pkg, 2, span=4, mesh=m)
        base = st.alloc(16, 1)
        with st.txn(tid=0) as tx:
            tx.write_bulk(range(base, base + 16), np.arange(16))
        rec = {"peeks": [st.peek(base + i) for i in range(16)],
               **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    assert got["peeks"] == list(range(16))


# ---------------------------------------------------------------------------
# parity: sharded store vs the solo MVStoreHandle, port vs reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("seed", (0, 1))
def test_shard_parity_seeded_history(n_shards, seed):
    """Same sequential history -> same final heap at every shard count,
    and the same shard states, clocks, epoch and counters in both
    packages."""
    n_words = 64
    ops = seeded_history(seed, n_words)
    solo = make_solo(PORT)
    want = drive(solo, ops, solo.alloc(n_words, 7), n_words)
    solo.stop()

    def scenario(pkg):
        st = make_store(pkg, n_shards)
        heap = drive(st, ops, st.alloc(n_words, 7), n_words)
        rec = {"heap": heap, **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    np.testing.assert_array_equal(got["heap"], want)
    if n_shards == 1:
        assert got["epoch"] == 0


@pytest.mark.parametrize("seed", (0, 3))
def test_shard1_parity_is_bit_identical(seed):
    """shard==1: the clock and every intermediate peek match the solo
    store step for step, in both packages."""
    n_words = 48
    ops = seeded_history(seed, n_words, n_ops=25)

    def scenario(pkg):
        solo, st = make_solo(pkg), make_store(pkg, 1, span=8)
        bs, bt = solo.alloc(n_words, 7), st.alloc(n_words, 7)
        assert bs == bt == 0
        peeks = []
        for op in ops:
            step(solo, bs, op)
            step(st, bt, op)
            assert st.clocks == (solo.clock,)
            got = [st.peek(bt + i) for i in range(n_words)]
            assert got == [solo.peek(bs + i) for i in range(n_words)]
            peeks.append(got)
        rec = {"peeks": peeks, **observed(st)}
        solo.stop()
        st.stop()
        return rec
    got = both(scenario)
    assert got["epoch"] == 0          # no cross-shard traffic at one shard


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_shard_parity_bulk_vs_scalar_paths(n_shards):
    """write_bulk over a shard-spanning range == scalar writes."""
    vals = np.arange(100, 132, dtype=np.int64)

    def scenario(pkg):
        st = make_store(pkg, n_shards, span=4)
        base = st.alloc(32, 0)
        with st.txn(tid=0) as tx:
            tx.write_bulk(range(base, base + 32), vals)
        with st.txn(tid=0) as tx:
            bulk = ints(tx.read_bulk(range(base, base + 32)))
            scalar = [int(tx.read(base + i)) for i in range(32)]
        rec = {"bulk": bulk, "scalar": scalar,
               "peeks": [st.peek(base + i) for i in range(32)],
               **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    np.testing.assert_array_equal(got["bulk"], vals)
    assert got["scalar"] == got["peeks"] == vals.tolist()


def test_cross_shard_read_bulk_is_a_tensor_on_the_store_device():
    """A spanning ``read_bulk`` is reassembled on the store's device at
    the block's int32 (one ``index_copy_`` per shard); a spanning
    ``snapshot_bulk`` at int64; buffered writes overlay a read as the
    solo store's do, with a list."""
    st = make_store(PORT, 2, span=4)
    base = st.alloc(16, 3)
    with st.txn(tid=0) as tx:
        got = tx.read_bulk(range(base, base + 16))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
        assert got.device == CPU and got.tolist() == [3] * 16
        tx.write(base + 5, 9)
        mixed = tx.read_bulk(range(base + 2, base + 7))
        assert mixed == [3, 3, 3, 9, 3]
    vals, ok = st.snapshot_bulk(np.arange(base, base + 16))
    assert ok and vals.dtype == torch.int64
    assert vals.tolist() == [3] * 5 + [9] + [3] * 10
    st.stop()


@pytest.mark.parametrize("n_shards", (1, 2, 3, 4))
@pytest.mark.parametrize("span", (1, 3, 8))
def test_range_batch_splits_by_span_arithmetic(n_shards, span):
    """A unit-step range is split without routing its words: each
    shard's local batch is a range, and the local addresses, batch
    positions, reads and snapshots equal the routed address array's —
    and the reads equal the reference's."""
    r = np.random.RandomState(7 * n_shards + span)
    vals = r.randint(1000, size=41).astype(np.int64)
    spans = [(0, 41), (0, 1), (40, 41)] + [
        tuple(sorted(r.randint(42, size=2))) for _ in range(3)]

    def scenario(pkg):
        st = make_store(pkg, n_shards, span=span)
        base = st.alloc(41, 0)
        with st.txn(tid=0) as tx:
            tx.write_bulk(range(base, base + 41), vals)
        with st.txn(tid=0) as tx:
            reads = [ints(tx.read_bulk(range(base + lo, base + hi)))
                     for lo, hi in spans]
        st.stop()
        return {"reads": reads}
    got = both(scenario)
    for (lo, hi), read in zip(spans, got["reads"]):
        np.testing.assert_array_equal(read, vals[lo:hi])

    st = make_store(PORT, n_shards, span=span)
    base = st.alloc(41, 0)
    with st.txn(tid=0) as tx:
        tx.write_bulk(range(base, base + 41), vals)
    for lo, hi in spans:
        batch = range(base + lo, base + hi)
        _, fast = st._split(batch)
        _, routed = st._split(np.asarray(batch))
        assert [s for s, _, _ in fast] == [s for s, _, _ in routed]
        for (s, local, pos), (_, want_local, want_pos) in zip(fast, routed):
            assert isinstance(local, range)
            np.testing.assert_array_equal(np.asarray(local), want_local)
            if want_pos is not None:
                np.testing.assert_array_equal(
                    st._range_positions(s, batch), want_pos)
        with st.txn(tid=0) as tx:
            np.testing.assert_array_equal(ints(tx.read_bulk(batch)),
                                          vals[lo:hi])
        snap, ok = st.snapshot_bulk(batch)
        assert ok and snap.dtype == torch.int64
        np.testing.assert_array_equal(ints(snap), vals[lo:hi])
    st.stop()


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_shard_parity_registry_backend(n_shards):
    """`make_tm("shardstore")` builds the same store the ctor does, with
    the reference's stats."""
    def scenario(pkg):
        tm = pkg.make_tm("shardstore", 2,
                         params=pkg.Params(k1=2, k2=50, k3=50,
                                           lock_table_bits=8),
                         n_shards=n_shards, span=8, start_bg=False,
                         ring_slots=4, **pkg.kw)
        assert isinstance(tm, pkg.Store)
        assert tm.cfg.ring_slots == 4
        base = tm.alloc(16, 5)
        with tm.txn(tid=0) as tx:
            tx.write_bulk(range(base, base + 16), np.arange(16))
        rec = {"stats": tm.stats(), **observed(tm)}
        tm.stop()
        return rec
    got = both(scenario)
    st = got["stats"]
    assert st["backend"] == "shardstore"
    assert st["n_shards"] == n_shards and st["commits"] == 1


@pytest.mark.parametrize("mode", ("U", "Q"))
def test_shard_registry_forced_mode(mode):
    def scenario(pkg):
        tm = pkg.make_tm("shardstore", 2, n_shards=2, span=8,
                         start_bg=False, forced_mode=mode, **pkg.kw)
        rec = {"mode": tm.stats()["mode"], "k2": tm.params.k2,
               "transitions": tm.controller.stats["mode_transitions"]}
        tm.stop()
        return rec
    got = both(scenario)
    assert (got["mode"] == "U") == (mode == "U")


# ---------------------------------------------------------------------------
# per-shard clock independence (the tentpole's observable)
# ---------------------------------------------------------------------------


def outcome(pkg, fn):
    """``fn()``'s result, or ``"abort"`` when it raised the package's
    AbortTx."""
    try:
        fn()
        return "commit"
    except pkg.AbortTx:
        return "abort"


def test_shard_disjoint_commits_do_not_conflict():
    """A txn pinned BEFORE a commit to a DIFFERENT shard still commits;
    the same schedule on one shard aborts."""
    def scenario(pkg, n_shards):
        st = make_store(pkg, n_shards, span=8)
        base = st.alloc(16, 0)             # words 0-7 -> shard 0, 8-15 -> 1
        tx = st.begin(tid=0)
        tx.write(base + 0, 11)             # shard 0
        with st.txn(tid=1) as tx2:
            tx2.write(base + 8, 22)        # shard 1 commits in between
        rec = {"outcome": outcome(pkg, lambda: st.commit(tx)),
               "peeks": [st.peek(base + 0), st.peek(base + 8)],
               **observed(st)}
        st.stop()
        return rec
    got = both(scenario, 2)
    assert got["outcome"] == "commit" and got["peeks"] == [11, 22]
    assert got["clocks"] == (1, 1) and got["epoch"] == 0
    got = both(scenario, 1)
    assert got["outcome"] == "abort"       # one shard = one clock: stale


def test_shard_same_shard_conflict_still_aborts():
    def scenario(pkg):
        st = make_store(pkg, 2, span=8)
        base = st.alloc(16, 0)
        tx = st.begin(tid=0)
        tx.write(base + 1, 1)
        with st.txn(tid=1) as tx2:
            tx2.write(base + 2, 2)         # same shard 0
        rec = {"outcome": outcome(pkg, lambda: st.commit(tx)),
               **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    assert got["outcome"] == "abort" and got["counters"]["aborts"] == 1


def test_shard_cross_commit_epoch_and_clocks():
    vals = np.arange(50, 66, dtype=np.int64)

    def scenario(pkg):
        st = make_store(pkg, 2, span=4)
        base = st.alloc(16, 0)
        with st.txn(tid=0) as tx:          # spans both shards
            tx.write_bulk(range(base, base + 16), vals)
        rec = {"peeks": [st.peek(base + i) for i in range(16)],
               "seq": st._epoch_seq.load(), "inflight": st._epoch_inflight,
               **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    assert got["peeks"] == vals.tolist()
    assert got["epoch"] == 1               # one cross-shard publish
    assert got["clocks"] == (1, 1)         # each write shard ticked once
    assert got["counters"]["cross_shard_commits"] == 1
    assert got["counters"]["commits"] == 1
    assert got["seq"] == 2 and got["inflight"] is None


def test_shard_cross_commit_conflict_aborts_all_shards():
    def scenario(pkg):
        st = make_store(pkg, 2, span=4)
        base = st.alloc(16, 3)
        tx = st.begin(tid=0)
        tx.write_bulk(range(base, base + 16), np.arange(16))  # both shards
        with st.txn(tid=1) as tx2:
            tx2.write(base + 0, 99)        # stales shard 0's pin
        rec = {"outcome": outcome(pkg, lambda: st.commit(tx)),
               "peeks": [st.peek(base + 0), st.peek(base + 8)],
               "seq": st._epoch_seq.load(), **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    # neither shard published the doomed cross-shard write
    assert got["outcome"] == "abort" and got["peeks"] == [99, 3]
    assert got["epoch"] == 0 and got["seq"] % 2 == 0


def test_shard_cross_read_validates_every_touched_shard():
    """Read one shard, write another: the read shard's pin is validated
    under the locks, so a stale read aborts the commit."""
    def scenario(pkg):
        st = make_store(pkg, 2, span=4)
        base = st.alloc(16, 3)
        tx = st.begin(tid=0)
        v = int(tx.read(base + 0))         # read shard 0
        tx.write(base + 4, v + 1)          # write shard 1
        with st.txn(tid=1) as tx2:
            tx2.write(base + 0, 99)        # invalidate the read
        rec = {"outcome": outcome(pkg, lambda: st.commit(tx)),
               "peek": st.peek(base + 4), **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    assert got["outcome"] == "abort" and got["peek"] == 3


def test_shard_readonly_commit_needs_no_epoch():
    def scenario(pkg):
        st = make_store(pkg, 4, span=4)
        base = st.alloc(32, 9)
        with st.txn(tid=0) as tx:
            got = ints(tx.read_bulk(range(base, base + 32)))  # all shards
        rec = {"got": got, **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    assert got["got"].tolist() == [9] * 32
    assert got["epoch"] == 0 and got["clocks"] == (0, 0, 0, 0)
    assert got["counters"]["ro_commits"] == 1


def test_shard_snapshot_bulk_pinned_vector():
    def scenario(pkg):
        st = make_store(pkg, 2, span=4)
        base = st.alloc(16, 0)
        with st.txn(tid=0) as tx:
            tx.write_bulk(range(base, base + 16), np.arange(16))
        pins = st.clocks                   # the cut right after epoch 1
        addrs = np.arange(base, base + 16)
        pinned, ok1 = st.snapshot_bulk(addrs, list(pins))
        now, ok2 = st.snapshot_bulk(addrs)
        one, ok3 = st.snapshot_bulk(addrs, 1)
        old, ok4 = st.snapshot_bulk(addrs, [0, 1])
        rec = {"pins": pins, "pinned": ints(pinned), "now": ints(now),
               "one": ints(one), "ok": (ok1, ok2, ok3, ok4),
               "old": None if old is None else ints(old),
               **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    assert got["ok"][:3] == (True, True, True)
    for k in ("pinned", "now", "one"):
        np.testing.assert_array_equal(got[k], np.arange(16))


def test_shard_alloc_grows_each_local_heap_to_its_top():
    def scenario(pkg):
        st = make_store(pkg, 3, span=4)
        st.alloc(10, 1)                    # partial span tail
        st.alloc(30, 2)
        top = 40
        for s in range(3):
            sh = st._shards[s]
            have = int(sh._state.live[sh._key].shape[0])
            assert have == st._local_top(s, top)
        rec = {"peeks": [st.peek(a) for a in range(top)], **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    assert got["peeks"][:10] == [1] * 10 and got["peeks"][10:] == [2] * 30


def test_epoch_record_matches_the_reference():
    import dataclasses

    from repro.reliability.recovery import EpochRecord as JRecord
    from repro_torch.reliability.recovery import EpochRecord

    def spec(cls):
        return [(f.name, f.default,
                 f.default_factory() if callable(f.default_factory)
                 else f.default_factory)
                for f in dataclasses.fields(cls)]
    assert repr(spec(EpochRecord)) == repr(spec(JRecord))


@pytest.mark.parametrize("point,nth", [("pre_clock_tick", 1),
                                       ("pre_clock_tick", 2),
                                       ("pre_release", 3)])
def test_crash_mid_epoch_leaves_the_record_parked(point, nth):
    """A crash inside the epoch bracket (before the publish, inside the
    first shard's publish, after the last) leaves the sequence odd and
    the record parked, in both packages alike; evening the sequence by
    hand, as a recovery would after resolving the record, lets
    transactions begin again."""
    from repro.reliability import faultpoints as JFP
    from repro_torch.reliability import faultpoints as TFP

    def scenario(pkg):
        FP = TFP if pkg is PORT else JFP
        st = make_store(pkg, 2, span=4)
        base = st.alloc(16, 3)
        tx = st.begin(tid=0)
        tx.write_bulk(range(base, base + 16), np.arange(16))
        FP.install(FP.FaultSchedule([FP.Fault(point, nth, "kill")]))
        try:
            st.commit(tx)
        except FP.ThreadKilled:
            pass
        finally:
            FP.uninstall()
            FP.reset_thread()
        rec = st._epoch_inflight
        out = {"seq": st._epoch_seq.load(),
               "record": (rec.epoch, rec.write_shards, rec.pins, rec.tid,
                          rec.publish_started, list(rec.published)),
               **observed(st)}
        st._epoch_inflight = None          # the recovery's last step
        st._epoch_seq.increment()
        with st.txn(tid=1) as tx2:
            out["after"] = ints(tx2.read_bulk(range(base, base + 16)))
        st.stop()
        return out
    got = both(scenario)
    assert got["seq"] % 2 == 1
    assert got["record"][1] == (0, 1) and got["epoch"] == 1
    assert got["record"][4] == (nth != 1 or point != "pre_clock_tick")


# ---------------------------------------------------------------------------
# sharded group commit
# ---------------------------------------------------------------------------


def test_shard_batcher_groups_blind_writers_one_tick():
    spans = [0, 2, 4, 6]                   # span index k: shard = k % 2

    def scenario(pkg):
        st = make_store(pkg, 2, span=4, n_threads=8)
        base = st.alloc(64, 0)
        b = pkg.Batcher(st)
        # four span-aligned blind writes, all landing on shard 0
        for t, k in enumerate(spans):
            tx = st.begin(tid=t)
            tx.write_bulk(range(base + 4 * k, base + 4 * k + 4),
                          np.full(4, 100 + t, np.int64))
            b.add(tx)
        rec = {"ok": b.commit_all(), "batcher": dict(b.stats),
               "peeks": [st.peek(base + 4 * k) for k in spans],
               **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    assert got["ok"] == [True] * 4
    assert got["batcher"]["grouped"] == 4 and got["batcher"]["groups"] == 1
    assert got["batcher"]["failed"] == 0
    assert got["clocks"][0] == 1           # ONE tick for the whole group
    assert got["peeks"] == [100, 101, 102, 103]
    assert got["counters"]["commits"] == 4  # four logical commits


def test_shard_batcher_readers_and_cross_shard_fall_back_solo():
    def scenario(pkg):
        st = make_store(pkg, 2, span=4, n_threads=8)
        base = st.alloc(64, 5)
        b = pkg.Batcher(st)
        tx1 = st.begin(tid=0)              # has a read: not blind
        v = int(tx1.read(base + 0))
        tx1.write(base + 0, v + 1)
        tx2 = st.begin(tid=1)              # spans two shards: not blind
        tx2.write_bulk(range(base, base + 16), np.arange(16))
        b.add(tx1)
        b.add(tx2)
        rec = {"ok": b.commit_all(), "batcher": dict(b.stats),
               "peek": st.peek(base + 0), **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    # neither is blind, so neither groups; tx1 commits solo first, which
    # stales tx2's shard-0 pin — exactly the solo path's semantics
    assert got["batcher"]["grouped"] == 0 and got["batcher"]["solo"] == 2
    assert got["ok"][0] is True and got["peek"] == 6


def test_shard_batcher_overlapping_blind_writers_split():
    def scenario(pkg):
        st = make_store(pkg, 2, span=4, n_threads=8)
        base = st.alloc(32, 0)
        b = pkg.Batcher(st)
        for t in range(2):                 # the SAME word: true overlap
            tx = st.begin(tid=t)
            tx.write(base + 0, t + 1)
            b.add(tx)
        rec = {"ok": b.commit_all(), "batcher": dict(b.stats),
               "peek": st.peek(base + 0), **observed(st)}
        st.stop()
        return rec
    got = both(scenario)
    assert got["batcher"]["grouped"] == 0      # overlap -> solo, 2nd aborts
    assert got["ok"] == [True, False] and got["batcher"]["failed"] == 1
    assert got["peek"] == 1                # first writer won, no merge


# ---------------------------------------------------------------------------
# cross-shard serializability (tests/test_shard_serializability.py)
# ---------------------------------------------------------------------------

SPAN = 4
N_BLOCKS = 8                     # block b = span b -> shard b % n_shards
N_WORDS = SPAN * N_BLOCKS


def apply_ref(ref, blocks, shift):
    for b in blocks:
        lo = SPAN * b
        ref[lo:lo + SPAN] = np.roll(ref[lo:lo + SPAN], shift)


def run_schedule(pkg, n_shards, txn_specs, schedule):
    """Drive an interleaved schedule through one package, checking the
    reference harness's three properties inline (committed prefix ==
    single-clock replay, clock monotonicity, a whole snapshot at every
    cut); returns the record the two packages must share: each event's
    outcome, the snapshot after every commit, the clocks and epoch at
    every event boundary."""
    params = pkg.Params(k1=50, k2=500, k3=500, lock_table_bits=8)
    st = pkg.Store(8, n_shards=n_shards, span=SPAN, params=params,
                   start_bg=False, **pkg.kw)
    base = st.alloc(N_WORDS, 0)
    init = np.arange(N_WORDS, dtype=np.int64) * 5 + 3
    with st.txn(tid=0) as tx:
        tx.write_bulk(range(base, base + N_WORDS), init)
    ref = init.copy()
    open_tx, done, events, snaps = {}, set(), [], []
    prev_clocks, prev_epoch = st.clocks, st.epoch
    for ev, i in schedule:
        if i in done:
            continue
        blocks, shift = txn_specs[i]
        what = None
        if ev == "begin":
            if i not in open_tx:
                tid = i % st.n_threads
                st.begin_operation(tid)
                open_tx[i] = [st.begin(tid), False]
                what = "begun"
        elif ev == "exec" and i in open_tx and not open_tx[i][1]:
            tx = open_tx[i][0]
            try:
                for b in blocks:
                    lo = base + SPAN * b
                    vals = ints(tx.read_bulk(range(lo, lo + SPAN)))
                    tx.write_bulk(range(lo, lo + SPAN),
                                  np.roll(vals, shift))
                open_tx[i][1] = True
                what = "executed"
            except pkg.AbortTx:
                del open_tx[i]
                done.add(i)
                what = "exec-abort"
        elif ev == "commit" and i in open_tx and open_tx[i][1]:
            tx = open_tx[i][0]
            del open_tx[i]
            done.add(i)
            try:
                st.commit(tx)
                what = "committed"
            except pkg.AbortTx:
                what = "commit-abort"
            if what == "committed":
                apply_ref(ref, blocks, shift)
                snap, ok = st.snapshot_bulk(np.arange(base,
                                                      base + N_WORDS))
                assert ok, "whole-heap snapshot at the current cut failed"
                snap = ints(snap)
                np.testing.assert_array_equal(
                    snap, ref, err_msg=f"committed prefix diverged after "
                                       f"txn {i}")
                snaps.append(snap)
        clocks, epoch = st.clocks, st.epoch
        assert all(c >= p for c, p in zip(clocks, prev_clocks))
        assert epoch >= prev_epoch
        prev_clocks, prev_epoch = clocks, epoch
        events.append((ev, i, what, clocks, epoch))
    for slot in open_tx.values():          # abandon whatever never committed
        st.abort(slot[0])
    snap, ok = st.snapshot_bulk(np.arange(base, base + N_WORDS))
    assert ok
    np.testing.assert_array_equal(ints(snap), ref)
    rec = {"events": events, "snaps": snaps, **observed(st)}
    st.stop()
    return rec


def both_schedules(n_shards, specs, schedule) -> int:
    """The schedule through both packages; returns the number of
    committed transactions."""
    got = both(run_schedule, n_shards, specs, schedule)
    return sum(1 for e in got["events"] if e[2] == "committed")


def random_case(r):
    n_shards = r.choice((1, 2, 4))
    n_txns = r.randrange(2, 8)
    specs = []
    for _ in range(n_txns):
        k = r.randrange(1, 4)              # 1 block = single-shard;
        blocks = r.sample(range(N_BLOCKS), k)   # >1 may span shards
        specs.append((tuple(blocks), 1 + r.randrange(SPAN - 1)))
    events = []
    for i in range(n_txns):
        events += [("begin", i), ("exec", i), ("commit", i)]
    r.shuffle(events)
    return n_shards, specs, events


@pytest.mark.parametrize("seed", range(12))
def test_shard_serializable_committed_prefix_seeded(seed):
    r = random.Random(1000 + seed)
    both_schedules(*random_case(r))


def test_shard_serializable_interleaved_cross_shard_pair():
    """Two cross-shard rotations pinned before either commits — the
    second MUST abort (their footprints overlap on a shard)."""
    specs = [((0, 1), 1), ((1, 2), 2)]
    schedule = [("begin", 0), ("begin", 1), ("exec", 0), ("exec", 1),
                ("commit", 0), ("commit", 1)]
    assert both_schedules(2, specs, schedule) == 1


def test_shard_serializable_disjoint_cross_pairs_both_commit():
    """Two cross-shard rotations on DISJOINT shard sets interleaved:
    both commit (a store-wide clock would abort the second)."""
    specs = [((0, 1), 1), ((2, 3), 2)]
    schedule = [("begin", 0), ("begin", 1), ("exec", 0), ("exec", 1),
                ("commit", 0), ("commit", 1)]
    assert both_schedules(4, specs, schedule) == 2


def test_shard_serializable_many_seeds_high_contention():
    """A denser sweep: more txns over fewer blocks, all shard counts."""
    for seed in range(8):
        r = random.Random(7000 + seed)
        n_txns = r.randrange(4, 10)
        specs = [(tuple(r.sample(range(4), r.randrange(1, 3))),
                  1 + r.randrange(SPAN - 1)) for _ in range(n_txns)]
        events = []
        for i in range(n_txns):
            events += [("begin", i), ("exec", i), ("commit", i)]
        r.shuffle(events)
        both_schedules(r.choice((1, 2, 4)), specs, events)


def test_shard_serializable_committed_prefix_property():
    """Generator-driven twin of the seeded sweep, through both
    packages."""
    hypothesis = pytest.importorskip("hypothesis")
    st_mod = pytest.importorskip("hypothesis.strategies")

    @st_mod.composite
    def schedules(draw):
        n_shards = draw(st_mod.sampled_from((1, 2, 4)))
        n_txns = draw(st_mod.integers(2, 6))
        specs = []
        for _ in range(n_txns):
            blocks = draw(st_mod.lists(
                st_mod.integers(0, N_BLOCKS - 1), min_size=1,
                max_size=3, unique=True))
            specs.append((tuple(blocks),
                          draw(st_mod.integers(1, SPAN - 1))))
        events = [ev for i in range(n_txns)
                  for ev in (("begin", i), ("exec", i), ("commit", i))]
        events = draw(st_mod.permutations(events))
        return n_shards, specs, events

    @hypothesis.given(schedules())
    @hypothesis.settings(max_examples=40, deadline=None)
    def prop(case):
        both_schedules(*case)

    prop()
