"""The port's MVStore (``core/mvstore.py``, ``core/mvcontroller.py``,
``api/mvhandle.py``) against the JAX package's.

* ``mv_*`` parity: the same seeded sequence of inits, whole-store
  commits, fused sparse commits, (un)versioning and snapshots gives the
  same blocks, rings, timestamps, clocks and verdicts in both packages;
  every versioned snapshot goes through the ``snapshot_select`` wrapper,
  whatever ``impl`` names.
* The cases of ``tests/test_mvstore.py`` hold on the port.
* ``MVStoreHandle``: a seeded two-tid schedule gives the same trace,
  counters, block and clock as the reference's handle.
* The reader rule: the live block is published out of place, and a ring
  read that a slot refresh overtook aborts (or retries outside a
  transaction) instead of returning a row of another version.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as J
from repro.configs.base import MVStoreConfig as JCfg
from repro.configs.paper_stm import MultiverseParams as JParams
from repro.core import mvcontroller as JC
from repro.core import mvstore as JM
from repro_torch import api as T
from repro_torch.api import mvhandle as TH
from repro_torch.configs.base import MVStoreConfig as TCfg
from repro_torch.configs.paper_stm import MultiverseParams as TParams
from repro_torch.core import modes as M
from repro_torch.core import mvcontroller as TC
from repro_torch.core import mvstore as TM


def _tree_np(rng):
    return {"a": rng.standard_normal((4, 4)).astype(np.float32),
            "b": {"w": rng.standard_normal(8).astype(np.float32)},
            "heap": rng.integers(-1000, 1000, 64).astype(np.int32)}


def _to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    """Leaves in path order (sorted keys), as numpy."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _same_state(js, ts):
    assert int(js.clock) == ts.clock
    assert {k: int(v) for k, v in js.block_clocks.items()} == ts.block_clocks
    assert set(js.ring) == set(ts.ring) and set(js.ring_ts) == set(ts.ring_ts)
    for k in js.ring:
        np.testing.assert_array_equal(ts.ring[k].numpy(),
                                      np.asarray(js.ring[k]))
        np.testing.assert_array_equal(ts.ring_ts[k].numpy(),
                                      np.asarray(js.ring_ts[k]))
    for a, b in zip(_leaves(js.live), _leaves(ts.live)):
        np.testing.assert_array_equal(b.numpy() if isinstance(
            b, torch.Tensor) else b, a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mv_parity(seed):
    rng = np.random.default_rng(seed)
    ring_slots = int(rng.integers(2, 5))
    jcfg, tcfg = JCfg(ring_slots=ring_slots), TCfg(ring_slots=ring_slots)
    init = _tree_np(rng)
    versioned = ["none", "all", frozenset({"['a']", "['heap']"})][seed]
    js = JM.mv_init(_to_j(init), jcfg, versioned=versioned)
    ts = TM.mv_init(_to_t(init), tcfg, versioned=versioned)
    assert TM.block_paths(ts.live) == JM.block_paths(js.live)
    for step in range(8):
        op = int(rng.integers(0, 4))
        if op == 0:
            new = _tree_np(rng)
            mode = "U" if set(js.ring) == set(JM.block_paths(js.live)) \
                else "Q"
            js = JM.mv_commit(js, _to_j(new), local_mode=mode, cfg=jcfg)
            ts = TM.mv_commit(ts, _to_t(new), local_mode=mode, cfg=tcfg)
        elif op == 1:
            k = int(rng.integers(1, 6))
            addrs = rng.choice(64, k, replace=False)
            vals = rng.integers(-5000, 5000, k)
            mode = "U" if "['heap']" in js.ring else "Q"
            js = JM.mv_commit_fused(js, "heap", addrs, vals, local_mode=mode,
                                    cfg=jcfg)
            ts = TM.mv_commit_fused(ts, "heap", addrs, vals,
                                    local_mode=mode, cfg=tcfg)
        elif op == 2:
            paths = set(rng.choice(JM.block_paths(js.live), 2,
                                   replace=False).tolist())
            first = None if rng.random() < 0.5 else int(js.clock)
            js = JM.version_blocks(js, paths, jcfg, first)
            ts = TM.version_blocks(ts, paths, tcfg, first)
        else:
            paths = set(rng.choice(JM.block_paths(js.live), 1).tolist())
            js = JM.unversion_blocks(js, paths)
            ts = TM.unversion_blocks(ts, paths)
        _same_state(js, ts)
        for rc in range(int(js.clock) + 1):
            for av in (False, True):
                jv, jok = JM.mv_snapshot(js, rc, assume_versioned=av)
                tv, tok = TM.mv_snapshot(ts, rc, assume_versioned=av)
                assert bool(tok) == bool(jok)
                for a, b in zip(_leaves(jv), _leaves(tv)):
                    np.testing.assert_array_equal(b, a)
        assert TM.blocks_conflict(ts, ["['heap']"], 0) == \
            JM.blocks_conflict(js, ["['heap']"], 0)
        assert TM.ring_bytes(ts) == JM.ring_bytes(js)


def test_mv_commit_fused_checks_bounds_and_mode():
    cfg = TCfg(ring_slots=2)
    st = TM.mv_init({"heap": torch.zeros(8, dtype=torch.int32)}, cfg)
    for bad in ([-1], [8]):
        with pytest.raises(IndexError):
            TM.mv_commit_fused(st, "heap", bad, [1], local_mode="Q", cfg=cfg)
    with pytest.raises(ValueError):
        TM.mv_commit_fused(st, "heap", [1], [1], local_mode="U", cfg=cfg)
    assert st.clock == 0 and st.live["heap"].tolist() == [0] * 8


# ---------------------------------------------------------------------------
# tests/test_mvstore.py, on the port
# ---------------------------------------------------------------------------


def _tree(scale=1.0):
    return {"a": torch.full((4, 4), scale, dtype=torch.float32),
            "b": {"w": torch.full((8,), 2 * scale, dtype=torch.float32)}}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_snapshot_always_takes_the_kernel_wrapper(monkeypatch, impl):
    calls = []
    real = TM.SS.snapshot_select

    def spy(ring, ts, read_clock):
        calls.append(read_clock)
        return real(ring, ts, read_clock)
    monkeypatch.setattr(TM.SS, "snapshot_select", spy)
    cfg = TCfg(ring_slots=2, mode="U")
    st = TM.mv_init(_tree(1.0), cfg, versioned="all")
    st = TM.mv_commit(st, _tree(2.0), local_mode="U", cfg=cfg)
    view, ok = TM.mv_snapshot(st, read_clock=1, impl=impl)
    assert bool(ok) and bool((view["a"] == 2.0).all())
    assert calls == [1] * len(st.ring)
    h = TH.MVStoreHandle(1, cfg=cfg, start_bg=False, versioned="all",
                         device="cpu")
    try:
        h.alloc(4, 3)
        calls.clear()
        h.snapshot()
        assert h.state.ring and calls == [int(h.clock)] * len(h.state.ring)
    finally:
        h.stop()


def test_mode_q_commit_and_reader_abort():
    cfg = TCfg(ring_slots=2, mode="Q")
    st = TM.mv_init(_tree(), cfg, versioned="none")
    st = TM.mv_commit(st, _tree(2.0), local_mode="Q", cfg=cfg)
    assert st.clock == 1 and not st.ring
    view, ok = TM.mv_snapshot(st, read_clock=1)
    assert bool(ok) and bool((view["a"] == 2.0).all())
    _, ok = TM.mv_snapshot(st, read_clock=0)     # began before the commit
    assert not bool(ok)
    with pytest.raises(ValueError):              # Mode U needs rings
        TM.mv_commit(st, _tree(3.0), local_mode="U", cfg=cfg)


def test_mode_u_versions_and_ring_overflow():
    cfg = TCfg(ring_slots=2, mode="U")
    st = TM.mv_init(_tree(1.0), cfg, versioned="all")
    st = TM.mv_commit(st, _tree(2.0), local_mode="U", cfg=cfg)
    st = TM.mv_commit(st, _tree(3.0), local_mode="U", cfg=cfg)
    view, ok = TM.mv_snapshot(st, read_clock=1)
    assert bool(ok) and bool((view["a"] == 2.0).all())
    view, ok = TM.mv_snapshot(st, read_clock=2)
    assert bool(ok) and bool((view["a"] == 3.0).all())
    for i in range(2):
        st = TM.mv_commit(st, _tree(float(i)), local_mode="U", cfg=cfg)
    assert not bool(TM.mv_snapshot(st, read_clock=1)[1])
    assert bool(TM.mv_snapshot(st, read_clock=3)[1])
    st = TM.unversion_blocks(st, set(TM.block_paths(st.live)))
    assert TM.ring_bytes(st) == 0


def test_partial_versioning_mode_q():
    """Only requested blocks get rings (``versioned_paths`` names them);
    a snapshot mixes ring reads and validated live reads; in both
    packages."""
    cfg = TCfg(ring_slots=2, mode="Q")
    st = TM.mv_init(_tree(), cfg, versioned="none")
    paths = [p for p in TM.block_paths(st.live) if "a" in p]
    assert TM.resolve_versioned(st.live, set(paths)) == frozenset(paths)
    assert TM.resolve_versioned(st.live, "all") == \
        frozenset(TM.block_paths(st.live))
    st = TM.version_blocks(st, set(paths), cfg)
    assert TM.versioned_paths(st) == frozenset(paths)
    st = TM.mv_commit(st, _tree(5.0), local_mode="Q", cfg=cfg)
    # reading at clock 0: 'a' resolves via the ring (old version), but
    # the unversioned 'b' fails validation -> the reader aborts
    _, ok = TM.mv_snapshot(st, read_clock=0)
    assert not bool(ok)
    view, ok = TM.mv_snapshot(st, read_clock=1)
    assert bool(ok) and bool((view["a"] == 5.0).all())

    jcfg = JCfg(ring_slots=2, mode="Q")
    js = JM.mv_init(_to_j({"a": np.ones((4, 4), np.float32),
                           "b": {"w": np.full(8, 2.0, np.float32)}}),
                    jcfg, versioned="none")
    assert JM.block_paths(js.live) == TM.block_paths(_tree())
    assert JM.resolve_versioned(js.live, set(paths)) == frozenset(paths)
    js = JM.version_blocks(js, set(paths), jcfg)
    assert JM.versioned_paths(js) == TM.versioned_paths(st)


def test_controller_full_mode_cycle():
    """The reference's synchronous walk Q -> QtoU -> U -> UtoQ -> Q."""
    params = TParams(k1=1, k2=1, k3=1, s=1)
    ctl = TC.MVController(params=params, mvcfg=TCfg(ring_slots=2),
                          start_bg=False)
    cfg = ctl.mvcfg
    st = TM.mv_init(_tree(), cfg, versioned="none")
    reader = ctl.reader()
    st = ctl.trainer_tick(st)
    for _ in range(4):
        reader.begin(st.clock)
        st = TM.mv_commit(st, _tree(2.0),
                          local_mode=ctl.current_local_mode(), cfg=cfg)
        st = ctl.trainer_tick(st)
        reader.on_abort(2)
    assert ctl.mode != M.MODE_Q
    for _ in range(20):
        if ctl.mode == M.MODE_U:
            break
        st = ctl.trainer_tick(st)
        st = TM.mv_commit(st, _tree(3.0),
                          local_mode=ctl.current_local_mode(), cfg=cfg)
        reader.begin(st.clock)
        ctl.step_once()
    assert ctl.mode == M.MODE_U
    assert len(st.ring) == len(TM.block_paths(st.live))
    for _ in range(20):
        if ctl.mode == M.MODE_Q:
            break
        reader.begin(st.clock)
        TM.mv_snapshot(st, read_clock=st.clock, assume_versioned=True)
        reader.on_commit(1, st.clock)
        st = ctl.trainer_tick(st)
        ctl.step_once()
    assert ctl.mode == M.MODE_Q
    ctl.stop()


def test_controller_stale_unversioning_matches_reference():
    jcfg, tcfg = JCfg(ring_slots=2), TCfg(ring_slots=2)
    js = JM.mv_init(_to_j(_tree_np(np.random.default_rng(0))), jcfg,
                    versioned="all")
    ts = TM.mv_init(_to_t(_tree_np(np.random.default_rng(0))), tcfg,
                    versioned="all")
    for pending, clock in (({"__stale_older_than:0.5"}, None),
                           ({"__stale_older_than:50"}, 100),
                           ({"['a']"}, None)):
        if clock is not None:
            js = js._replace(clock=jnp.asarray(clock, jnp.int32))
            ts = ts._replace(clock=clock)
        assert TC.apply_stale_unversioning(ts, pending) == \
            JC.apply_stale_unversioning(js, pending)


# ---------------------------------------------------------------------------
# MVStoreHandle: seeded schedules, both packages
# ---------------------------------------------------------------------------


def _handle(pkg, n_threads=2, ring_slots=4):
    if pkg is J:
        return J.make_tm("mvstore", n_threads, ring_slots=ring_slots,
                         start_bg=False,
                         params=JParams(k1=2, k2=6, k3=6))
    return T.make_tm("mvstore", n_threads, ring_slots=ring_slots,
                     start_bg=False, device="cpu",
                     params=TParams(k1=2, k2=6, k3=6))


def _schedule(tm, AbortTx, seed, steps=160, region=96):
    """Two tids from one thread: chunked scans (24 words a step) beside
    whole-in-one-step transfers, block rotations and out-of-transaction
    ``snapshot_bulk`` reads at past clocks.  Returns the trace."""
    base = tm.alloc(region, 10)
    rng = random.Random(seed)
    trace, scan = [], {}
    for _ in range(steps):
        tid = rng.randrange(2)
        r = rng.random()
        if tid not in scan and r < 0.15:
            rc = max(0, tm.clock - rng.randrange(6))
            vals, ok = tm.snapshot_bulk(range(base, base + region), rc)
            trace.append((tid, "snap", rc, bool(ok),
                          None if vals is None else
                          [int(v) for v in vals]))
            continue
        if tid not in scan and r < 0.55:
            tm.begin_operation(tid)
            tx = tm.begin(tid)
            try:
                if rng.random() < 0.5:
                    i, j = rng.sample(range(region), 2)
                    a, b = tx.read(base + i), tx.read(base + j)
                    tx.write(base + i, a - 5)
                    tx.write(base + j, b + 5)
                    got = (int(a), int(b))
                else:
                    off = base + 32 * rng.randrange(3)
                    vals = [int(v) for v in tx.read_bulk(
                        range(off, off + 32))]
                    tx.write_bulk(range(off, off + 32),
                                  vals[-1:] + vals[:-1])
                    got = sum(vals)
                tm.commit(tx)
                trace.append((tid, "update", got))
            except AbortTx:
                tm.abort(tx)
                trace.append((tid, "update-abort"))
            continue
        if tid not in scan:
            tm.begin_operation(tid)
            scan[tid] = None
        if scan[tid] is None:
            scan[tid] = [tm.begin(tid), 0, 0]
        tx, off, acc = scan[tid]
        try:
            if off == region:
                tm.commit(tx)
                trace.append((tid, "scan", acc, tx._ctx.versioned))
                del scan[tid]
                continue
            vals = [int(v) for v in tx.read_bulk(
                range(base + off, base + off + 24))]
            scan[tid] = [tx, off + 24, acc + sum(vals)]
            trace.append((tid, "chunk", sum(vals)))
        except AbortTx:
            tm.abort(tx)
            scan[tid] = None
            trace.append((tid, "scan-abort"))
    for st in scan.values():
        if st is not None:
            tm.abort(st[0])
    return trace


@pytest.mark.parametrize("seed", [2, 9, 10])
def test_handle_schedule_parity(seed):
    jtm, ttm = _handle(J), _handle(T)
    jtr = _schedule(jtm, J.AbortTx, seed)
    ttr = _schedule(ttm, T.AbortTx, seed)
    assert ttr == jtr
    assert ttm.stats() == jtm.stats()
    js, ts = jtm.state, ttm.state
    _same_state(js, ts)
    kinds = {t[1] for t in ttr}
    assert {"update", "scan", "snap"} <= kinds
    assert ttm.stats()["versioned_commits"] > 0
    assert any(t[1] == "snap" and t[3] and t[2] < ttm.clock for t in ttr)
    jtm.stop()
    ttm.stop()


def test_handle_snapshot_bulk_serves_past_clock():
    tm = _handle(T)
    base = tm.alloc(40, 3)
    tx = tm.begin(1)
    tx._ctx.versioned = True
    old = [int(v) for v in tx.read_bulk(range(base, base + 40))]
    tm.commit(tx)
    clock0 = tm.clock
    T.run(tm, lambda t: t.write(base + 1, 77), tid=0)
    vals, ok = tm.snapshot_bulk(range(base, base + 40))
    assert ok and int(vals[1]) == 77 and vals.dtype == torch.int32
    stale, ok = tm.snapshot_bulk(range(base, base + 40), read_clock=clock0)
    assert ok and [int(v) for v in stale] == old == [3] * 40
    view, ok = tm.snapshot(clock0)
    assert bool(ok) and view["heap"][base + 1].item() == 3
    tm.stop()


# ---------------------------------------------------------------------------
# the reader rule
# ---------------------------------------------------------------------------


def test_live_block_is_published_out_of_place():
    tm = _handle(T)
    base = tm.alloc(16, 1)
    held = tm._snap[1]                  # a reader's snapshot of the block
    T.run(tm, lambda t: t.write_bulk(range(base, base + 16), [9] * 16),
          tid=0)
    assert held.tolist() == [1] * 16
    assert tm._snap[1] is not held and tm.peek(base) == 9
    tm.stop()


def _overtake_with_refresh(tm, base, n_commits):
    """A ``gather_row`` that, between the reader's slot pick and its
    gather, lets a writer commit ``n_commits`` times (each refreshing a
    ring slot in place) — the race the seqlock must catch."""
    real = TH.gather_row
    state = {"armed": True}

    def racing(row, addrs):
        if state["armed"]:
            state["armed"] = False
            for k in range(n_commits):
                T.run(tm, lambda t, k=k: t.write(base, 100 + k), tid=0)
        return real(row, addrs)
    return racing


@pytest.mark.parametrize("path", ["read_bulk", "snapshot_bulk"])
def test_ring_read_overtaken_by_a_refresh_never_mixes(monkeypatch, path):
    """Between a versioned reader's slot pick and its gather, a writer
    commits a full ring's worth of times, refreshing the slot the
    reader picked: the transactional read aborts, and the read outside a
    transaction retries and finds its clock out of the window — neither
    returns the row of a newer version."""
    ring_slots = 4
    tm = _handle(T, ring_slots=ring_slots)
    base = tm.alloc(8, 5)
    tx = tm.begin(1)
    tx._ctx.versioned = True
    tx.read_bulk(range(base, base + 8))  # versions the block at clock 0
    tm.commit(tx)
    T.run(tm, lambda t: t.write(base, 6), tid=0)        # clock 1
    rc = tm.clock
    T.run(tm, lambda t: t.write(base, 7), tid=0)        # rc is the past
    monkeypatch.setattr(TH, "gather_row",
                        _overtake_with_refresh(tm, base, ring_slots))
    if path == "snapshot_bulk":
        assert tm.snapshot_bulk(range(base, base + 8), read_clock=rc) == \
            (None, False)
    else:
        tm.begin_operation(1)
        tx = tm.begin(1)
        tx._ctx.versioned = True
        tx._ctx.read_clock = rc
        with pytest.raises(T.AbortTx):
            tx.read_bulk(range(base, base + 8))
    assert tm.clock == rc + 1 + ring_slots
    tm.stop()


def test_ring_read_not_overtaken_returns_the_snapshot():
    tm = _handle(T, ring_slots=4)
    base = tm.alloc(8, 5)
    tx = tm.begin(1)
    tx._ctx.versioned = True
    tx.read_bulk(range(base, base + 8))
    tm.commit(tx)
    T.run(tm, lambda t: t.write(base, 6), tid=0)
    rc = tm.clock
    T.run(tm, lambda t: t.write(base, 7), tid=0)        # another slot
    vals, ok = tm.snapshot_bulk(range(base, base + 8), read_clock=rc)
    assert ok and vals.tolist() == [6] + [5] * 7
    tm.stop()
