"""The port's crash recovery (``reliability/recovery.py``, the commit
pipelines' fault points, ``MVStoreHandle._inflight``, the sharded
store's epoch record) against the JAX package's.

Every case of ``tests/test_crash_matrix.py`` runs through both packages
on the same inputs: the crash image and the recovered state — heap, lock
words, clock, PackedVLT mirror rows, MVStore blocks, rings and ring
timestamps, shard clocks and epoch — and the whole ``RecoveryReport``
must be equal, and the reference test's own assertions must hold on the
port.  Where a case writes a log, the two packages' segment files must
be byte-identical.  The port runs on the CPU (``device="cpu"``); its
word engines keep their heap in an ``ArrayHeap`` (the card's layout: a
replay is a ``scatter_write`` call), and the solo crash matrix runs
again on the port's object heap.  A fault point that is off a pipeline's
path (the reference test skips) must stay unfired in both packages.

Two cases are the port's own: its ring slot is refreshed in place by
the ``commit_fused`` call, so a kill at ``post_scatter`` must complete
the install from ``_inflight``, and a kill at ``pre_scatter`` (host ring
timestamp already invalidated, the card's not yet refreshed) must leave
the host copy equal to the card's again.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from repro.api.mvhandle import MVStoreHandle as JMVStore
from repro.api.substrate import run as j_run
from repro.core.baselines import DCTL as JDCTL
from repro.core.baselines import TL2 as JTL2
from repro.core.baselines import TinySTM as JTinySTM
from repro.core.engine.groupcommit import CommitBatcher as JBatcher
from repro.core.shardstore import ShardStoreHandle as JShardStore
from repro.core.stm import Multiverse as JMultiverse
from repro.reliability import faultpoints as JFP
from repro.reliability import recovery as JREC
from repro.reliability import wal as JWAL
from repro_torch.api.mvhandle import MVStoreHandle as TMVStore
from repro_torch.api.substrate import run as t_run
from repro_torch.core.baselines import DCTL as TDCTL
from repro_torch.core.baselines import TL2 as TTL2
from repro_torch.core.baselines import TinySTM as TTinySTM
from repro_torch.core.engine import ArrayHeap
from repro_torch.core.engine.groupcommit import CommitBatcher as TBatcher
from repro_torch.core.mvstore import NO_TS
from repro_torch.core.shardstore import ShardStoreHandle as TShardStore
from repro_torch.core.stm import Multiverse as TMultiverse
from repro_torch.reliability import faultpoints as TFP
from repro_torch.reliability import recovery as TREC
from repro_torch.reliability import wal as TWAL

N = 300          # >= BULK_MIN, as in the reference matrix

POINTS = ("pre_claim", "post_claim", "pre_clock_tick",
          "pre_scatter", "post_scatter", "pre_release")
MV_POINTS = ("pre_clock_tick", "pre_scatter", "post_scatter", "pre_release")
SHARD_EPOCH_CASES = [
    ("pre_claim", 1, None),
    ("pre_clock_tick", 1, False),
    ("pre_scatter", 1, True),
    ("pre_scatter", 2, True),
    ("pre_release", 3, True),
]


def _port_word(cls, heap):
    def make(n, **kw):
        h = ArrayHeap(device="cpu") if heap == "array" else None
        return cls(n, heap=h, device="cpu", **kw)
    return make


def _port(heap="array"):
    return types.SimpleNamespace(
        name=f"torch-{heap}", FP=TFP, REC=TREC, WAL=TWAL, run=t_run,
        Batcher=TBatcher,
        word={"multiverse": lambda n: _port_word(TMultiverse, heap)(
                  n, start_bg=False),
              "tl2": _port_word(TTL2, heap),
              "dctl": _port_word(TDCTL, heap),
              "tinystm": _port_word(TTinySTM, heap)},
        store=lambda: TMVStore(n_threads=2, versioned="all",
                               start_bg=False, device="cpu"),
        shards=lambda: TShardStore(2, n_shards=2, span=4, start_bg=False,
                                   device="cpu"))


JAX = types.SimpleNamespace(
    name="jax", FP=JFP, REC=JREC, WAL=JWAL, run=j_run, Batcher=JBatcher,
    word={"multiverse": lambda n: JMultiverse(n, start_bg=False),
          "tl2": JTL2, "dctl": JDCTL, "tinystm": JTinySTM},
    store=lambda: JMVStore(n_threads=2, versioned="all", start_bg=False),
    shards=lambda: JShardStore(2, n_shards=2, span=4, start_bg=False))
PORT = _port("array")
PORT_OBJECT = _port("object")


@pytest.fixture(autouse=True)
def _no_leftover_schedule():
    yield
    for fp in (JFP, TFP):
        fp.uninstall()
        fp.reset_thread()


# ---------------------------------------------------------------------------
# records and their comparison
# ---------------------------------------------------------------------------


def ints(x) -> np.ndarray:
    """A copy of ``x`` as a host int64 array (the reference's state is
    numpy arrays that later commits mutate in place)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(np.int64)
    return np.array(x, np.int64)


def heap_words(tm, n):
    eng = getattr(tm, "raw", tm)
    live = getattr(eng.heap, "live", None)
    if live is not None:
        return ints(live()[:n])
    return np.array([eng.heap[i] for i in range(n)], np.int64)


def word_state(tm, n):
    """Heap prefix, lock words, clock and (Multiverse) mirror rows."""
    eng = getattr(tm, "raw", tm)
    out = {"heap": heap_words(tm, n), "locks": ints(eng.locks._words),
           "clock": int(eng.clock.load())}
    mirror = getattr(getattr(eng.policy, "vlt", None), "mirror", None)
    if mirror is not None:
        out["mirror"] = [ints(a) for a in (mirror._seq, mirror._addr,
                                           mirror._ts, mirror._data)]
    return out


def store_state(h):
    """An MVStore handle's clock, block, ring and ring timestamps."""
    s = h._state
    out = {"clock": int(s.clock), "heap": ints(s.live["heap"]),
           "inflight": h._inflight is not None}
    for k in s.ring:
        out["ring"] = ints(s.ring[k])
        out["ring_ts"] = ints(s.ring_ts[k])
    return out


def shard_state(st):
    return {"epoch": int(st._epoch.load()),
            "epoch_seq": int(st._epoch_seq.load()),
            "shards": [store_state(sh) for sh in st._shards]}


def report(rep):
    return dataclasses.asdict(rep)


def same(a, b, path="record"):
    """Deep equality of two records holding numpy arrays."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def both(scenario, *args, port=PORT):
    """``scenario(pkg, *args)`` through both packages; the records must be
    equal.  Returns the port's record."""
    want = scenario(JAX, *args)
    JFP.uninstall()
    JFP.reset_thread()
    got = scenario(port, *args)
    same(want, got)
    return got


def seg_bytes(path):
    """Every segment file of a log directory, in order, as bytes."""
    return [open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path)) if n.endswith(".seg")]


def walled(tmp_path, pkg):
    d = tmp_path / pkg.name
    d.mkdir(exist_ok=True)
    return str(d)


# ---------------------------------------------------------------------------
# the reference matrix's building blocks, package-neutral
# ---------------------------------------------------------------------------


def committed_write(pkg, tm, base):
    def w0(tx):
        tx.write_bulk(np.arange(base, base + N), list(range(N)))
    pkg.run(tm, w0, tid=0)


def crashing_write(pkg, tm, tid):
    def w1(tx):
        tx.write_bulk(np.arange(N), [v + 1000 for v in range(N)])
    pkg.run(tm, w1, tid=tid)


def solo_case(pkg, backend, point):
    """``_run_solo_case`` / ``test_crash_solo_commit``: a committed prefix,
    a kill at ``point`` in tid 1's commit, recovery, then a commit that
    must go through."""
    FP = pkg.FP
    tm = pkg.word[backend](2)
    base = tm.alloc(N, 0)
    committed_write(pkg, tm, base)
    clock0 = tm.clock.load()
    sched = FP.install(FP.FaultSchedule([FP.Fault(point, 1, "kill")]))
    crashed = False
    try:
        crashing_write(pkg, tm, 1)
    except FP.SimulatedCrash:
        crashed = True
    FP.uninstall()
    out = {"crashed": crashed, "fired": list(sched.fired)}
    if not crashed:
        out["violations"] = pkg.REC.check_engine_invariants(
            tm, clock_at_least=clock0)
        out["state"] = word_state(tm, N)
        FP.reset_thread()
        return out
    out["decided"] = bool(tm.ctx(1).publish_started)
    out["crash_image"] = word_state(tm, N)
    out["report"] = report(pkg.REC.recover_engine(tm, [1]))
    out["violations"] = pkg.REC.check_engine_invariants(
        tm, clock_at_least=clock0)
    out["recovered"] = word_state(tm, N)

    def w2(tx):
        tx.write_bulk(np.arange(8), [7] * 8)
    pkg.run(tm, w2, tid=1)
    out["after"] = word_state(tm, N)
    return out


def check_solo(rec):
    """The reference test's assertions, on one package's record."""
    if not rec["crashed"]:
        assert rec["fired"] == [] and rec["violations"] == []
        return
    assert rec["violations"] == []
    want = (np.arange(N) + 1000 if rec["decided"] else np.arange(N))
    np.testing.assert_array_equal(rec["recovered"]["heap"], want)
    if rec["decided"]:
        assert rec["report"]["rolled_forward"] == [1]
    np.testing.assert_array_equal(rec["after"]["heap"][:8], [7] * 8)


# ---------------------------------------------------------------------------
# solo commit pipeline: every backend x every commit-path fault point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dctl", "multiverse", "tinystm", "tl2"])
@pytest.mark.parametrize("point", POINTS)
def test_crash_solo_commit(backend, point):
    check_solo(both(solo_case, backend, point))


@pytest.mark.parametrize("backend", ["dctl", "multiverse", "tinystm", "tl2"])
@pytest.mark.parametrize("point", POINTS)
def test_crash_solo_commit_object_heap(backend, point):
    check_solo(both(solo_case, backend, point, port=PORT_OBJECT))


@pytest.mark.parametrize("backend,point", [
    ("multiverse", "pre_release"),
    ("multiverse", "pre_claim"),
    ("tl2", "post_claim"),
    ("tl2", "pre_release"),
    ("dctl", "pre_scatter"),
])
def test_crash_quick_solo(backend, point):
    rec = both(solo_case, backend, point)
    assert rec["crashed"] and rec["fired"][0][0] == point
    check_solo(rec)


# ---------------------------------------------------------------------------
# group commit pipeline
# ---------------------------------------------------------------------------


def group_case(pkg, backend, point):
    FP = pkg.FP
    tm = pkg.word[backend](4)
    n_members = 3
    base = tm.alloc(n_members * N, 0)
    txs = []
    for t in range(n_members):
        tx = tm.begin(t)
        a = np.arange(base + t * N, base + (t + 1) * N)
        tx.write_bulk(a, [t * 10000 + i for i in range(N)])
        txs.append(tx)
    clock0 = tm.clock.load()
    batcher = pkg.Batcher(tm)
    for tx in txs:
        batcher.add(tx)
    sched = FP.install(FP.FaultSchedule([FP.Fault(point, 1, "kill")]))
    crashed = False
    try:
        batcher.commit_all()
    except FP.SimulatedCrash:
        crashed = True
    FP.uninstall()
    out = {"crashed": crashed, "fired": list(sched.fired)}
    if not crashed:
        out["state"] = word_state(tm, n_members * N)
        return out
    out["decided"] = [bool(tm.ctx(t).publish_started)
                      for t in range(n_members)]
    out["crash_image"] = word_state(tm, n_members * N)
    out["report"] = report(pkg.REC.recover_engine(tm,
                                                  list(range(n_members))))
    out["violations"] = pkg.REC.check_engine_invariants(
        tm, clock_at_least=clock0)
    out["recovered"] = word_state(tm, n_members * N)
    return out


def check_group(rec):
    if not rec["crashed"]:
        assert rec["fired"] == []       # off this pipeline's path
        return
    assert rec["violations"] == []
    exp = np.concatenate([
        np.arange(N) + t * 10000 if rec["decided"][t]
        else np.zeros(N, np.int64) for t in range(3)])
    np.testing.assert_array_equal(rec["recovered"]["heap"], exp)
    assert rec["report"]["dead_tids"] == [0, 1, 2]


@pytest.mark.parametrize("point", POINTS)
def test_crash_group_buffered(point):
    check_group(both(group_case, "tl2", point))


@pytest.mark.parametrize("point", ("pre_clock_tick", "pre_release"))
def test_crash_group_encounter(point):
    check_group(both(group_case, "dctl", point))


# ---------------------------------------------------------------------------
# MVStore fused publish
# ---------------------------------------------------------------------------


def mvstore_case(pkg, point):
    FP = pkg.FP
    h = pkg.store()
    h.alloc(32, 0)

    def w0(tx):
        tx.write_bulk(np.arange(32), list(range(32)))
    pkg.run(h, w0, tid=0)
    clock0 = h.clock
    sched = FP.install(FP.FaultSchedule([FP.Fault(point, 1, "kill")]))
    crashed = False
    try:
        def w1(tx):
            tx.write_bulk(np.arange(32), [v + 100 for v in range(32)])
        pkg.run(h, w1, tid=1)
    except FP.SimulatedCrash:
        crashed = True
    FP.uninstall()
    out = {"crashed": crashed, "fired": [f[0] for f in sched.fired]}
    out["report"] = report(pkg.REC.recover_handle(h))
    out["violations"] = pkg.REC.check_store_invariants(
        h, clock_at_least=clock0)
    out["recovered"] = store_state(h)
    vals, ok = h.snapshot_bulk(np.arange(32))
    out["snapshot"] = (bool(ok), ints(vals))

    def w2(tx):
        tx.write_bulk(np.arange(8), [7] * 8)
    pkg.run(h, w2, tid=0)
    vals, ok = h.snapshot_bulk(np.arange(8))
    out["after"] = (bool(ok), ints(vals), store_state(h))
    h.stop()
    return out


def check_mvstore(rec, point):
    assert rec["crashed"] and rec["fired"][0] == point
    assert rec["violations"] == []
    ok, vals = rec["snapshot"]
    assert ok
    exp = (np.arange(32) + 100 if rec["report"]["completed_install"]
           else np.arange(32))
    np.testing.assert_array_equal(vals, exp)
    if point in ("post_scatter", "pre_release"):
        assert rec["report"]["completed_install"]
    np.testing.assert_array_equal(rec["after"][1], [7] * 8)


@pytest.mark.parametrize("point", MV_POINTS)
def test_crash_mvstore_fused(point):
    check_mvstore(both(mvstore_case, point), point)


def test_crash_quick_mvstore():
    check_mvstore(both(mvstore_case, "post_scatter"), "post_scatter")


def _crash_store_at(point):
    h = PORT.store()
    h.alloc(32, 0)
    for k in range(h.cfg.ring_slots):   # every ring slot holds a version
        t_run(h, lambda tx, k=k: tx.write_bulk(
            np.arange(32), [v + k for v in range(32)]), tid=0)
    clock0 = h.clock
    TFP.install(TFP.FaultSchedule([TFP.Fault(point, 1, "kill")]))
    with pytest.raises(TFP.SimulatedCrash):
        t_run(h, lambda tx: tx.write_bulk(np.arange(32),
                                          [v + 100 for v in range(32)]),
              tid=1)
    TFP.uninstall()
    return h, clock0


def test_port_post_scatter_kill_completes_install_from_inflight():
    """The kernel already refreshed ring slot ``clock0 + 1`` in place and
    the host stamped it; the block and clock are the old ones until
    ``_install`` — the parked ``_inflight`` state is what recovery
    installs, so the slot and the clock agree again."""
    h, clock0 = _crash_store_at("post_scatter")
    slot = (clock0 + 1) % h.cfg.ring_slots
    assert h._inflight is not None and h._snap[0] == clock0
    assert int(h._state.ring_ts["['heap']"][slot]) == clock0 + 1
    assert h._snap[3][slot] == clock0 + 1
    rep = TREC.recover_handle(h)
    assert rep.completed_install and rep.truncated_ring_slots == 0
    assert h._inflight is None and h.clock == clock0 + 1
    np.testing.assert_array_equal(
        h._snap[3], ints(h._state.ring_ts["['heap']"]))
    assert TREC.check_store_invariants(h, clock_at_least=clock0) == []
    vals, ok = h.snapshot_bulk(np.arange(32), clock0 + 1)
    assert ok and ints(vals).tolist() == [v + 100 for v in range(32)]
    h.stop()


def test_port_pre_scatter_kill_restores_host_ring_timestamps():
    """The publisher invalidated the slot on the host (``NO_TS``) and
    died before the kernel refreshed it: the card still holds the old
    timestamp.  Recovery rebuilds the host copy from the card, so the
    slot serves its old version again."""
    h, clock0 = _crash_store_at("pre_scatter")
    slot = (clock0 + 1) % h.cfg.ring_slots
    dev = ints(h._state.ring_ts["['heap']"])
    assert h._snap[3][slot] == NO_TS and dev[slot] != NO_TS
    assert any("host ring timestamps" in v
               for v in TREC.check_store_invariants(h))
    rep = TREC.recover_handle(h)
    assert not rep.completed_install and h.clock == clock0
    np.testing.assert_array_equal(h._snap[3], dev)
    assert TREC.check_store_invariants(h, clock_at_least=clock0) == []
    vals, ok = h.snapshot_bulk(np.arange(32), int(dev[slot]))
    assert ok
    h.stop()


# ---------------------------------------------------------------------------
# ShardStore cross-shard epoch publish
# ---------------------------------------------------------------------------


def shard_epoch_case(pkg, point, nth, expect_forward):
    FP = pkg.FP
    st = pkg.shards()
    st.alloc(32, 0)

    def w0(tx):
        tx.write_bulk(np.arange(32), list(range(32)))
    pkg.run(st, w0, tid=0)
    clocks0 = st.clocks
    sched = FP.install(FP.FaultSchedule([FP.Fault(point, nth, "kill")]))
    crashed = False
    try:
        def w1(tx):
            tx.write_bulk(np.arange(32), [v + 100 for v in range(32)])
        pkg.run(st, w1, tid=1)
    except FP.SimulatedCrash:
        crashed = True
    FP.uninstall()
    out = {"crashed": crashed, "fired": [f[0] for f in sched.fired],
           "parked": st._epoch_inflight is not None,
           "crash_image": shard_state(st)}
    out["report"] = report(pkg.REC.recover_shardstore(st))
    out["violations"] = pkg.REC.check_shardstore_invariants(
        st, clocks_at_least=clocks0)
    out["recovered"] = shard_state(st)
    vals, ok = st.snapshot_bulk(np.arange(32))
    out["snapshot"] = (bool(ok), ints(vals))

    def w2(tx):
        tx.write_bulk(np.arange(16), [7] * 16)
    pkg.run(st, w2, tid=0)
    vals, ok = st.snapshot_bulk(np.arange(16))
    out["after"] = (bool(ok), ints(vals))
    st.stop()
    return out


def check_shard_epoch(rec, point, expect_forward):
    assert rec["crashed"] and rec["fired"][-1] == point
    assert rec["violations"] == []
    ok, got = rec["snapshot"]
    assert ok
    if expect_forward:
        np.testing.assert_array_equal(got, np.arange(32) + 100)
        assert rec["report"]["rolled_forward"] == [1]
    else:
        np.testing.assert_array_equal(got, np.arange(32))
        if expect_forward is False:
            assert rec["report"]["rolled_back"] == [1]
        else:
            assert rec["report"]["rolled_forward"] == [] and \
                rec["report"]["rolled_back"] == []
    ok, vals = rec["after"]
    assert ok and vals.tolist() == [7] * 16


@pytest.mark.parametrize("point,nth,expect_forward", SHARD_EPOCH_CASES)
def test_crash_shardstore_epoch(point, nth, expect_forward):
    check_shard_epoch(both(shard_epoch_case, point, nth, expect_forward),
                      point, expect_forward)


def test_crash_quick_shardstore_epoch():
    check_shard_epoch(both(shard_epoch_case, "pre_scatter", 2, True),
                      "pre_scatter", True)


def single_shard_case(pkg):
    FP = pkg.FP
    st = pkg.shards()
    st.alloc(32, 0)
    pkg.run(st, lambda tx: tx.write_bulk(np.arange(0, 4), [5] * 4), tid=0)
    FP.install(FP.FaultSchedule([FP.Fault("pre_scatter", 1, "kill")]))
    crashed = False
    try:
        pkg.run(st, lambda tx: tx.write_bulk(np.arange(0, 4), [9] * 4),
                tid=1)
    except FP.SimulatedCrash:
        crashed = True
    FP.uninstall()
    out = {"crashed": crashed, "parked": st._epoch_inflight is not None}
    out["report"] = report(pkg.REC.recover_shardstore(st))
    out["violations"] = pkg.REC.check_shardstore_invariants(st)
    vals, ok = st.snapshot_bulk(np.arange(4))
    out["snapshot"] = (bool(ok), ints(vals))
    out["recovered"] = shard_state(st)
    st.stop()
    return out


def test_crash_shardstore_single_shard_commit_unaffected():
    rec = both(single_shard_case)
    assert rec["crashed"] and not rec["parked"]
    assert rec["violations"] == []
    ok, vals = rec["snapshot"]
    assert ok and set(vals.tolist()) <= {5, 9}


# ---------------------------------------------------------------------------
# checkpoint manifest publish
# ---------------------------------------------------------------------------


def test_crash_manifest_publish(tmp_path):
    """A crash before the manifest rename leaves only the .tmp directory;
    restore skips it and replays the previous complete checkpoint — in
    both packages, each restoring the other's directory too."""
    import jax.numpy as jnp

    from repro.checkpoint import snapshotter as JS
    from repro_torch.checkpoint import snapshotter as TS

    def case(FP, save, state1, state2, d):
        save(d, 1, state1)
        sched = FP.install(FP.FaultSchedule(
            [FP.Fault("pre_manifest_publish", 1, "crash")]))
        with pytest.raises(FP.ProcessCrashed):
            save(d, 2, state2)
        FP.uninstall()
        FP.reset_thread()
        assert sched.process_dead
        return sorted(os.listdir(d))

    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    j1 = {"params": {"w": jnp.arange(4)}, "opt": {"m": jnp.zeros(4)}}
    j2 = {"params": {"w": jnp.arange(4) + 9}, "opt": {"m": jnp.ones(4)}}
    t1 = {"params": {"w": torch.arange(4, dtype=torch.int32)},
          "opt": {"m": torch.zeros(4)}}
    t2 = {"params": {"w": torch.arange(4, dtype=torch.int32) + 9},
          "opt": {"m": torch.ones(4)}}
    assert case(JFP, JS.save_checkpoint, j1, j2, jd) == \
        case(TFP, TS.save_checkpoint, t1, t2, td)
    for d in (jd, td):
        step, restored, _ = TS.restore_checkpoint(d, t1)
        assert step == 1
        assert ints(restored["params"]["w"]).tolist() == [0, 1, 2, 3]
        step, restored, _ = JS.restore_checkpoint(d, j1)
        assert step == 1
        assert list(np.asarray(restored["params"]["w"])) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# fault actions beyond kill
# ---------------------------------------------------------------------------


def raise_retryable_case(pkg):
    FP = pkg.FP
    tm = pkg.word["multiverse"](2)
    tm.alloc(N, 0)
    committed_write(pkg, tm, 0)
    FP.install(FP.FaultSchedule([FP.Fault("pre_claim", 1, "raise")]))
    with pytest.raises(FP.FaultError):
        crashing_write(pkg, tm, 1)
    FP.uninstall()
    return {"violations": pkg.REC.check_engine_invariants(tm),
            "state": word_state(tm, N)}


def test_crash_raise_action_is_retryable():
    rec = both(raise_retryable_case)
    assert rec["violations"] == []
    np.testing.assert_array_equal(rec["state"]["heap"], np.arange(N))


def raise_after_record_case(pkg):
    FP = pkg.FP
    out = {}
    for backend in ("multiverse", "tl2", "dctl"):
        tm = pkg.word[backend](2)
        tm.alloc(N, 0)
        committed_write(pkg, tm, 0)
        FP.install(FP.FaultSchedule([FP.Fault("pre_release", 1, "raise")]))
        with pytest.raises(FP.FaultError):
            crashing_write(pkg, tm, 1)
        FP.uninstall()
        out[backend] = {"violations": pkg.REC.check_engine_invariants(tm),
                        "state": word_state(tm, N)}
    return out


def test_crash_raise_after_commit_record_rolls_forward():
    for backend, rec in both(raise_after_record_case).items():
        assert rec["violations"] == [], backend
        np.testing.assert_array_equal(rec["state"]["heap"],
                                      np.arange(N) + 1000, err_msg=backend)


def process_drop_case(pkg):
    FP = pkg.FP
    tm = pkg.word["tl2"](2)
    tm.alloc(N, 0)
    committed_write(pkg, tm, 0)
    sched = FP.install(FP.FaultSchedule(
        [FP.Fault("post_claim", 1, "crash")]))
    with pytest.raises(FP.ProcessCrashed):
        crashing_write(pkg, tm, 1)
    FP.uninstall()
    out = {"dead": sched.process_dead,
           "report": report(pkg.REC.recover_engine(tm, [0, 1]))}
    out["violations"] = pkg.REC.check_engine_invariants(tm)
    out["state"] = word_state(tm, N)
    return out


def test_crash_process_drop_marks_schedule():
    rec = both(process_drop_case)
    assert rec["dead"] and rec["violations"] == []


def test_crash_schedule_seeded_periodic_is_deterministic():
    """The port's copy of ``faultpoints`` draws the reference's gaps."""
    logs = []
    for FP in (JFP, JFP, TFP, TFP):
        s = FP.FaultSchedule(seed=7, kill_every=5, points=("pre_release",),
                             max_fires=3)
        logs.append([s.arrive("pre_release", i % 4) for i in range(60)])
    assert logs[0] == logs[1] == logs[2] == logs[3]
    assert sum(a is not None for a in logs[2]) == 3


def test_crash_dying_thread_suppresses_nested_fires():
    for FP in (JFP, TFP):
        FP.install(FP.FaultSchedule([FP.Fault("pre_claim", 1, "kill"),
                                     FP.Fault("pre_release", 1, "kill")]))
        with pytest.raises(FP.ThreadKilled):
            FP.fire("pre_claim", 0)
        FP.fire("pre_release", 0)        # no raise: thread is dying
        assert FP.dying()
        FP.uninstall()
        FP.reset_thread()


# ---------------------------------------------------------------------------
# multi-worker simultaneous crashes: >= 2 dead tids, ONE recovery sweep
# ---------------------------------------------------------------------------


def two_worker_case(pkg, backend, point0, point1):
    FP = pkg.FP
    tm = pkg.word[backend](3)
    tm.alloc(2 * N, 0)
    committed_write(pkg, tm, 0)
    clock0 = tm.clock.load()
    order = {p: i for i, p in enumerate(POINTS)}
    nth1 = 2 if order[point1] <= order[point0] else 1
    sched = FP.install(FP.FaultSchedule([
        FP.Fault(point0, 1, "kill", tid=1),
        FP.Fault(point1, nth1, "kill", tid=2)]))
    dead = []
    for tid, lo in ((1, 0), (2, N)):
        def w(tx, lo=lo):
            tx.write_bulk(np.arange(lo, lo + N),
                          [lo + v + 1000 for v in range(N)])
        try:
            pkg.run(tm, w, tid=tid)
        except FP.SimulatedCrash:
            dead.append(tid)
            FP.reset_thread()
    FP.uninstall()
    out = {"dead": dead, "fired": list(sched.fired),
           "decided": {t: bool(tm.ctx(t).publish_started) for t in dead},
           "crash_image": word_state(tm, 2 * N)}
    out["report"] = report(pkg.REC.recover_engine(tm, dead))
    out["violations"] = pkg.REC.check_engine_invariants(
        tm, clock_at_least=clock0)
    out["recovered"] = word_state(tm, 2 * N)
    return out


def check_two_workers(rec):
    assert rec["dead"] == [1, 2], rec["fired"]
    assert rec["report"]["dead_tids"] == [1, 2]
    assert rec["violations"] == []
    heap = rec["recovered"]["heap"]
    for tid, lo in ((1, 0), (2, N)):
        exp = (np.arange(N) + lo + 1000 if rec["decided"][tid]
               else (np.arange(N) if lo == 0 else np.zeros(N)))
        np.testing.assert_array_equal(heap[lo:lo + N], exp)


@pytest.mark.parametrize("backend", ["multiverse", "tl2"])
def test_crash_multi_worker_both_roll_forward(backend):
    rec = both(two_worker_case, backend, "pre_release", "pre_release")
    check_two_workers(rec)
    assert rec["decided"] == {1: True, 2: True}
    assert sorted(rec["report"]["rolled_forward"]) == [1, 2]


def test_crash_multi_worker_mixed_directions():
    rec = both(two_worker_case, "tl2", "pre_claim", "pre_release")
    check_two_workers(rec)
    assert rec["decided"] == {1: False, 2: True}
    assert rec["report"]["rolled_forward"] == [2]


def group_mid_scatter_case(pkg):
    FP = pkg.FP
    tm = pkg.word["tl2"](4)
    tm.alloc(3 * N, 0)
    batcher = pkg.Batcher(tm)
    for t in range(3):
        tx = tm.begin(t)
        tx.write_bulk(np.arange(t * N, (t + 1) * N),
                      [t * 10000 + i for i in range(N)])
        batcher.add(tx)
    clock0 = tm.clock.load()
    FP.install(FP.FaultSchedule([FP.Fault("mid_scatter", 1, "kill")]))
    with pytest.raises(FP.SimulatedCrash):
        batcher.commit_all()
    FP.uninstall()
    out = {"decided": [bool(tm.ctx(t).publish_started) for t in range(3)],
           "crash_image": word_state(tm, 3 * N),
           "report": report(pkg.REC.recover_engine(tm, [0, 1, 2]))}
    out["violations"] = pkg.REC.check_engine_invariants(
        tm, clock_at_least=clock0)
    out["recovered"] = word_state(tm, 3 * N)
    return out


def test_crash_group_two_dead_same_batch_mid_scatter():
    rec = both(group_mid_scatter_case)
    assert rec["decided"] == [True] * 3
    assert sorted(rec["report"]["rolled_forward"]) == [0, 1, 2]
    assert rec["violations"] == []
    np.testing.assert_array_equal(
        rec["recovered"]["heap"],
        [t * 10000 + i for t in range(3) for i in range(N)])


# ---------------------------------------------------------------------------
# partial-lane completion (mid_scatter) across the pipelines
# ---------------------------------------------------------------------------


def partial_lane_case(pkg, n):
    FP = pkg.FP
    tm = pkg.word["tl2"](2)
    tm.alloc(n, 0)
    pkg.run(tm, lambda tx: tx.write_bulk(np.arange(n), list(range(n))),
            tid=0)
    clock0 = tm.clock.load()
    FP.install(FP.FaultSchedule([FP.Fault("mid_scatter", 1, "kill")]))
    with pytest.raises(FP.SimulatedCrash):
        pkg.run(tm, lambda tx: tx.write_bulk(
            np.arange(n), [v + 1000 for v in range(n)]), tid=1)
    FP.uninstall()
    out = {"crash_image": word_state(tm, n),
           "report": report(pkg.REC.recover_engine(tm, [1]))}
    out["violations"] = pkg.REC.check_engine_invariants(
        tm, clock_at_least=clock0)
    out["recovered"] = word_state(tm, n)
    return out


@pytest.mark.parametrize("n", [8, N], ids=["scalar", "bulk"])
def test_crash_partial_lane_write_back_rolls_forward(n):
    rec = both(partial_lane_case, n)
    torn = rec["crash_image"]["heap"]
    assert (torn >= 1000).any() and (torn < 1000).any()
    assert rec["report"]["rolled_forward"] == [1]
    assert rec["violations"] == []
    np.testing.assert_array_equal(rec["recovered"]["heap"],
                                  np.arange(n) + 1000)


def partial_encounter_case(pkg):
    FP = pkg.FP
    tm = pkg.word["dctl"](2)
    tm.alloc(N, 0)
    committed_write(pkg, tm, 0)
    clock0 = tm.clock.load()
    FP.install(FP.FaultSchedule([FP.Fault("mid_scatter", 1, "kill")]))
    with pytest.raises(FP.SimulatedCrash):
        crashing_write(pkg, tm, 1)
    FP.uninstall()
    out = {"decided": bool(tm.ctx(1).publish_started),
           "crash_image": word_state(tm, N),
           "report": report(pkg.REC.recover_engine(tm, [1]))}
    out["violations"] = pkg.REC.check_engine_invariants(
        tm, clock_at_least=clock0)
    out["recovered"] = word_state(tm, N)
    return out


def test_crash_partial_lane_encounter_rolls_back():
    rec = both(partial_encounter_case)
    assert not rec["decided"]
    assert rec["report"]["rolled_back"] == [1]
    assert rec["violations"] == []
    np.testing.assert_array_equal(rec["recovered"]["heap"], np.arange(N))


def mvstore_wal_case(pkg, tmp_path):
    FP = pkg.FP
    d = walled(tmp_path, pkg)
    h = pkg.store()
    h.alloc(32, 0)
    pkg.WAL.attach_wal(h, pkg.WAL.WriteAheadLog(d))
    pkg.run(h, lambda tx: tx.write_bulk(np.arange(32), list(range(32))),
            tid=0)
    FP.install(FP.FaultSchedule([FP.Fault("mid_scatter", 1, "kill")]))
    with pytest.raises(FP.SimulatedCrash):
        pkg.run(h, lambda tx: tx.write_bulk(
            np.arange(32), [v + 100 for v in range(32)]), tid=1)
    FP.uninstall()
    FP.reset_thread()
    h.wal.close()
    h.stop()
    h2 = pkg.store()
    h2.alloc(32, 0)
    out = {"report": report(pkg.WAL.recover_from_wal(d, h2))}
    vals, ok = h2.snapshot_bulk(np.arange(32))
    out["snapshot"] = (bool(ok), ints(vals))
    out["violations"] = pkg.REC.check_store_invariants(h2)
    out["recovered"] = store_state(h2)
    out["log"] = seg_bytes(d)
    h2.stop()
    return out


def test_crash_partial_lane_mvstore_fused_wal_recovers(tmp_path):
    rec = both(mvstore_wal_case, tmp_path)
    assert rec["report"]["wal_records_replayed"] == 2
    ok, vals = rec["snapshot"]
    assert ok and vals.tolist() == [v + 100 for v in range(32)]
    assert rec["violations"] == []


# ---------------------------------------------------------------------------
# durable WAL x crash matrix: restart-grade recovery (fresh target)
# ---------------------------------------------------------------------------


def wal_group_case(pkg, tmp_path):
    FP = pkg.FP
    d = walled(tmp_path, pkg)
    tm = pkg.word["tl2"](4)
    tm.alloc(3 * N, 0)
    pkg.WAL.attach_wal(tm, pkg.WAL.WriteAheadLog(d))
    batcher = pkg.Batcher(tm)
    for t in range(3):
        tx = tm.begin(t)
        tx.write_bulk(np.arange(t * N, (t + 1) * N),
                      [t * 10000 + i for i in range(N)])
        batcher.add(tx)
    FP.install(FP.FaultSchedule([FP.Fault("mid_scatter", 1, "kill")]))
    with pytest.raises(FP.SimulatedCrash):
        batcher.commit_all()
    FP.uninstall()
    FP.reset_thread()
    tm.wal.close()
    tm2 = pkg.word["tl2"](4)
    tm2.alloc(3 * N, 0)
    out = {"report": report(pkg.WAL.recover_from_wal(d, tm2))}
    out["violations"] = pkg.REC.check_engine_invariants(tm2)
    out["recovered"] = word_state(tm2, 3 * N)
    out["log"] = seg_bytes(d)
    return out


def test_crash_wal_group_batch_two_dead_survive_restart(tmp_path):
    rec = both(wal_group_case, tmp_path)
    assert rec["report"]["wal_records_replayed"] == 3
    assert sorted(set(rec["report"]["rolled_forward"])) == [0, 1, 2]
    assert rec["violations"] == []
    np.testing.assert_array_equal(
        rec["recovered"]["heap"],
        [t * 10000 + i for t in range(3) for i in range(N)])


def wal_shard_case(pkg, tmp_path):
    FP = pkg.FP
    d = walled(tmp_path, pkg)
    st = pkg.shards()
    st.alloc(32, 0)
    pkg.WAL.attach_wal(st, pkg.WAL.WriteAheadLog(d))
    pkg.run(st, lambda tx: tx.write_bulk(np.arange(32), list(range(32))),
            tid=0)
    FP.install(FP.FaultSchedule([FP.Fault("pre_scatter", 2, "kill")]))
    with pytest.raises(FP.SimulatedCrash):
        pkg.run(st, lambda tx: tx.write_bulk(
            np.arange(32), [v + 100 for v in range(32)]), tid=1)
    FP.uninstall()
    FP.reset_thread()
    st.wal.close()
    st.stop()
    st2 = pkg.shards()
    st2.alloc(32, 0)
    out = {"report": report(pkg.WAL.recover_from_wal(d, st2))}
    vals, ok = st2.snapshot_bulk(np.arange(32))
    out["snapshot"] = (bool(ok), ints(vals))
    out["violations"] = pkg.REC.check_shardstore_invariants(st2)
    out["recovered"] = shard_state(st2)
    out["log"] = seg_bytes(d)
    st2.stop()
    return out


def test_crash_wal_shardstore_epoch_mid_publish_survives_restart(tmp_path):
    rec = both(wal_shard_case, tmp_path)
    ok, vals = rec["snapshot"]
    assert ok and vals.tolist() == [v + 100 for v in range(32)]
    assert rec["violations"] == []


def torn_tail_case(pkg, tmp_path, cut):
    d = walled(tmp_path, pkg)
    tm = pkg.word["tl2"](2)
    tm.alloc(N, 0)
    pkg.WAL.attach_wal(tm, pkg.WAL.WriteAheadLog(d))
    committed_write(pkg, tm, 0)
    pkg.run(tm, lambda tx: tx.write_bulk(
        np.arange(N), [v + 1000 for v in range(N)]), tid=1)
    seg = tm.wal._f.name
    tm.wal.close()
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.truncate(size - cut)
    recs, torn, _ = pkg.WAL.scan_dir(d)
    tm2 = pkg.word["tl2"](2)
    tm2.alloc(N, 0)
    out = {"report": report(pkg.WAL.recover_from_wal(d, tm2)),
           "torn": torn,
           "records": [dataclasses.asdict(r) for r in recs]}
    out["violations"] = pkg.REC.check_engine_invariants(tm2)
    out["recovered"] = word_state(tm2, N)
    out["log"] = seg_bytes(d)
    return out


@pytest.mark.parametrize("cut", [1, 24, 200])
def test_crash_wal_torn_tail_truncation_recovers_prefix(cut, tmp_path):
    rec = both(torn_tail_case, tmp_path, cut)
    assert rec["violations"] == []
    ref = np.zeros(N, np.int64)
    for r in rec["records"]:
        if r["decided"]:
            ref[r["addrs"]] = r["values"]
    got = rec["recovered"]["heap"]
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() in ([0] * N, list(range(N)),
                            [v + 1000 for v in range(N)])
    assert rec["report"]["wal_records_replayed"] == \
        sum(r["decided"] for r in rec["records"])


# ---------------------------------------------------------------------------
# where the port's recovery differs in HOW it gets the reference's result
# ---------------------------------------------------------------------------


def test_port_repair_mirror_resets_the_host_ways():
    """A torn mirror row (odd seqlock) resets to the reference's empty row
    on the device AND in the port's host copy of the ways, so the next
    publish to that address finds no way, as the reference's does."""
    from repro.core.vlt import VListNode as JNode
    from repro_torch.core.vlt import VListNode as TNode

    rows = {}
    for pkg, node in ((JAX, JNode), (PORT, TNode)):
        tm = pkg.word["multiverse"](2)
        mirror = tm.policy.vlt.mirror
        for bucket, addr in ((3, 40), (9, 41)):
            mirror.seed(bucket, addr, node(None, 5, 77, False))
        mirror._seq[3] += 1                       # a writer died mid-row
        rep = pkg.REC.repair_mirror(tm)
        mirror.publish(3, 40, 6, 78)              # must find no way
        mirror.publish(9, 41, 6, 79)
        rows[pkg.name] = {"repaired": rep, "violations":
                          pkg.REC.check_engine_invariants(tm),
                          "mirror": word_state(tm, 0)["mirror"]}
        if pkg is PORT:
            assert (mirror._ways[3] == mirror.NO_ADDR).all()
            assert mirror._ways[9, 0] == 41
    same(rows["jax"], rows[PORT.name])
    assert rows["jax"]["repaired"] == 1 and rows["jax"]["violations"] == []


def test_port_block_sums_take_one_gather():
    """``check_engine_invariants``' block sums read every block in ONE heap
    gather (one copy home), with the reference's verdicts."""
    out = {}
    for pkg in (JAX, PORT):
        tm = pkg.word["tl2"](2)
        tm.alloc(64, 3)
        pkg.run(tm, lambda tx: tx.write_bulk([5], [4]), tid=0)
        sums = [(8 * b, 8, 24) for b in range(8)]
        calls = []
        if pkg is PORT:
            gather = tm.heap.gather
            tm.heap.gather = lambda a: (calls.append(len(a)), gather(a))[1]
        out[pkg.name] = pkg.REC.check_engine_invariants(tm,
                                                        expect_sums=sums)
        if pkg is PORT:
            assert calls == [64]
    assert out["jax"] == out[PORT.name] == ["block sum at 0+8: 25 != 24"]


def test_port_roll_forward_releases_in_one_sweep():
    """A rolled-forward commit's held locks release in one ``unlock_bulk``
    at the recovery tick (the reference unlocks index by index): the
    same lock words, no scalar unlock."""
    tm = PORT.word["tl2"](2)
    tm.alloc(N, 0)
    TFP.install(TFP.FaultSchedule([TFP.Fault("pre_release", 1, "kill")]))
    with pytest.raises(TFP.SimulatedCrash):
        crashing_write(PORT, tm, 1)
    TFP.uninstall()
    scalar, bulk = [], []
    unlock, unlock_bulk = tm.locks.unlock, tm.locks.unlock_bulk
    tm.locks.unlock = lambda *a, **k: (scalar.append(a), unlock(*a, **k))
    tm.locks.unlock_bulk = lambda *a, **k: (bulk.append(a),
                                            unlock_bulk(*a, **k))
    rep = TREC.recover_engine(tm, [1])
    assert rep.rolled_forward == [1] and rep.released_locks > 1
    assert scalar == [] and len(bulk) == 1
    assert len(bulk[0][0]) == rep.released_locks
    assert TREC.check_engine_invariants(tm) == []


def test_port_replay_scatters_int64_columns(tmp_path):
    """A replay into an array heap is one ``scatter`` call for the base
    image plus one a decided record, each handed int64 arrays (never a
    Python list), and fires no fault point: an installed schedule that
    would kill the commit pipeline's scatter stays unfired."""
    tm = PORT.word["tl2"](2)
    tm.alloc(N, 0)
    wal = TWAL.attach_wal(tm, TWAL.WriteAheadLog(str(tmp_path)))
    committed_write(PORT, tm, 0)
    wal.checkpoint(tm.heap.live(), tm.clock.load())
    for k in range(3):
        t_run(tm, lambda tx, k=k: tx.write_bulk(np.arange(k, N, 7),
                                                [k] * len(range(k, N, 7))),
              tid=0)
    want = heap_words(tm, N)
    wal.close()
    fresh = PORT.word["tl2"](2)
    fresh.alloc(N, 0)
    calls = []
    scatter = fresh.heap.scatter
    fresh.heap.scatter = lambda a, v: (calls.append((a, v)),
                                       scatter(a, v))[1]
    sched = TFP.install(TFP.FaultSchedule(
        [TFP.Fault(p, 1, "kill") for p in ("pre_scatter", "mid_scatter",
                                           "post_scatter")]))
    rep = TWAL.recover_from_wal(str(tmp_path), fresh)
    TFP.uninstall()
    assert sched.fired == [] and rep.wal_records_replayed == 3
    assert len(calls) == 1 + 3
    for a, v in calls:
        assert isinstance(a, np.ndarray) and a.dtype == np.int64
        assert isinstance(v, np.ndarray) and v.dtype == np.int64
    np.testing.assert_array_equal(heap_words(fresh, N), want)
