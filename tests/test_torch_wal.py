"""The port's write-ahead log (``reliability/wal.py``) against the JAX
package's.

Every case of ``tests/test_wal.py`` runs through both packages on the
same inputs: the scanned records, torn-tail counts, base images, the
``RecoveryReport`` of a replay and the replayed heap, lock words, clock
and store state must be equal, the reference test's own assertions must
hold on the port, and the two packages' segment files must be
byte-identical.  The three SIGKILL drills run a child process of each
package (the port's on the CPU) that really kills itself mid-commit; the
parent recovers a fresh engine from the log directory alone.

Beyond the reference: the same records give byte-identical frames and
base images; a log written by either package replays in the other to
equal heaps; and ``TrainSupervisor(wal=...)`` checkpoints into the log
and scans it on restore (the reference's supervisor reads a ``wal.path``
its log does not have; the port reads ``wal.dir``).
"""
import dataclasses
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.stats_schema import normalize_stats as j_normalize
from repro.reliability import wal as JWAL
from repro_torch.core.stats_schema import normalize_stats as t_normalize
from repro_torch.reliability import wal as TWAL
from test_torch_recovery import (JAX, PORT, both, heap_words, ints,
                                 report, same, seg_bytes, shard_state,
                                 store_state, walled, word_state)

N = 300          # >= BULK_MIN so the bulk scatter (and mid_scatter) runs


@pytest.fixture(autouse=True)
def _no_leftover_schedule():
    yield
    for pkg in (JAX, PORT):
        pkg.FP.uninstall()
        pkg.FP.reset_thread()


def npz_members(path):
    """A base image's members as bytes (the zip headers carry the time
    of writing, so whole files of two writers need not be equal)."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def records(recs):
    return [dataclasses.asdict(r) for r in recs]


def scanned(pkg, d):
    recs, torn, base = pkg.WAL.scan_dir(d)
    return {"records": records(recs), "torn": torn,
            "base": None if base is None else
            (base[0], np.array(base[1]), base[2])}


# ---------------------------------------------------------------------------
# quick: frame format and file lifecycle
# ---------------------------------------------------------------------------


def roundtrip_case(pkg, tmp_path):
    d = walled(tmp_path, pkg)
    with pkg.WAL.WriteAheadLog(d) as wal:
        l0 = wal.append_prepare(3, [0, 1, 2], [10, 11, 12],
                                clocks=(7,), epoch=-1, shard=-1)
        l1 = wal.append_prepare(4, [5], [50], clocks=(8,))
        wal.append_decide(l0)
        wal.append_complete(l0)
    return {"lsns": [l0, l1], **scanned(pkg, d), "log": seg_bytes(d)}


def test_wal_quick_prepare_decide_complete_roundtrip(tmp_path):
    rec = both(roundtrip_case, tmp_path)
    assert rec["torn"] == 0 and rec["base"] is None
    r0, r1 = rec["records"]
    assert [r0["lsn"], r1["lsn"]] == rec["lsns"]
    assert (r0["tid"], r0["decided"], r0["completed"]) == (3, True, True)
    assert r0["clocks"] == (7,)
    assert r0["addrs"].tolist() == [0, 1, 2]
    assert r0["values"].tolist() == [10, 11, 12]
    assert (r1["tid"], r1["decided"], r1["completed"]) == (4, False, False)


def torn_tail_case(pkg, tmp_path):
    d = walled(tmp_path, pkg)
    with pkg.WAL.WriteAheadLog(d) as wal:
        l0 = wal.append_prepare(0, [0], [1], clocks=(1,))
        wal.append_decide(l0)
        l1 = wal.append_prepare(1, list(range(8)), list(range(8)),
                                clocks=(2,))
        wal.append_decide(l1)
        seg = wal._f.name
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.truncate(size - 11)
    return {"lsns": [l0, l1], **scanned(pkg, d), "log": seg_bytes(d)}


def test_wal_quick_torn_tail_is_detected_and_dropped(tmp_path):
    rec = both(torn_tail_case, tmp_path)
    assert rec["torn"] > 0
    assert [r["lsn"] for r in rec["records"]] == rec["lsns"]
    assert rec["records"][0]["decided"] and not rec["records"][1]["decided"]


def corrupt_case(pkg, tmp_path):
    d = walled(tmp_path, pkg)
    with pkg.WAL.WriteAheadLog(d) as wal:
        l0 = wal.append_prepare(0, [0], [1], clocks=(1,))
        wal.append_decide(l0)
        l1 = wal.append_prepare(1, [2], [3], clocks=(2,))
        wal.append_decide(l1)
        seg = wal._f.name
    data = bytearray(open(seg, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(seg, "wb").write(bytes(data))
    return {**scanned(pkg, d), "log": seg_bytes(d)}


def test_wal_quick_corrupt_frame_stops_scan_at_crc(tmp_path):
    rec = both(corrupt_case, tmp_path)
    assert rec["torn"] > 0
    assert len(rec["records"]) < 2 or \
        not all(r["decided"] for r in rec["records"])


def segment_roll_case(pkg, tmp_path):
    d = walled(tmp_path, pkg)
    wal = pkg.WAL.WriteAheadLog(d, segment_bytes=256)
    lsns = []
    for i in range(10):
        lsn = wal.append_prepare(i, [i], [i * 10], clocks=(i,))
        wal.append_decide(lsn)
        lsns.append(lsn)
    n_segs = len(wal._segments())
    wal.close()
    wal2 = pkg.WAL.WriteAheadLog(d, segment_bytes=256)
    lsn = wal2.append_prepare(99, [0], [0], clocks=(99,))
    wal2.append_decide(lsn)
    n_segs2 = len(wal2._segments())
    wal2.close()
    return {"lsns": lsns, "lsn": lsn, "segs": (n_segs, n_segs2),
            **scanned(pkg, d), "log": seg_bytes(d)}


def test_wal_quick_segment_roll_and_reopen_continues_lsn(tmp_path):
    rec = both(segment_roll_case, tmp_path)
    n_segs, n_segs2 = rec["segs"]
    assert n_segs > 1 and n_segs2 == n_segs + 1
    assert rec["lsn"] == rec["lsns"][-1] + 1
    assert rec["torn"] == 0
    assert [r["lsn"] for r in rec["records"]] == rec["lsns"] + [rec["lsn"]]
    assert all(r["decided"] for r in rec["records"])


def checkpoint_case(pkg, tmp_path):
    d = walled(tmp_path, pkg)
    wal = pkg.WAL.WriteAheadLog(d, segment_bytes=256)
    for i in range(8):
        wal.append_decide(wal.append_prepare(i, [i], [i], clocks=(i,)))
    heap = np.arange(8, dtype=np.int64)
    if pkg is PORT:
        heap = torch.from_numpy(heap)        # a heap tensor comes home
    floor = wal.checkpoint(heap, clock=8)
    out = {"floor": floor, "next": wal._next_lsn,
           "segs": len(wal._segments())}
    lsn = wal.append_prepare(9, [3], [333], clocks=(9,))
    wal.append_decide(lsn)
    wal.close()
    base = [n for n in os.listdir(d) if n.startswith("base-")]
    out.update(lsn=lsn, **scanned(pkg, d), log=seg_bytes(d),
               base_files=base,
               base_members=[npz_members(os.path.join(d, n))
                             for n in base])
    return out


def test_wal_quick_checkpoint_reclaims_segments(tmp_path):
    rec = both(checkpoint_case, tmp_path)
    assert rec["floor"] == rec["next"] and rec["segs"] == 1
    assert rec["torn"] == 0
    b_floor, b_heap, b_clock = rec["base"]
    assert b_floor == rec["floor"] and b_clock == 8
    assert b_heap.tolist() == list(range(8))
    assert [r["lsn"] for r in rec["records"]] == [rec["lsn"]]


def group_append_case(pkg, tmp_path):
    d = walled(tmp_path, pkg)
    wal = pkg.WAL.WriteAheadLog(d)
    recs = [(t, [t * 4 + i for i in range(4)],
             [t * 100 + i for i in range(4)], (5,), -1, -1)
            for t in range(3)]
    f0 = wal.counters["fsyncs"]
    lsns = wal.append_prepare_group(recs)
    f1 = wal.counters["fsyncs"]
    wal.append_decide_group(lsns)
    out = {"fsyncs": (f0, f1, wal.counters["fsyncs"]),
           "decides": wal.counters["decides"]}
    wal.close()
    return {**out, **scanned(pkg, d), "log": seg_bytes(d)}


def test_wal_quick_group_append_is_one_fsync(tmp_path):
    rec = both(group_append_case, tmp_path)
    f0, f1, f2 = rec["fsyncs"]
    assert f1 == f0 and f2 == f0 + 1
    assert rec["decides"] == 3
    assert [r["tid"] for r in rec["records"]] == [0, 1, 2]
    assert all(r["decided"] for r in rec["records"])


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "torch"])
def test_wal_rejects_non_numeric_heap_values(pkg, tmp_path):
    with pkg.WAL.WriteAheadLog(str(tmp_path)) as wal:
        with pytest.raises(TypeError, match="numeric heap"):
            wal.append_prepare(0, [0], [object()], clocks=(1,))


# ---------------------------------------------------------------------------
# quick: replay into a fresh engine (in-process process-loss stand-in)
# ---------------------------------------------------------------------------


def replay_case(pkg, tmp_path):
    d = walled(tmp_path, pkg)
    tm = pkg.word["tl2"](2)
    tm.alloc(N, 0)
    pkg.WAL.attach_wal(tm, pkg.WAL.WriteAheadLog(d))
    pkg.run(tm, lambda tx: tx.write_bulk(np.arange(N), list(range(N))),
            tid=0)
    pkg.run(tm, lambda tx: tx.write_bulk(
        np.arange(8), [v + 1000 for v in range(8)]), tid=1)
    tm.wal.close()
    tm2 = pkg.word["tl2"](2)
    tm2.alloc(N, 0)
    out = {"report": report(pkg.WAL.recover_from_wal(d, tm2))}
    out["violations"] = pkg.REC.check_engine_invariants(tm2)
    out["recovered"] = word_state(tm2, N)
    norm = j_normalize if pkg is JAX else t_normalize
    stats = norm(tm2.stats())
    out["stats"] = {k: stats[k] for k in ("wal_records_replayed",
                                          "rolled_back", "rolled_forward",
                                          "locks_swept")}
    out["log"] = seg_bytes(d)
    return out


def test_wal_quick_replay_rebuilds_fresh_engine(tmp_path):
    rec = both(replay_case, tmp_path)
    assert rec["report"]["wal_records_replayed"] == 2
    np.testing.assert_array_equal(
        rec["recovered"]["heap"],
        [v + 1000 for v in range(8)] + list(range(8, N)))
    assert rec["violations"] == []
    assert rec["stats"]["wal_records_replayed"] == 2
    assert rec["stats"]["rolled_back"] == 0


def crashed_replay_case(pkg, tmp_path, point):
    FP = pkg.FP
    d = walled(tmp_path, pkg)
    tm = pkg.word["tl2"](2)
    tm.alloc(N, 0)
    pkg.WAL.attach_wal(tm, pkg.WAL.WriteAheadLog(d))
    pkg.run(tm, lambda tx: tx.write_bulk(np.arange(N), list(range(N))),
            tid=0)
    FP.install(FP.FaultSchedule([FP.Fault(point, 1, "crash")]))
    with pytest.raises(FP.ProcessCrashed):
        pkg.run(tm, lambda tx: tx.write_bulk(
            np.arange(N), [v + 1000 for v in range(N)]), tid=1)
    FP.uninstall()
    out = {"crash_image": word_state(tm, N)}
    tm.wal.flush()
    tm.wal.close()
    tm2 = pkg.word["tl2"](2)
    tm2.alloc(N, 0)
    out["report"] = report(pkg.WAL.recover_from_wal(d, tm2))
    out["violations"] = pkg.REC.check_engine_invariants(tm2)
    out["recovered"] = word_state(tm2, N)
    out["log"] = seg_bytes(d)
    return out


def test_wal_quick_partial_lane_crash_heals_by_whole_record_redo(tmp_path):
    rec = both(crashed_replay_case, tmp_path, "mid_scatter")
    torn = rec["crash_image"]["heap"]
    assert (torn >= 1000).any() and (torn < 1000).any()
    assert 1 in rec["report"]["rolled_forward"]
    np.testing.assert_array_equal(rec["recovered"]["heap"],
                                  np.arange(N) + 1000)
    assert rec["violations"] == []


def test_wal_quick_undecided_prepare_rolls_back(tmp_path):
    rec = both(crashed_replay_case, tmp_path, "post_claim")
    assert 1 in rec["report"]["rolled_back"]
    assert 1 not in rec["report"]["rolled_forward"]
    np.testing.assert_array_equal(rec["recovered"]["heap"], np.arange(N))
    assert rec["violations"] == []


def mvhandle_case(pkg, tmp_path):
    d = walled(tmp_path, pkg)
    h = pkg.store()
    h.alloc(32, 0)
    pkg.WAL.attach_wal(h, pkg.WAL.WriteAheadLog(d))
    pkg.run(h, lambda tx: tx.write_bulk(
        np.arange(32), [v + 5 for v in range(32)]), tid=0)
    h.wal.close()
    h.stop()
    h2 = pkg.store()
    h2.alloc(32, 0)
    out = {"report": report(pkg.WAL.recover_from_wal(d, h2))}
    vals, ok = h2.snapshot_bulk(np.arange(32))
    out["snapshot"] = (bool(ok), ints(vals))
    out["clock"] = int(h2.clock)
    norm = j_normalize if pkg is JAX else t_normalize
    out["replayed"] = norm(h2.stats())["wal_records_replayed"]
    out["recovered"] = store_state(h2)
    out["log"] = seg_bytes(d)
    h2.stop()
    return out


def test_wal_mvhandle_replay_redrives_publish(tmp_path):
    rec = both(mvhandle_case, tmp_path)
    assert rec["report"]["wal_records_replayed"] == 1
    ok, vals = rec["snapshot"]
    assert ok and vals.tolist() == [v + 5 for v in range(32)]
    assert rec["clock"] >= 1 and rec["replayed"] == 1


def shardstore_case(pkg, tmp_path):
    d = walled(tmp_path, pkg)
    st = pkg.shards()
    st.alloc(32, 0)
    pkg.WAL.attach_wal(st, pkg.WAL.WriteAheadLog(d))
    pkg.run(st, lambda tx: tx.write_bulk(
        np.arange(32), [v + 100 for v in range(32)]), tid=0)
    st.wal.close()
    st.stop()
    out = scanned(pkg, d)
    st2 = pkg.shards()
    st2.alloc(32, 0)
    out["report"] = report(pkg.WAL.recover_from_wal(d, st2))
    vals, ok = st2.snapshot_bulk(np.arange(32))
    out["snapshot"] = (bool(ok), ints(vals))
    out["violations"] = pkg.REC.check_shardstore_invariants(st2)
    out["recovered"] = shard_state(st2)
    out["log"] = seg_bytes(d)
    st2.stop()
    return out


def test_wal_shardstore_epoch_survives_restart_atomically(tmp_path):
    rec = both(shardstore_case, tmp_path)
    recs = rec["records"]
    epochs = {r["epoch"] for r in recs if r["epoch"] >= 0}
    shards = {r["shard"] for r in recs if r["epoch"] >= 0}
    assert len(epochs) == 1 and shards == {0, 1}
    assert rec["report"]["wal_records_replayed"] == len(recs)
    ok, vals = rec["snapshot"]
    assert ok and vals.tolist() == [v + 100 for v in range(32)]
    assert rec["violations"] == []


def group_journal_case(pkg, tmp_path, backend="tl2"):
    d = walled(tmp_path, pkg)
    tm = pkg.word[backend](4)
    tm.alloc(3 * N, 0)
    pkg.WAL.attach_wal(tm, pkg.WAL.WriteAheadLog(d))
    batcher = pkg.Batcher(tm)
    for t in range(3):
        tx = tm.begin(t)
        tx.write_bulk(np.arange(t * N, (t + 1) * N),
                      [t * 10000 + i for i in range(N)])
        batcher.add(tx)
    f0 = tm.wal.counters["fsyncs"]
    batcher.commit_all()
    out = {"fsyncs": tm.wal.counters["fsyncs"] - f0}
    tm.wal.close()
    tm2 = pkg.word[backend](4)
    tm2.alloc(3 * N, 0)
    out["report"] = report(pkg.WAL.recover_from_wal(d, tm2))
    out["recovered"] = word_state(tm2, 3 * N)
    out["log"] = seg_bytes(d)
    return out


def test_wal_group_commit_batch_journals_one_decide(tmp_path):
    rec = both(group_journal_case, tmp_path)
    assert rec["fsyncs"] == 1
    assert rec["report"]["wal_records_replayed"] == 3
    np.testing.assert_array_equal(
        rec["recovered"]["heap"],
        [t * 10000 + i for t in range(3) for i in range(N)])


def test_wal_encounter_group_journals_one_decide(tmp_path):
    """The encounter-time (DCTL) group window journals its members' redo
    images, gathered from the locked heap words, as one prepare group
    under one decide: the same bytes as the reference's."""
    rec = both(group_journal_case, tmp_path, "dctl")
    assert rec["fsyncs"] == 1
    assert rec["report"]["wal_records_replayed"] == 3
    np.testing.assert_array_equal(
        rec["recovered"]["heap"],
        [t * 10000 + i for t in range(3) for i in range(N)])


# ---------------------------------------------------------------------------
# subprocess SIGKILL drills: the process image is REALLY gone
# ---------------------------------------------------------------------------

_WORKER = {
    "jax": """
        from repro.api.substrate import run
        from repro.core.baselines import TL2
        from repro.core.stm import Multiverse
        from repro.reliability import faultpoints as FP
        from repro.reliability.wal import WriteAheadLog, attach_wal

        def make(backend):
            return (Multiverse(2, start_bg=False)
                    if backend == "multiverse" else TL2(2))
    """,
    "torch": """
        from repro_torch.api.substrate import run
        from repro_torch.core.baselines import TL2
        from repro_torch.core.engine import ArrayHeap
        from repro_torch.core.stm import Multiverse
        from repro_torch.reliability import faultpoints as FP
        from repro_torch.reliability.wal import WriteAheadLog, attach_wal

        def make(backend):
            heap = ArrayHeap(device="cpu")
            return (Multiverse(2, start_bg=False, heap=heap, device="cpu")
                    if backend == "multiverse"
                    else TL2(2, heap=heap, device="cpu"))
    """,
}

_DRILL = """
    import sys
    import numpy as np

    backend, point, wal_dir, n = (sys.argv[1], sys.argv[2], sys.argv[3],
                                  int(sys.argv[4]))
    tm = make(backend)
    tm.alloc(n, 0)
    attach_wal(tm, WriteAheadLog(wal_dir))

    def w0(tx):
        tx.write_bulk(np.arange(n), list(range(n)))
    run(tm, w0, tid=0)                 # the committed prefix

    FP.install(FP.FaultSchedule([FP.Fault(point, 1, "die")]))

    def w1(tx):
        tx.write_bulk(np.arange(n), [v + 1000 for v in range(n)])
    run(tm, w1, tid=1)                 # SIGKILLs itself mid-commit
    sys.exit(3)                        # reached only if the fault missed
"""


def sigkill_case(pkg, tmp_path, backend, point, n):
    """Run the package's worker, assert it was reaped by SIGKILL, and
    recover a fresh store of the same package from the directory."""
    kind = "jax" if pkg is JAX else "torch"
    script = tmp_path / f"worker_{kind}.py"
    script.write_text(textwrap.dedent(_WORKER[kind])
                      + textwrap.dedent(_DRILL))
    wal_dir = str(tmp_path / f"wal_{kind}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.getcwd(), "src") \
        + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(script), backend, point, wal_dir, str(n)],
        env=env, capture_output=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, (
        proc.returncode, proc.stdout, proc.stderr)
    out = scanned(pkg, wal_dir)
    tm2 = pkg.word[backend](2)
    tm2.alloc(n, 0)
    out["report"] = report(pkg.WAL.recover_from_wal(wal_dir, tm2))
    out["violations"] = pkg.REC.check_engine_invariants(tm2)
    out["recovered"] = word_state(tm2, n)
    out["log"] = seg_bytes(wal_dir)
    return out


def check_drill(rec, n):
    ref = np.zeros(n, np.int64)
    for r in rec["records"]:
        if r["decided"]:
            ref[r["addrs"]] = r["values"]
    np.testing.assert_array_equal(rec["recovered"]["heap"], ref)
    assert rec["violations"] == []


def test_wal_sigkill_pre_record_rolls_back(tmp_path):
    rec = both(sigkill_case, tmp_path, "tl2", "pre_claim", N)
    check_drill(rec, N)
    assert not any(r["decided"] for r in rec["records"] if r["tid"] == 1)
    assert 1 not in rec["report"]["rolled_forward"]
    np.testing.assert_array_equal(rec["recovered"]["heap"], np.arange(N))


def test_wal_sigkill_mid_scatter_partial_lane_rolls_forward(tmp_path):
    rec = both(sigkill_case, tmp_path, "tl2", "mid_scatter", N)
    check_drill(rec, N)
    assert any(r["decided"] and r["tid"] == 1 for r in rec["records"])
    assert 1 in rec["report"]["rolled_forward"]
    np.testing.assert_array_equal(rec["recovered"]["heap"],
                                  np.arange(N) + 1000)


def test_wal_sigkill_pre_release_rolls_forward_encounter(tmp_path):
    rec = both(sigkill_case, tmp_path, "multiverse", "pre_release", 32)
    check_drill(rec, 32)
    assert any(r["decided"] and r["tid"] == 1 for r in rec["records"])
    assert 1 in rec["report"]["rolled_forward"]
    np.testing.assert_array_equal(rec["recovered"]["heap"],
                                  np.arange(32) + 1000)


# ---------------------------------------------------------------------------
# the port's own: byte identity, cross-package replay, the supervisor
# ---------------------------------------------------------------------------


def _random_records(seed):
    rng = np.random.default_rng(seed)
    recs = []
    for t in range(6):
        n = int(rng.integers(1, 40))
        recs.append((t, rng.integers(0, 1 << 20, n),
                     rng.integers(-(1 << 62), 1 << 62, n),
                     tuple(int(c) for c in rng.integers(0, 1 << 30, 2)),
                     int(rng.integers(-1, 4)), int(rng.integers(-1, 4))))
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_are_byte_identical(seed, tmp_path):
    """The same records, decides, completes and base image give the same
    segment files, byte for byte, and the same base image members in
    both packages — the port's columns given as tensors, the
    reference's as numpy arrays."""
    recs = _random_records(seed)
    heap = np.random.default_rng(seed).integers(-1000, 1000, 64)
    files = {}
    for pkg in (JAX, PORT):
        d = walled(tmp_path, pkg)
        conv = (lambda x: torch.from_numpy(np.asarray(x))) \
            if pkg is PORT else np.asarray
        with pkg.WAL.WriteAheadLog(d, segment_bytes=1024) as wal:
            t, a, v, c, e, s = recs[0]
            lsn0 = wal.append_prepare(t, conv(a), conv(v), clocks=c,
                                      epoch=e, shard=s)
            wal.append_decide(lsn0)
            lsns = wal.append_prepare_group(
                [(t, conv(a), conv(v), c, e, s)
                 for t, a, v, c, e, s in recs[1:]])
            wal.append_decide_group(lsns[::2])
            wal.append_complete(lsns[0])
            wal.checkpoint(conv(heap), clock=77)
            wal.append_decide(wal.append_prepare(9, [1], [2], clocks=(3,)))
        files[pkg.name] = {
            n: (npz_members(os.path.join(d, n)) if n.endswith(".npz")
                else open(os.path.join(d, n), "rb").read())
            for n in sorted(os.listdir(d))}
    assert files["jax"] == files[PORT.name]
    assert any(n.startswith("base-") for n in files["jax"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("backend", ["tl2", "dctl", "multiverse"])
def test_logs_replay_across_packages(writer, backend, tmp_path):
    """A log written by one package (a committed prefix, a checkpoint, more
    commits, a crash at pre_release) replays in BOTH packages to equal
    heaps, clocks and reports."""
    src = JAX if writer == "jax" else PORT
    FP = src.FP
    d = walled(tmp_path, src)
    tm = src.word[backend](2)
    tm.alloc(N, 0)
    wal = src.WAL.attach_wal(tm, src.WAL.WriteAheadLog(d))
    src.run(tm, lambda tx: tx.write_bulk(np.arange(N), list(range(N))),
            tid=0)
    wal.checkpoint(heap_words(tm, N), tm.clock.load())
    src.run(tm, lambda tx: tx.write_bulk(
        np.arange(0, N, 3), [7] * len(range(0, N, 3))), tid=0)
    FP.install(FP.FaultSchedule([FP.Fault("pre_release", 1, "crash")]))
    with pytest.raises(FP.ProcessCrashed):
        src.run(tm, lambda tx: tx.write_bulk(
            np.arange(8), [v + 1000 for v in range(8)]), tid=1)
    FP.uninstall()
    FP.reset_thread()
    wal.close()
    got = {}
    for pkg in (JAX, PORT):
        fresh = pkg.word[backend](2)
        fresh.alloc(N, 0)
        rep = pkg.WAL.recover_from_wal(d, fresh)
        got[pkg.name] = {"report": report(rep),
                         "violations": pkg.REC.check_engine_invariants(
                             fresh),
                         "recovered": word_state(fresh, N)}
    same(got["jax"], got[PORT.name])
    want = np.arange(N)
    want[0::3] = 7
    want[:8] = np.arange(8) + 1000
    np.testing.assert_array_equal(got["jax"]["recovered"]["heap"], want)
    assert got["jax"]["violations"] == []


def _cold_restart(sup_cls, wal, tmp_path):
    """A supervisor whose restore finds no checkpoint (a cold restart)
    and then scans its log."""
    import types
    state = types.SimpleNamespace(mv=types.SimpleNamespace(live={}),
                                  opt={})
    sup = sup_cls(ckpt_dir=str(tmp_path / "ckpt"), wal=wal)
    try:
        return sup, sup._restore(state)
    finally:
        sup.manager.close()


def test_supervisor_checkpoints_and_restores_through_the_log(tmp_path):
    """A restore with a log attached scans ``wal.dir``: the port reports
    the decided-but-uncompleted tail, where the reference's supervisor
    reads ``wal.path`` — which its ``WriteAheadLog`` does not have — and
    raises inside its failure handler."""
    from repro.runtime.fault_tolerance import TrainSupervisor as JSup
    from repro_torch.runtime.fault_tolerance import TrainSupervisor as TSup

    d = str(tmp_path / "log")
    wal = TWAL.WriteAheadLog(d)
    wal.append_decide(wal.append_prepare(0, [1, 2], [3, 4], clocks=(1,)))
    wal.append_prepare(1, [5], [6], clocks=(2,))
    sup, (step, _) = _cold_restart(TSup, wal, tmp_path)
    assert step == 0
    assert sup.events == [("cold_restart", 0, ""),
                          ("wal_scan", 0,
                           "records=2 undrained=1 torn=0")]
    wal.close()
    jwal = JWAL.WriteAheadLog(str(tmp_path / "jlog"))
    with pytest.raises(AttributeError, match="path"):
        _cold_restart(JSup, jwal, tmp_path)
    jwal.close()

