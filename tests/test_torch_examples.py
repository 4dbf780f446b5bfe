"""The port's example drivers (``repro_torch.examples``) and scripts
against the JAX package's (``examples/``, ``scripts/``), on the CPU.

* quickstart: the transfer schedule, single-threaded, leaves every heap
  word equal in both packages on multiverse and tl2; the port's scalar
  and bulk audits see the whole balance on every backend; its ``main``
  runs on every backend.
* bakeoff: each microbenchmark at a small size through both packages —
  the commit and group-commit benches' heaps word for word, the group
  stats, ``size_query``'s count — and ``bake``'s row keys.  Timing rows
  are never compared.
* train_lm: the argv it hands ``launch.train.main``, equal to the
  reference's but for ``--device``.
* serve_snapshots: every request completes with its tokens, at clocks
  that never decrease and lie within the trainer's.
* ``scripts/smoke_torch.sh --device cpu`` exits 0.
"""
import contextlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.api as JA
import repro.core.engine.groupcommit as JG
import repro.structs.hashmap as JH
import repro_torch.api as TA
import repro_torch.core.engine.groupcommit as TG
import repro_torch.structs.hashmap as TH
from repro.configs.paper_stm import MultiverseParams as JParams
from repro_torch.configs.paper_stm import MultiverseParams as TParams
from repro_torch.core.engine.traverse import host_words
from repro_torch.examples import bakeoff as TB
from repro_torch.examples import quickstart as TQ
from repro_torch.examples import serve_snapshots as TS
from repro_torch.examples import train_lm as TL

ROOT = Path(__file__).resolve().parent.parent
BACKENDS = ("dctl", "multiverse", "mvstore", "norec", "shardstore",
            "tinystm", "tl2")


def _reference(name):
    """``examples/<name>.py`` of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JB = _reference("bakeoff")
JQ = _reference("quickstart")
JT = _reference("train_lm")


def test_port_lists_the_references_backends():
    assert TA.backend_names() == JA.backend_names() == BACKENDS


# -- quickstart --------------------------------------------------------------

def _reference_transfers(backend, n):
    tm = JA.make_tm(backend, n_threads=3,
                    params=JParams(k1=4, lock_table_bits=10))
    base = tm.alloc(JQ.N_ACCOUNTS, JQ.INITIAL)

    @JA.atomic(tm)
    def transfer(tx, src, dst, amt):          # examples/quickstart.py
        a = tx.read(base + src)
        b = tx.read(base + dst)
        tx.write(base + src, a - amt)
        tx.write(base + dst, b + amt)

    for i in range(n):
        src, dst = i % JQ.N_ACCOUNTS, (i * 13 + 7) % JQ.N_ACCOUNTS
        if src != dst:
            transfer(src, dst, 5, tid=i % 2)
    words = JA.run(tm, lambda tx: [tx.read(base + i)
                                   for i in range(JQ.N_ACCOUNTS)], tid=2)
    tm.stop()
    return [int(w) for w in words]


def _port_bank(backend):
    tm = TA.make_tm(backend, n_threads=3,
                    params=TParams(k1=4, lock_table_bits=10),
                    array_heap=True, device="cpu")
    return tm, tm.alloc(TQ.N_ACCOUNTS, TQ.INITIAL)


@pytest.mark.parametrize("backend", ["multiverse", "tl2"])
def test_quickstart_transfers_match_the_reference(backend):
    n = 300
    tm, base = _port_bank(backend)
    transfer = TQ.make_transfer(tm, base)
    for i in range(n):
        src, dst = TQ.pair(i)
        if src != dst:
            transfer(src, dst, 5, tid=i % 2)
    got = TA.run(tm, lambda tx: [tx.read(base + i)
                                 for i in range(TQ.N_ACCOUNTS)], tid=2)
    tm.stop()
    assert (TQ.N_ACCOUNTS, TQ.INITIAL) == (JQ.N_ACCOUNTS, JQ.INITIAL)
    want = _reference_transfers(backend, n)
    assert [int(w) for w in got] == want
    assert sum(want) == JQ.N_ACCOUNTS * JQ.INITIAL
    assert want != [JQ.INITIAL] * JQ.N_ACCOUNTS


@pytest.mark.parametrize("backend", BACKENDS)
def test_quickstart_audits_see_every_balance(backend):
    tm, base = _port_bank(backend)
    transfer = TQ.make_transfer(tm, base)
    for i in range(40):
        src, dst = TQ.pair(i)
        if src != dst:
            transfer(src, dst, 5, tid=i % 2)
    scalar = TA.run(tm, lambda tx: sum(tx.read(base + i)
                                       for i in range(TQ.N_ACCOUNTS)), tid=2)
    bulk = TA.run(tm, lambda tx: TQ.bulk_total(
        tx.read_bulk(range(base, base + TQ.N_ACCOUNTS))), tid=2)
    tm.stop()
    assert scalar == bulk == TQ.N_ACCOUNTS * TQ.INITIAL
    assert type(bulk) is int


@pytest.mark.parametrize("backend", BACKENDS)
def test_quickstart_main_on_every_backend(backend, capsys):
    out = TQ.main(["--backend", backend, "--device", "cpu"])
    assert out["totals"] == [TQ.N_ACCOUNTS * TQ.INITIAL] * 5
    assert out["stats"]["backend"] == backend
    assert out["stats"]["commits"] > 0
    printed = capsys.readouterr().out
    assert f"backend={backend} " in printed
    assert printed.count("(consistent)") == 5


# -- bakeoff -----------------------------------------------------------------

@contextlib.contextmanager
def _capture(monkeypatch, module):
    """Records every substrate ``module.make_tm`` builds and the ranges
    it allocates: ``[(tm, [(base, n), ...]), ...]``."""
    made = []
    real = module.make_tm

    def make_tm(*args, **kw):
        tm = real(*args, **kw)
        allocs = []
        alloc = tm.alloc

        def recording(n, *a, **k):
            base = alloc(n, *a, **k)
            allocs.append((base, n))
            return base

        tm.alloc = recording
        made.append((tm, allocs))
        return tm

    monkeypatch.setattr(module, "make_tm", make_tm)
    yield made
    monkeypatch.undo()


def _heap_words(tm, base, n, port):
    words = tm.raw.heap.gather(np.arange(base, base + n, dtype=np.int64))
    arr = host_words(words) if port else np.asarray(words)
    return [int(w) for w in arr]


def test_bakeoff_bake_rows_carry_the_references_keys():
    got = TB.bake("multiverse", 0.2, device="cpu")
    want = JB.bake("multiverse", 0.2)
    assert list(got) == list(want)
    assert got["backend"] == "multiverse" and got["audits"] > 0


def test_bakeoff_validation_and_read_bulk_rows():
    got = TB.validation_microbench(sizes=(256,), repeats=1, device="cpu")
    want = JB.validation_microbench(sizes=(256,), repeats=1)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["reads"] for r in got] == [256]
    got = TB.readbulk_microbench(sizes=(1024,), repeats=1, device="cpu")
    want = JB.readbulk_microbench(sizes=(1024,), repeats=1)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["reads"] for r in got] == [1024]


def test_bakeoff_commit_pipeline_heaps_match(monkeypatch):
    heaps = []
    for mod, port in ((TB, True), (JB, False)):
        with _capture(monkeypatch, mod) as made:
            kw = {"device": "cpu"} if port else {}
            rows = mod.commitbulk_microbench(sizes=(256,), repeats=1, **kw)
        (tm, allocs), = made
        (base, _), = allocs
        heaps.append(_heap_words(tm, base, 256, port))
        assert [r["writes"] for r in rows] == [256]
    assert heaps[0] == heaps[1] == list(range(1, 257))


def test_bakeoff_group_commit_heaps_and_stats_match(monkeypatch):
    results = []
    for mod, port in ((TB, True), (JB, False)):
        gc = TG if port else JG
        stats = []

        class Recording(gc.CommitBatcher):
            def commit_all(self):
                out = super().commit_all()
                stats.append({k: self.stats[k] for k in ("groups",
                                                         "grouped")})
                return out

        monkeypatch.setattr(gc, "CommitBatcher", Recording)
        with _capture(monkeypatch, mod) as made:
            kw = {"device": "cpu"} if port else {}
            rows = mod.groupcommit_microbench(n_txns=(2, 4), words=64,
                                              repeats=2, **kw)
        (tm, allocs), = made
        (base, n), = allocs
        results.append((_heap_words(tm, base, n, port), stats,
                        [(r["txns"], r["words"]) for r in rows]))
    assert results[0] == results[1]
    assert results[0][1] == [{"groups": 1, "grouped": 2}] * 2 + \
        [{"groups": 1, "grouped": 4}] * 2


def test_bakeoff_structrq_counts_match(monkeypatch):
    counts = []
    for mod, hm, kw in ((TB, TH, {"device": "cpu"}), (JB, JH, {})):
        seen = []
        real = hm.HashMap.size_query

        def size_query(self, tx, real=real, seen=seen):
            n = real(self, tx)
            seen.append(n)
            return n

        monkeypatch.setattr(hm.HashMap, "size_query", size_query)
        rows = mod.structrq_microbench(n_keys=512, n_buckets=128,
                                       repeats=1, **kw)
        monkeypatch.undo()
        assert [r["keys"] for r in rows] == [512]
        counts.append(seen)
    assert counts[0] == counts[1] == [512]


# -- train_lm ----------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    [], ["--full"], ["--steps", "7"],
    ["--arch", "mamba2-780m", "--steps", "50", "--inject-failure-at", "30"],
    ["--full", "--inject-failure-at", "3", "--arch", "deepseek-7b"],
])
def test_train_lm_maps_flags_as_the_reference(flags, monkeypatch):
    seen = []
    for mod, extra in ((TL, ["--device", "cpu"]), (JT, [])):
        monkeypatch.setattr(mod, "train_main",
                            lambda argv: seen.append(argv) or 0)
        monkeypatch.setattr(sys, "argv", ["train_lm.py"] + flags)
        with pytest.raises(SystemExit) as e:
            mod.main(flags + extra) if mod is TL else mod.main()
        assert e.value.code == 0
    port, ref = seen
    assert port[-2:] == ["--device", "cpu"]
    assert port[:-2] == ref
    assert ("--smoke" in ref) == ("--full" not in flags)


def test_train_lm_runs_the_trainer_on_the_cpu(tmp_path, monkeypatch,
                                              capsys):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        TL.main(["--steps", "2", "--device", "cpu"])
    assert e.value.code == 0
    assert "done on cpu: 2 steps, restarts=0" in capsys.readouterr().out


# -- serve_snapshots ---------------------------------------------------------

def test_serve_snapshots_on_the_cpu(capsys):
    out = TS.main(["--steps", "4", "--requests", "2", "--device", "cpu"])
    reqs, clocks = out["requests"], out["clocks"]
    assert len(reqs) == 2 and len(clocks) == 5
    assert clocks == sorted(clocks) and clocks[-1] > clocks[0]
    for r in reqs:
        assert r.outcome is TS.Outcome.COMPLETED
        assert len(r.tokens) == r.max_new == 8
        assert r.served_clocks == sorted(r.served_clocks)
        assert clocks[0] <= r.served_clocks[0] <= r.served_clocks[-1] \
            <= clocks[-1]
    assert np.isfinite(out["loss"])
    assert out["stats"]["commits"] == 2
    assert "2 served requests" in capsys.readouterr().out


# -- scripts/smoke_torch.sh ---------------------------------------------------

def test_smoke_torch_script_on_the_cpu():
    env = dict(os.environ, SMOKE_TIMEOUT="120")
    env.pop("SMOKE_BACKEND", None)
    out = subprocess.run(
        ["bash", str(ROOT / "scripts" / "smoke_torch.sh"), "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("(consistent)") == 5
    assert "backend=multiverse " in out.stdout
    assert out.stdout.strip().endswith("smoke ok (backend=multiverse)")
