"""The port's eval subsystem (``repro_torch.eval``) against the JAX
package's (``repro.eval``), on the CPU.

* The registry holds every workload of the reference, with its
  variants (``serving`` with its policy map).
* One short trial of each workload through both packages gives rows with
  the same keys (and the same ``stm_stats`` keys).
* The headline functions give equal output on the same fixed rows.
* ``structrq``'s quiescent ``rq_words`` equals the reference's for the
  same seed and structure.
* ``shardscale``'s quick run holds its 1-shard parity against mvstore
  with no violation.
* ``reliability`` and ``durability``: a quick CPU row of each carries
  the reference row's keys, with kills recovered and the log replayed.
* ``python -m repro_torch.eval --quick --device cpu`` exits 0 on all
  seven workloads; the results file keeps the reference's schema.
"""
import dataclasses
import json

import pytest

import repro.eval as JE
from repro_torch import eval as TE
from repro_torch.eval.__main__ import main


def _short(spec, **params):
    return dataclasses.replace(spec, duration_s=0.25, warmup_s=0.05,
                               params={**spec.params, **params})


def test_workload_registry_names():
    assert set(TE.WORKLOADS) == {"longread", "rwmix", "shardscale",
                                 "structrq", "serving", "reliability",
                                 "durability"}
    assert set(TE.WORKLOADS) == set(JE.WORKLOADS)
    assert TE.WORKLOADS["serving"].POLICY == JE.WORKLOADS["serving"].POLICY
    assert TE.DEFAULT_BACKENDS == JE.DEFAULT_BACKENDS
    assert TE.UNVERSIONED == JE.UNVERSIONED
    for name, w in TE.WORKLOADS.items():
        ref = JE.WORKLOADS[name]
        assert w.metric == ref.metric
        assert getattr(w, "default_backends", None) == \
            getattr(ref, "default_backends", None)
        for quick in (True, False):
            assert w.variants(quick) == [
                TE.TrialSpec(**dataclasses.asdict(s))
                for s in ref.variants(quick)]


def test_unknown_workload():
    with pytest.raises(ValueError, match="unknown workload"):
        TE.run_eval("nope", device="cpu", save=False)


@pytest.mark.parametrize("workload,backend", [("longread", "mvstore"),
                                              ("rwmix", "tl2"),
                                              ("shardscale", "shardstore"),
                                              ("structrq", "multiverse"),
                                              ("serving", "modeq")])
def test_rows_carry_the_reference_keys(workload, backend):
    jw, tw = JE.WORKLOADS[workload], TE.WORKLOADS[workload]
    extra = {"prefill": 60, "key_range": 240, "ref_window_s": 0.05} \
        if workload == "structrq" else {}
    jspec = _short(jw.variants(quick=True)[0], **extra)
    tspec = _short(tw.variants(quick=True)[0], **extra)
    jrow = jw.run_trial(backend, jspec, 3)
    trow = tw.run_trial(backend, tspec, 3, device="cpu")
    assert set(trow) == set(jrow)
    assert set(trow["stm_stats"]) == set(jrow["stm_stats"])
    assert trow["violations"] == 0
    for k in ("workload", "backend", "variant", "seed"):
        assert trow[k] == jrow[k]


@pytest.mark.parametrize("workload", ["reliability", "durability"])
def test_reliability_variants_match_reference(workload):
    """Both workloads' quick and full variants (kill schedule, durable and
    grouped flags) and default backends are the reference's."""
    jw, tw = JE.WORKLOADS[workload], TE.WORKLOADS[workload]
    assert tw.default_backends == jw.default_backends
    assert tw.metric == jw.metric
    for quick in (True, False):
        assert tw.variants(quick) == [
            TE.TrialSpec(**dataclasses.asdict(s))
            for s in jw.variants(quick)]
    if workload == "reliability":
        assert tw.durable is False          # --durable switches it on


@pytest.mark.parametrize("workload,backend,variant", [
    ("reliability", "tl2", "kill60"),
    ("durability", "dctl", "durable-group")])
def test_reliability_quick_rows_carry_the_reference_keys(workload, backend,
                                                        variant):
    """A quick CPU row of each workload has the reference row's keys; the
    kill row recovered every kill, the durable row's restart drill
    replayed the log into a fresh engine, and nothing was violated."""
    jw, tw = JE.WORKLOADS[workload], TE.WORKLOADS[workload]
    jspec = next(s for s in jw.variants(True) if s.variant == variant)
    tspec = next(s for s in tw.variants(True) if s.variant == variant)
    jrow = jw.run_trial(backend, jspec, 1)
    trow = tw.run_trial(backend, tspec, 1, device="cpu")
    assert set(trow) == set(jrow)
    assert set(trow["stm_stats"]) == set(jrow["stm_stats"])
    assert trow["violations"] == 0
    assert trow["post_invariant_failures"] == []
    if workload == "reliability":
        assert trow["kills"] > 0 and trow["recoveries"] == trow["kills"]
    else:
        assert trow["restart_drill_failures"] == []
        assert trow["wal_records_replayed"] > 0
        assert set(trow["wal_stats"]) == set(jrow["wal_stats"])


@pytest.mark.parametrize("kind", ["hashmap", "extbst", "abtree"])
def test_structrq_quiescent_rq_words_match(kind):
    """With no updater the structure after the prefill is the seed's
    alone, so the probe's read count must equal the reference's."""
    words = []
    for ev, kw in ((JE, {}), (TE, {"device": "cpu"})):
        spec = next(s for s in ev.WORKLOADS["structrq"].variants(False)
                    if s.variant == kind)
        spec = dataclasses.replace(
            _short(spec, prefill=120, key_range=480, ref_window_s=0.02),
            n_readers=1, n_updaters=0, duration_s=0.05)
        row = ev.WORKLOADS["structrq"].run_trial("multiverse", spec, 5,
                                                 **kw)
        assert row["violations"] == 0
        words.append(row["rq_words"])
    assert words[1] == words[0] > 120


def _longread_rows():
    return [
        {"backend": "multiverse", "scan_size": 4096, "scans_per_sec": 9.0},
        {"backend": "multiverse", "scan_size": 256, "scans_per_sec": 1.0},
        {"backend": "tl2", "scan_size": 4096, "scans_per_sec": 2.0},
        {"backend": "tinystm", "scan_size": 4096, "scans_per_sec": 0.5},
        {"backend": "mvstore", "scan_size": 4096, "scans_per_sec": 12.0},
    ]


def _rwmix_rows():
    return [
        {"backend": "multiverse", "write_words": 1024,
         "updates_per_sec": 80.0, "violations": 0},
        {"backend": "multiverse", "write_words": 256,
         "updates_per_sec": 300.0, "violations": 1},
        {"backend": "tl2", "write_words": 1024, "updates_per_sec": 100.0,
         "violations": 0},
        {"backend": "norec", "write_words": 1024,
         "updates_per_sec": 170.0, "violations": 2},
    ]


def _shardscale_rows():
    return [
        {"backend": "shardstore", "n_shards": 1, "updates_per_sec": 100.0,
         "failed_updates": 0, "violations": 0, "parity_ok": True},
        {"backend": "shardstore", "n_shards": 2, "updates_per_sec": 170.0,
         "failed_updates": 3, "violations": 0, "parity_ok": None},
        {"backend": "shardstore", "n_shards": 4, "updates_per_sec": 150.0,
         "failed_updates": 1, "violations": 0, "parity_ok": None},
        {"backend": "mvstore", "n_shards": 2, "updates_per_sec": 9.0,
         "failed_updates": 0, "violations": 4},
    ]


def _structrq_rows():
    return [
        {"backend": "multiverse", "structure": s, "rq_words": w,
         "rq_solo_per_sec": r, "arrayscan_per_sec": a, "rq_vs_scan": r / a}
        for s, w, r, a in (("hashmap", 1824, 90.0, 120.0),
                           ("abtree", 9000, 10.0, 80.0))
    ] + [{"backend": "tl2", "structure": "extbst", "rq_words": 7995,
          "rq_solo_per_sec": 3.0, "arrayscan_per_sec": 9.0,
          "rq_vs_scan": 1 / 3}]


def _reliability_rows():
    base = {"workload": "reliability", "write_words": 256}
    return [
        dict(base, backend="multiverse", variant="nofault", kill_every=0,
             kills=0, recoveries=0, rolled_forward=0, rolled_back=0,
             updates_per_sec=100.0, violations=0),
        dict(base, backend="multiverse", variant="kill200",
             kill_every=200, kills=3, recoveries=3, rolled_forward=2,
             rolled_back=1, updates_per_sec=70.0, violations=0),
        dict(base, backend="tl2", variant="nofault", kill_every=0, kills=0,
             recoveries=0, rolled_forward=0, rolled_back=0,
             updates_per_sec=90.0, violations=0),
        dict(base, backend="tl2", variant="kill200", kill_every=200,
             kills=2, recoveries=1, rolled_forward=1, rolled_back=0,
             updates_per_sec=20.0, violations=1),
    ]


def _durability_rows():
    rows = []
    for backend, rates in (("tl2", (100.0, 40.0, 200.0, 150.0)),
                           ("dctl", (80.0, 60.0, 90.0, 30.0))):
        for (v, d, g), rate in zip((("inmem", False, False),
                                    ("durable", True, False),
                                    ("inmem-group", False, True),
                                    ("durable-group", True, True)), rates):
            rows.append({
                "workload": "durability", "backend": backend,
                "variant": v, "durable": d, "grouped": g,
                "updates_per_sec": rate, "violations": 0,
                "grouped_members": 8 if g else 0,
                "commit_groups": 4 if g else 0,
                "wal_records_replayed": 12 if d else 0,
                "wal_stats": {"fsyncs": 5} if d else {}})
    return rows


def _serving_rows():
    base = {"offered": 100, "shed": 0, "failed_aborts": 0, "violations": 0,
            "snapshot_aborts": 0, "mixed_version_requests": 0}
    return [
        dict(base, backend="multiverse", target_qps=60.0, qps=58.0,
             completed=100, p50_ms=21.0, p99_ms=30.0),
        dict(base, backend="multiverse", target_qps=120.0, qps=110.0,
             completed=97, p50_ms=22.0, p99_ms=31.0),
        dict(base, backend="modeq", target_qps=120.0, qps=20.0,
             completed=20, p50_ms=60.0, p99_ms=200.0, failed_aborts=70,
             shed=10, snapshot_aborts=560),
        dict(base, backend="unversioned", target_qps=120.0, qps=111.0,
             completed=100, p50_ms=20.0, p99_ms=29.0,
             mixed_version_requests=40),
    ]


@pytest.mark.parametrize("name,rows", [("longread", _longread_rows),
                                       ("rwmix", _rwmix_rows),
                                       ("structrq", _structrq_rows),
                                       ("shardscale", _shardscale_rows),
                                       ("reliability", _reliability_rows),
                                       ("durability", _durability_rows),
                                       ("serving", _serving_rows)])
def test_headlines_match_reference(name, rows):
    fn = f"{name}_headline"
    from repro.eval import driver as JD
    got = getattr(TE, fn)(rows())
    assert got == getattr(JD, fn)(rows())
    assert got
    assert getattr(TE, fn)([]) == getattr(JD, fn)([]) == {}


@pytest.mark.parametrize("workload,backends", [
    ("longread", ["multiverse", "tl2", "mvstore"]),
    ("rwmix", ["multiverse", "norec"]),
    ("structrq", ["multiverse", "dctl"]),
    ("shardscale", ["shardstore"]),
    ("reliability", ["tl2"]),
    ("durability", ["dctl"])])
def test_cli_quick_on_the_cpu(workload, backends, capsys):
    rc = main(["--workload", workload, "--quick", "--device", "cpu",
               "--backends", *backends, "--seed", "2", "--no-save"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "headline" in out
    assert "results ->" not in out
    assert all(f" {b} " in out for b in backends)


def test_reliability_cli_durable_flag(capsys):
    """``--durable`` journals the kill/recover trials; the rows say so and
    carry the log's counters."""
    w = TE.WORKLOADS["reliability"]
    try:
        rc = main(["--workload", "reliability", "--quick", "--device",
                   "cpu", "--backends", "dctl", "--durable", "--no-save"])
        assert w.durable
    finally:
        w.durable = False
    assert rc == 0
    out = capsys.readouterr().out
    assert "headline @ kill60: dctl" in out and "kills=" in out


def test_shardscale_quick_holds_parity_on_the_cpu():
    rows, path = TE.run_eval("shardscale", quick=True, device="cpu",
                             save=False)
    assert path is None
    assert [r["n_shards"] for r in rows] == [1, 2]
    assert rows[0]["parity_ok"] is True
    assert all(r["violations"] == 0 for r in rows)
    assert all(r["updates_per_sec"] > 0 for r in rows)
    h = TE.shardscale_headline(rows)
    assert h["parity_ok"] and h["violations"] == 0


def test_shardscale_cli_shards_flag(capsys):
    w = TE.WORKLOADS["shardscale"]
    try:
        rc = main(["--workload", "shardscale", "--quick", "--device", "cpu",
                   "--shards", "1", "4", "--no-save"])
        assert [s.variant for s in w.variants(True)] == ["s1", "s4"]
    finally:
        w.shards = None
    assert rc == 0
    out = capsys.readouterr().out
    assert "shards= 4" in out and "parity=ok" in out
    assert "headline" not in out           # no 2-shard row to compare


def test_results_file_matches_the_reference_schema(tmp_path):
    from repro.eval.results import build_meta

    rows = [dict(r, workload="longread", variant=f"scan{r['scan_size']}",
                 mode_transitions=i)
            for i, r in enumerate(_longread_rows())]
    path = TE.save_results("longread", rows, 7, out_dir=str(tmp_path),
                           extra_meta={"workload": "longread"})
    assert path == str(tmp_path / "eval_longread.json")
    payload = json.loads((tmp_path / "eval_longread.json").read_text())
    assert payload["rows"] == rows
    assert payload["meta"] == build_meta(
        "longread", rows, 7, extra={"workload": "longread"})


def test_cli_no_save_and_list(capsys):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in JE.WORKLOADS:
        assert name in out
    assert "not ported yet" not in out
    assert main(["--workload", "serving", "--quick", "--device", "cpu",
                 "--no-save"]) == 0
    out = capsys.readouterr().out
    assert "headline @ qps50: multiverse=" in out
    assert "results ->" not in out
    assert all(f" {b} " in out for b in ("multiverse", "modeq",
                                         "unversioned"))
