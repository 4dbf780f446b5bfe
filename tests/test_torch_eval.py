"""The port's eval subsystem (``repro_torch.eval``) against the JAX
package's (``repro.eval``), on the CPU.

* The registry holds the three ported workloads; the other four raise
  "not ported yet".
* One short trial of each workload through both packages gives rows with
  the same keys (and the same ``stm_stats`` keys).
* The headline functions give equal output on the same fixed rows.
* ``structrq``'s quiescent ``rq_words`` equals the reference's for the
  same seed and structure.
* ``python -m repro_torch.eval --quick --device cpu`` exits 0 on all
  three workloads; the results file keeps the reference's schema.
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
    assert set(TE.WORKLOADS) == {"longread", "rwmix", "structrq"}
    assert set(TE.WORKLOADS) | set(TE.NOT_PORTED) == set(JE.WORKLOADS)
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


@pytest.mark.parametrize("name", sorted(JE.WORKLOADS.keys()
                                        - {"longread", "rwmix",
                                           "structrq"}))
def test_unported_workload_says_so(name):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TE.run_eval(name, device="cpu", save=False)


def test_unknown_workload():
    with pytest.raises(ValueError, match="unknown workload"):
        TE.run_eval("nope", device="cpu", save=False)


@pytest.mark.parametrize("workload,backend", [("longread", "mvstore"),
                                              ("rwmix", "tl2"),
                                              ("structrq", "multiverse")])
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


def _structrq_rows():
    return [
        {"backend": "multiverse", "structure": s, "rq_words": w,
         "rq_solo_per_sec": r, "arrayscan_per_sec": a, "rq_vs_scan": r / a}
        for s, w, r, a in (("hashmap", 1824, 90.0, 120.0),
                           ("abtree", 9000, 10.0, 80.0))
    ] + [{"backend": "tl2", "structure": "extbst", "rq_words": 7995,
          "rq_solo_per_sec": 3.0, "arrayscan_per_sec": 9.0,
          "rq_vs_scan": 1 / 3}]


@pytest.mark.parametrize("name,rows", [("longread", _longread_rows),
                                       ("rwmix", _rwmix_rows),
                                       ("structrq", _structrq_rows)])
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
    ("structrq", ["multiverse", "dctl"])])
def test_cli_quick_on_the_cpu(workload, backends, capsys):
    rc = main(["--workload", workload, "--quick", "--device", "cpu",
               "--backends", *backends, "--seed", "2", "--no-save"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "headline" in out
    assert "results ->" not in out
    assert all(f" {b} " in out for b in backends)


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
    assert "not ported yet" in out
    with pytest.raises(NotImplementedError, match="not ported yet"):
        main(["--workload", "serving", "--device", "cpu", "--no-save"])
