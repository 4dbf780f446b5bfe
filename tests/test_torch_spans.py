"""The span layer (``repro_torch.runtime.spans``): off, it records nothing
and never opens a profiler annotation; under the profiler or
``recording()`` it keeps nesting, threads and attrs on the profiler's
clock, one session at a time; the trainer's and the server's spans are
where the work is; and the benchmark's readers of them give numbers whose
parts fit inside their whole."""
from __future__ import annotations

import statistics
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.harness import common
from perfbench.tests import smoke
from repro_torch.configs import MVStoreConfig, ShapeConfig, smoke_config
from repro_torch.core.mvcontroller import MVController
from repro_torch.launch.serve import Server
from repro_torch.launch.train import Trainer
from repro_torch.runtime import spans

ARCH = "mamba2-780m"


def _names(recs):
    return Counter(r.name for r in recs)


def _raise(*a, **k):
    raise AssertionError("record_function opened with no profiler")


def _trainer(mode="U"):
    mv = MVStoreConfig(mode=mode, fused_commit=mode == "U")
    return Trainer(smoke_config(ARCH), ShapeConfig("train", 32, 2, "train"),
                   mvcfg=mv, device="cpu",
                   controller=MVController(mvcfg=mv, start_bg=False))


def _steps(tr, n, start=0):
    st = tr.state
    for s in range(start, start + n):
        st, met = tr.train_step(st, tr.batch_at(s))
        float(met["loss"])
    tr.state = st


def _server(mode="Q"):
    return Server(smoke_config(ARCH), batch=2, prompt_len=16, max_len=24,
                  mvcfg=MVStoreConfig(mode=mode), device="cpu")


def _prompts(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 16)).astype(
        np.int32)


# -- off -------------------------------------------------------------------
def test_off_records_nothing_and_opens_no_annotation(monkeypatch):
    with spans.recording():
        pass
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert spans.span("a") is spans.span("b", rid=1)
    with spans.span("a"):
        with spans.span("b", rid=1):
            pass
    tr = _trainer()
    _steps(tr, 1)
    _server().serve_batch(_prompts(3), 3)
    assert spans.records() == [] and spans.dropped() == 0


# -- under the profiler ----------------------------------------------------
def _annotations(prof, names):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_profiled_spans_nest_by_thread_and_sit_on_their_annotations():
    opened, release = threading.Event(), threading.Event()

    def other():
        opened.wait(10)
        with spans.span("t.other", rid=9):
            release.wait(10)

    th = threading.Thread(target=other)
    th.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("t.outer", rid=7):
            opened.set()
            for _ in range(50):
                with spans.span("t.inner", rids=[1, 2]):
                    torch.ones(8).sum()
            release.set()
            th.join(10)
    assert not th.is_alive()
    recs = spans.records()
    assert _names(recs) == {"t.outer": 1, "t.inner": 50, "t.other": 1}
    outer = next(r for r in recs if r.name == "t.outer")
    oth = next(r for r in recs if r.name == "t.other")
    assert outer.parent is None and outer.attrs == {"rid": 7}
    assert oth.parent is None and oth.attrs == {"rid": 9}
    assert oth.thread != outer.thread
    assert outer.start_ns <= oth.start_ns and oth.end_ns <= outer.end_ns
    inner = [r for r in recs if r.name == "t.inner"]
    for r in inner:
        assert r.parent is outer and r.attrs == {"rids": [1, 2]}
        assert r.thread == outer.thread
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    # each main-thread span against its own annotation, the nearest start
    ann = _annotations(prof, {"t.outer", "t.inner"})
    offs = []
    for r in inner + [outer]:
        s, e = min(ann[r.name], key=lambda iv: abs(iv[0] - r.start_ns))
        offs += [abs(r.start_ns - s), abs(r.end_ns - e)]
    assert max(offs) < 1_000_000, max(offs)
    assert statistics.median(offs) < 100_000, statistics.median(offs)


# -- sessions --------------------------------------------------------------
def test_recording_needs_no_profiler_and_sessions_do_not_mix():
    with spans.recording():
        with spans.span("s.one", rid=1):
            pass
    first = spans.records()
    assert [(r.name, r.attrs) for r in first] == [("s.one", {"rid": 1})]
    with spans.recording():
        with spans.span("s.two"):
            pass
    assert [r.name for r in spans.records()] == ["s.two"]
    assert [r.name for r in first] == ["s.one"]
    for stretch in ("p.one", "p.two"):
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span(stretch):
                pass
        with spans.span("off"):       # the profiler off between stretches
            pass
        assert [r.name for r in spans.records()] == [stretch]


def test_a_session_counts_what_it_drops_past_the_cap(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    with spans.recording():
        for i in range(5):
            with spans.span("c", i=i):
                pass
    assert [r.attrs["i"] for r in spans.records()] == [0, 1, 2]
    assert spans.dropped() == 2
    with spans.recording():
        pass
    assert spans.dropped() == 0 and spans.records() == []


def test_threads_lose_no_record_or_drop(monkeypatch):
    """More threads than cores, a short switch interval: every span closed
    is kept or counted as dropped."""
    monkeypatch.setattr(spans, "CAP", 500)
    n_threads, each = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording():
            def work():
                for i in range(each):
                    with spans.span("w.outer"):
                        with spans.span("w.inner", i=i):
                            pass
            ths = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(30)
            assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(switch)
    recs = spans.records()
    assert len(recs) == 500
    assert len(recs) + spans.dropped() == 2 * n_threads * each
    for r in recs:
        if r.name == "w.inner":
            assert r.parent.name == "w.outer" and r.parent.thread == r.thread


# -- the program's spans -----------------------------------------------------
@pytest.mark.parametrize("mode", ["U", "Q"])
def test_train_step_spans(mode):
    tr = _trainer(mode)
    _steps(tr, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(tr, 2, start=1)
    recs = spans.records()
    n = _names(recs)
    assert (n["train.step"], n["steps.forward"], n["steps.backward"],
            n["mvstore.commit"]) == (2, 2, 2, 2)
    assert n["ssd.backward"] == 2 * smoke_config(ARCH).n_layers
    main = next(r for r in recs if r.name == "train.step").thread
    for r in recs:
        if r.name in ("steps.forward", "steps.backward", "mvstore.commit"):
            assert r.parent.name == "train.step"
        if r.name == "ssd.backward":    # by time, whatever the thread
            assert any(b.start_ns <= r.start_ns <= r.end_ns <= b.end_ns
                       for b in recs if b.name == "steps.backward")
            if r.thread == main:
                assert r.parent.name == "steps.backward"


@pytest.mark.parametrize("mode", ["Q", "U"])
def test_server_spans_carry_their_requests(mode):
    srv = _server(mode)
    srv.serve_batch(_prompts(2, seed=1), 2)
    with profile(activities=[ProfilerActivity.CPU]):
        reqs = [srv.submit(p, 4) for p in _prompts(3, seed=2)]
        while any(r.outcome.value == "pending" for r in reqs):
            srv.pump()
    recs = spans.records()
    pre = [r for r in recs if r.name == "serve.prefill"]
    dec = [r for r in recs if r.name == "serve.decode"]
    assert sorted(r.attrs["rid"] for r in pre) == sorted(q.rid for q in reqs)
    assert dec
    for d in dec:
        kids = Counter(r.name for r in recs if r.parent is d)
        # and one ``mamba.decode`` a Mamba layer
        assert kids == {"mvstore.resolve": 1, "serve.readback": 1,
                        "mamba.decode": smoke_config(ARCH).n_layers}, kids
    for p in pre:
        kids = Counter(r.name for r in recs if r.parent is p)
        assert kids == {"mvstore.resolve": 1, "serve.readback": 2}, kids
    for q in reqs:      # a request's timeline: its prefill, then its steps
        p = next(r for r in pre if r.attrs["rid"] == q.rid)
        mine = [d for d in dec if q.rid in d.attrs["rids"]]
        assert len(mine) == len(q.tokens) - 1
        assert all(d.start_ns >= p.end_ns for d in mine)


# -- the benchmark's readers -------------------------------------------------
SPAN_METRICS = {
    "mamba2-780m.train_U": ["steps.forward_issue_ms",
                            "steps.backward_issue_ms",
                            "ssd.backward_issue_ms", "mvstore.commit_ms"],
    "deepseek-7b.serve_Q": ["serve.decode_issue_ms", "serve.decode_wait_ms",
                            "mvstore.resolve_ms"],
    "granite-4.0-h-small.serve_H": ["serve.decode_issue_ms",
                                    "serve.decode_wait_ms",
                                    "mvstore.resolve_ms",
                                    "mamba.decode_issue_ms",
                                    "moe.decode_issue_ms"],
}
MIXES = {"mamba2-780m.train_U": smoke.TRAIN_MIX,
         "deepseek-7b.serve_Q": smoke.SERVE_MIX,
         "granite-4.0-h-small.serve_H": smoke.SERVE_MIX}


def _read(name, out=None, ctx=None):
    return common.load_module("layer_metrics", name).read(out, ctx)


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced CPU run, read as ``run.py`` reads it: every
    per-layer metric of the cell, right after its driver returns."""
    spec = common.benchmark_spec()
    got = {}
    for cell, mix in MIXES.items():
        ctx = smoke.context(cell, mix=mix, trace=True, seconds=1.5,
                            limits={"served_logit_gap": 0.02})
        out = common.load_module("drivers", ctx.traffic["driver"]).run(ctx)
        assert out.correct, (cell, out.checks)
        got[cell] = {m["name"]: _read(m["name"], out, ctx)
                     for m in common.cell_metrics(spec, cell, True)}
    return got


def test_span_metrics_are_the_benchmark_entries():
    spec = common.benchmark_spec()
    entries = {m["name"]: m for m in spec["per_layer"]
               if m["source"] == "program_span"
               and m["name"] != "train.host_issue_ms"}
    cells = {}
    for cell, names in SPAN_METRICS.items():
        for n in names:
            cells.setdefault(n, []).append(cell)
    assert {n: entries[n]["workloads"] for n in entries} == cells


@pytest.mark.parametrize("cell,name", [(c, n) for c, ns in
                                       SPAN_METRICS.items() for n in ns])
def test_each_reader_gives_a_number(traced, cell, name):
    v = traced[cell][name]
    assert isinstance(v, float) and v >= 0.0, (name, v)


def test_the_parts_fit_inside_their_whole(traced):
    t = traced["mamba2-780m.train_U"]
    parts = (t["steps.forward_issue_ms"] + t["steps.backward_issue_ms"]
             + t["mvstore.commit_ms"])
    assert 0 < parts <= t["train.host_issue_ms"]
    assert 0 < t["ssd.backward_issue_ms"] <= t["steps.backward_issue_ms"]
    s = traced["deepseek-7b.serve_Q"]
    step = s["serve.decode_issue_ms"] + s["serve.decode_wait_ms"]
    assert 0 < step <= s["serve.decode_step_ms"]
    assert 0 < s["mvstore.resolve_ms"] <= s["serve.decode_issue_ms"]


@pytest.mark.parametrize("name", sorted({n for ns in SPAN_METRICS.values()
                                         for n in ns}))
def test_readers_give_none_without_spans(monkeypatch, name):
    with spans.recording():
        pass
    assert _read(name) is None
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    monkeypatch.delattr("repro_torch.runtime.spans")
    assert _read(name) is None
