"""The port's snapshot-serving service (``repro_torch.serve.service``)
against the JAX package's, on the CPU.

* The service cases of ``tests/test_serve.py`` run on both packages'
  copies (the port's store on the CPU): the closed-loop occupancy floor,
  the Mode-U open loop under a committing trainer (at the reference's
  8-slot ring, where a reader may abort only on a ring overflow, and at
  256 slots, where none may abort), and the three hand-driven schedules (Mode U,
  Mode Q and ``live`` with a commit between decode steps) and a Mode-U
  ring overflow, whose pinned clocks, aborts and outcomes must be equal
  step for step in both packages.
* ``OpenLoopLoadGen`` gives the same arrivals for the same seed and
  ``ServiceConfig`` the same defaults.
* The torn-read check counts a view torn within a block and one torn
  across blocks once each, in both packages (the port reduces the view
  on its device and brings one flag home).
* ``python -m repro_torch.serve --quick --device cpu`` exits 0; without
  ``--device`` it runs on the card and raises without one.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as J_SERVE
import repro_torch.serve as T_SERVE
from repro.configs import MVStoreConfig as JMVStoreConfig
from repro.core import mvstore as J_MV
from repro.serve import service as J_SERVICE
from repro_torch.configs import MVStoreConfig
from repro_torch.core import mvstore as T_MV
from repro_torch.serve import service as T_SERVICE

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {"jax": J_SERVE, "port": T_SERVE}


@pytest.fixture(params=sorted(PKGS))
def S(request):
    """The serving package under test (the reference's or the port's)."""
    return PKGS[request.param]


def _synthetic(S, cfg):
    if S is T_SERVE:
        return S.SnapshotService.synthetic(cfg, device="cpu")
    return S.SnapshotService.synthetic(cfg)


def _trainer(S, **kw):
    if S is T_SERVE:
        kw["device"] = "cpu"
    return S.SyntheticTrainer(commit_interval_s=3600.0, **kw)


# ---------------------------------------------------------------------------
# the reference's service cases, on both packages
# ---------------------------------------------------------------------------


def test_closed_loop_occupancy_floor(S):
    """With a 4x-slot backlog the scheduler keeps the slot pool busy:
    occupancy (active slot-steps / total slot-steps) stays above 0.5."""
    cfg = S.ServiceConfig(mode="U", n_slots=4, max_new=6, work_s=0.0,
                          commit_interval_s=3600.0)  # no commits mid-run
    svc = _synthetic(S, cfg)
    row = svc.serve_requests([None] * (4 * cfg.n_slots))
    assert row["completed"] == 16
    assert row["occupancy"] >= 0.5
    assert row["violations"] == 0


def _overflowed(state, rc):
    """True iff no ring slot of any block holds a version at or below
    ``rc`` (``NO_TS`` = -1 marks an empty slot): the pinned version has
    left the ring."""
    return all(not ((ts != -1) & (ts <= rc)).any()
               for ts in (np.asarray(t) for t in state.ring_ts.values()))


def _watch_failed_resolves(ex):
    """Wrap ``ex``'s prefill and decode; the returned list gets, for each
    resolve that came back not ok, whether it was a ring overflow at the
    state that resolve read."""
    seen, failed = [], []
    fetch = ex.state_fn

    def state_fn():
        seen.append(fetch())
        return seen[-1]

    def watched(inner, clocks_of):
        def run(*a):
            res = inner(*a)
            results = res if isinstance(res, list) else [res]
            for rc, r in zip(clocks_of(*a), results):
                if not r.ok:
                    failed.append(_overflowed(seen[-1], rc))
            return res
        return run

    ex.state_fn = state_fn
    ex.prefill = watched(ex.prefill, lambda slot, req, clock: [clock])
    ex.decode = watched(ex.decode, lambda slots, clocks: clocks)
    return failed


@pytest.mark.parametrize("ring", [8, 256])
def test_e2e_mode_u_zero_torn_reads_under_live_commits(S, ring):
    """A Mode-U service completes requests while the trainer commits
    every 2 ms: no torn reads, and a reader aborts only when its pinned
    version has left the ring.  At the reference's 8 slots (~16 ms of
    commits) a request that a loaded host slows past the ring overflows
    and restarts by design (``_mode_u_overflow_schedule``); so there
    every failed resolve must be an overflow, and with none there are
    no aborts.  At 256 slots no request outlasts the ring: no aborts."""
    cfg = S.ServiceConfig(mode="U", n_slots=4, max_new=6, work_s=0.0005,
                          commit_interval_s=0.002, ring_slots=ring,
                          target_qps=200.0, duration_s=0.4)
    svc = _synthetic(S, cfg)
    failed = _watch_failed_resolves(svc.executor)
    row = svc.run_open_loop()
    assert row["drained"]
    assert row["completed"] >= 10
    assert row["violations"] == 0
    assert all(failed), "a Mode-U resolve failed inside the ring"
    assert (row["snapshot_aborts"] > 0) == bool(failed)
    if ring > 8:
        assert not failed
    if not failed:
        assert row["snapshot_aborts"] == 0 and row["failed_aborts"] == 0
    assert row["trainer_commits"] > 0
    assert row["stm_stats"]["commits"] == row["completed"]
    assert row["completed"] + row["shed"] + row["failed_aborts"] == \
        row["offered"]


def _scheduler(S, trainer, policy, aborts=8):
    metrics = S.ServeMetrics()
    ex = S.StoreExecutor(lambda: trainer.state, policy=policy, n_slots=1,
                         work_s=0.0, metrics=metrics)
    q = S.RequestQueue()
    return q, metrics, S.ContinuousBatchingScheduler(
        q, ex, metrics, max_request_aborts=aborts)


def _mode_u_schedule(S):
    """Commit between EVERY decode step: the pinned ring version keeps
    serving.  Returns the trace of (pinned clock, aborts, outcome)."""
    trainer = _trainer(S, mode="U", ring_slots=8)
    q, metrics, sched = _scheduler(S, trainer, "U")
    r = S.Request(1, max_new=6)
    q.offer(r)
    sched.step()                      # prefill pins a ring version
    pinned = r.pinned_clock
    trace = [(r.pinned_clock, r.aborts, r.outcome.name)]
    while r.outcome is S.Outcome.PENDING:
        trainer.commit_once()         # a commit between every step
        sched.step()
        assert r.pinned_clock in (pinned, -1)   # never re-pins mid-flight
        trace.append((r.pinned_clock, r.aborts, r.outcome.name))
    assert r.outcome is S.Outcome.COMPLETED
    assert r.aborts == 0 and metrics.snapshot_aborts == 0
    assert metrics.violations == 0
    return trace, metrics.summary()["completed"], int(trainer.state.clock)


def _mode_q_schedule(S):
    """A commit between decode steps fails the pinned snapshot's
    validation; the request restarts at the new clock."""
    trainer = _trainer(S, mode="Q")
    q, metrics, sched = _scheduler(S, trainer, "Q")
    r = S.Request(1, max_new=4)
    q.offer(r)
    sched.step()                      # prefill at clock 0, one decode ok
    pinned0 = r.pinned_clock
    trace = [(r.pinned_clock, r.aborts, r.outcome.name)]
    trainer.commit_once()             # invalidates the pinned snapshot
    sched.step()                      # decode at stale pin: abort
    assert r.aborts == 1 and r.pinned_clock == -1
    trace.append((r.pinned_clock, r.aborts, r.outcome.name))
    sched.step()                      # re-pin at the new clock
    assert r.pinned_clock == int(trainer.state.clock) > pinned0
    while r.outcome is S.Outcome.PENDING:
        trace.append((r.pinned_clock, r.aborts, r.outcome.name))
        sched.step()
    trace.append((r.pinned_clock, r.aborts, r.outcome.name))
    assert r.outcome is S.Outcome.COMPLETED
    assert metrics.snapshot_aborts == 1
    return trace, metrics.snapshot_aborts, int(trainer.state.clock)


def _mode_u_overflow_schedule(S):
    """Mode U with a 4-slot ring: 4 commits between two decode steps push
    the pinned version out of the ring, so the next resolve fails (a
    ring overflow, the bounded ring's abort) and the request restarts at
    the new clock and completes."""
    trainer = _trainer(S, mode="U", ring_slots=4)
    q, metrics, sched = _scheduler(S, trainer, "U")
    r = S.Request(1, max_new=4)
    q.offer(r)
    sched.step()                      # prefill pins clock 0
    trace = [(r.pinned_clock, r.aborts, r.outcome.name)]
    for _ in range(4):
        trainer.commit_once()         # the ring now holds clocks 1-4
    while r.outcome is S.Outcome.PENDING:
        sched.step()
        trace.append((r.pinned_clock, r.aborts, r.outcome.name))
    assert r.outcome is S.Outcome.COMPLETED
    assert r.aborts == 1 and metrics.snapshot_aborts == 1
    assert r.pinned_clock == 4 and metrics.violations == 0
    return trace, metrics.snapshot_aborts, int(trainer.state.clock)


def _live_schedule(S):
    """The 'live' policy never aborts: it serves different versions
    across one request's steps (``mixed_version_requests``)."""
    trainer = _trainer(S, mode="U")
    metrics = S.ServeMetrics()
    ex = S.StoreExecutor(lambda: trainer.state, policy="live", n_slots=1,
                         work_s=0.0, metrics=metrics)
    q = S.RequestQueue()
    sched = S.ContinuousBatchingScheduler(q, ex, metrics)
    r = S.Request(1, max_new=3)
    q.offer(r)
    sched.step()
    trace = [(r.pinned_clock, r.aborts, r.outcome.name)]
    trainer.commit_once()
    while r.outcome is S.Outcome.PENDING:
        sched.step()
        trace.append((r.pinned_clock, r.aborts, r.outcome.name))
    assert r.outcome is S.Outcome.COMPLETED
    assert r.mixed_versions
    assert metrics.mixed_version_requests == 1
    assert metrics.snapshot_aborts == 0
    return trace, r.mixed_versions, metrics.mixed_version_requests


@pytest.mark.parametrize("schedule", [_mode_u_schedule, _mode_q_schedule,
                                      _live_schedule,
                                      _mode_u_overflow_schedule],
                         ids=["mode_u", "mode_q", "live", "mode_u_overflow"])
def test_hand_driven_schedule_matches_the_reference(schedule):
    """The reference's deterministic twins of the threaded runs (a commit
    between decode steps, driven by hand), and a Mode-U ring overflow:
    the same pinned clocks, aborts and outcomes, step for step, in both
    packages."""
    assert schedule(T_SERVE) == schedule(J_SERVE)


# ---------------------------------------------------------------------------
# load generator, defaults and the torn-read check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arrival", ["poisson", "uniform"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_gen_arrivals_match_the_reference(seed, arrival):
    got = T_SERVE.OpenLoopLoadGen(60.0, 2.5, seed=seed, arrival=arrival)
    want = J_SERVE.OpenLoopLoadGen(60.0, 2.5, seed=seed, arrival=arrival)
    assert got.arrivals == want.arrivals and got.total == want.total > 0
    for t in (0.1, 1.0, 3.0):
        assert got.pop_due(t) == want.pop_due(t)
    assert got.exhausted and want.exhausted


def test_service_config_defaults_match_the_reference():
    assert dataclasses.asdict(T_SERVE.ServiceConfig()) == \
        dataclasses.asdict(J_SERVE.ServiceConfig())
    assert T_SERVICE.SERVE_POLICIES == J_SERVICE.SERVE_POLICIES


#: views of two 6-word blocks: (name, block values, violations expected)
VIEWS = [("consistent", [[3] * 6, [3] * 6], 0),
         ("torn_within_a_block", [[3, 3, 3, 4, 3, 3], [3] * 6], 1),
         ("torn_across_blocks", [[3] * 6, [4] * 6], 1)]


@pytest.mark.parametrize("name,blocks,want", VIEWS,
                         ids=[v[0] for v in VIEWS])
def test_torn_view_counts_match_the_reference(name, blocks, want):
    """A decode step over a store whose live view is ``blocks``, under
    the ``live`` policy (the view is checked as it stands): the
    violations counted are the reference's."""
    arrs = {f"b{i}": np.asarray(b, np.int32) for i, b in enumerate(blocks)}
    counts = {}
    for pkg, mv, cfg, params in (
            (J_SERVE, J_MV, JMVStoreConfig(),
             {k: jnp.asarray(v) for k, v in arrs.items()}),
            (T_SERVE, T_MV, MVStoreConfig(),
             {k: torch.from_numpy(v) for k, v in arrs.items()})):
        state = mv.mv_init(params, cfg)
        metrics = pkg.ServeMetrics()
        ex = pkg.StoreExecutor(lambda: state, policy="live", n_slots=2,
                               work_s=0.0, metrics=metrics)
        res = ex.decode([0, 1], [0, 0])
        assert [r.ok for r in res] == [True, True]
        counts[pkg.__name__] = metrics.violations
    assert counts == {"repro.serve": want, "repro_torch.serve": want}
    assert bool(T_SERVICE.torn_flag(T_MV.mv_init(
        {k: torch.from_numpy(v) for k, v in arrs.items()},
        MVStoreConfig()).live)) == bool(want)


def test_trainer_commits_every_element_on_its_device():
    """Each commit writes the new clock into every element of every
    int32 block through ``mv_commit``; Mode U's rings hold the
    versions."""
    tr = T_SERVE.SyntheticTrainer(mode="U", n_blocks=3, block_size=5,
                                  ring_slots=4, device="cpu")
    for _ in range(2):
        tr.commit_once()
    st = tr.state
    assert st.clock == 2 and tr.commits == 2
    assert T_MV.versioned_paths(st) == frozenset(st.ring)
    assert len(st.ring) == 3
    for t in st.live.values():
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        assert bool((t == 2).all())
    view, ok = T_MV.mv_snapshot(st, 1, assume_versioned=True)
    assert bool(ok) and all(bool((t == 1).all()) for t in view.values())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_runs_on_the_cpu_when_asked(capsys):
    assert T_SERVICE.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "policy=U" in out and "aborts=   0" in out


def test_cli_defaults_to_the_card():
    """``python -m repro_torch.serve`` without ``--device`` runs on the
    card: without one it raises before serving anything."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        T_SERVICE.main(["--quick"])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--quick"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "policy=" not in out.stdout
