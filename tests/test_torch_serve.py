"""The port's serving stack against the JAX package's, on the CPU.

* queue, reservoir and scheduler: the cases of ``tests/test_serve.py``
  that need no store service, each run on both packages' copies;
* end to end: the reference's ``Server`` and the port's
  ``Server(device="cpu")`` over the same float32 smoke config, weights
  and seeded prompts give identical tokens;
* snapshot commits driven through ``Server`` in both packages: a writer
  replaces ``server.mv_state`` with ``mv_commit`` of a version whose
  ``lm_head`` is negated while every slot is decoding.  In Mode U the
  pinned requests are served the old version from the ring, with no
  abort; in Mode Q every in-flight request aborts once and restarts.
  The abort counts are the same in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as J_SERVE
import repro_torch.serve as T_SERVE
from repro.configs import MVStoreConfig as JMVStoreConfig
from repro.configs import smoke_config as j_smoke_config
from repro.core import mvstore as J_MV
from repro.launch.serve import Server as JServer
from repro.models import model_zoo as J_ZOO
from repro_torch.configs import MVStoreConfig, smoke_config
from repro_torch.core import mvstore as T_MV
from repro_torch.launch import serve as T_SERVE_MOD
from repro_torch.launch.serve import Server
from repro_torch.models import model_zoo as ZOO

PKGS = {"jax": J_SERVE, "port": T_SERVE}
ARCH = "qwen2.5-3b"


@pytest.fixture(params=sorted(PKGS))
def S(request):
    """The serving package under test (the reference's or the port's)."""
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# queue admission control
# ---------------------------------------------------------------------------


def test_queue_admits_then_sheds_on_depth(S):
    q = S.RequestQueue(max_depth=2)
    assert q.offer(S.Request(1)) is S.Admission.ADMITTED
    assert q.offer(S.Request(2)) is S.Admission.ADMITTED
    a = q.offer(S.Request(3))
    assert a is S.Admission.SHED_DEPTH and a.shed
    assert q.depth == 2
    assert q.counters == {"offered": 3, "admitted": 2, "shed_depth": 1,
                          "shed_wait": 0, "closed": 0}


def test_queue_sheds_on_wait_budget(S):
    q = S.RequestQueue(max_depth=64, wait_budget_s=0.1, est_service_s=1.0)
    assert q.offer(S.Request(1)) is S.Admission.ADMITTED
    for rid in (2, 3, 4, 5):
        q.offer(S.Request(rid))
    assert q.offer(S.Request(6)) is S.Admission.SHED_WAIT
    for _ in range(60):
        q.note_service_time(0.001)
    assert q.offer(S.Request(7)) is S.Admission.ADMITTED


def test_queue_autotune_tightens_budget_under_slow_tail(S):
    mk = lambda auto: S.RequestQueue(  # noqa: E731
        max_depth=64, wait_budget_s=0.5, est_service_s=0.01,
        autotune=auto)
    tuned, fixed = mk(True), mk(False)
    for q in (tuned, fixed):
        for _ in range(60):
            q.note_service_time(0.01)
        for _ in range(5):
            q.note_service_time(2.0)
        for _ in range(60):
            q.note_service_time(0.01)
        for rid in range(3):
            q.offer(S.Request(rid))
    assert tuned.service_ema_s < 0.5 < tuned.service_p99_s
    assert tuned.effective_wait_budget_s < fixed.effective_wait_budget_s
    assert fixed.effective_wait_budget_s == pytest.approx(0.5)
    assert fixed.offer(S.Request(10)) is S.Admission.ADMITTED
    assert tuned.offer(S.Request(10)) is S.Admission.SHED_WAIT
    for _ in range(4000):
        tuned.note_service_time(0.01)
    assert tuned.offer(S.Request(11)) is S.Admission.ADMITTED


def test_queue_wait_estimate_scales_with_servers(S):
    one = S.RequestQueue(max_depth=64, est_service_s=1.0, n_servers=1)
    four = S.RequestQueue(max_depth=64, est_service_s=1.0, n_servers=4)
    for q in (one, four):
        for rid in range(4):
            q.offer(S.Request(rid))
    assert one.estimated_wait_s() == pytest.approx(4.0)
    assert four.estimated_wait_s() == pytest.approx(1.0)


def test_queue_close_stops_admission_but_drains(S):
    q = S.RequestQueue()
    q.offer(S.Request(1))
    q.close()
    assert q.offer(S.Request(2)) is S.Admission.CLOSED
    assert q.counters["closed"] == 1
    req = q.get()
    assert req is not None and req.rid == 1
    assert q.get() is None


def test_queue_stamps_arrival_and_dequeue_times(S):
    q = S.RequestQueue()
    req = S.Request(1)
    q.offer(req, now=10.0)
    assert req.t_arrival == 10.0 and req.t_admitted == 10.0
    out = q.get(now=10.5)
    assert out is req and req.t_dequeued == 10.5
    assert req.queue_wait_s == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# percentile reservoir
# ---------------------------------------------------------------------------


def test_reservoir_exact_below_capacity(S):
    rng = np.random.default_rng(3)
    xs = rng.lognormal(0.0, 1.0, size=1000)
    r = S.PercentileReservoir(capacity=4096, seed=0)
    for x in xs:
        r.add(float(x))
    for q in (50, 90, 95, 99):
        assert r.percentile(q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)
    assert r.mean == pytest.approx(float(xs.mean()), rel=1e-12)


def test_reservoir_past_capacity_is_the_references_sample():
    """Past its capacity the reservoir samples; seeded alike, the port's
    keeps the reference's sample, so every percentile is the same."""
    rng = np.random.default_rng(5)
    xs = rng.uniform(0.0, 100.0, size=20000)
    res = [S.PercentileReservoir(capacity=512, seed=1)
           for S in (J_SERVE, T_SERVE)]
    for r in res:
        for x in xs:
            r.add(float(x))
    assert res[0].count == res[1].count == 20000
    for q in (1, 50, 99):
        assert res[0].percentile(q) == res[1].percentile(q)
    assert abs(res[1].percentile(50) - 50.0) < 15.0


def test_reservoir_empty_is_nan(S):
    r = S.PercentileReservoir()
    assert np.isnan(r.percentile(99)) and np.isnan(r.mean)


# ---------------------------------------------------------------------------
# continuous-batching scheduler (fake executor: no store, no model)
# ---------------------------------------------------------------------------


def _fake_executor(S, n_slots=2, die_after_decodes=None):
    """A deterministic SlotExecutor of package ``S``: token = request id;
    a decode aborts the rids in ``abort_rids``; with
    ``die_after_decodes`` the executor raises at that decode."""

    class Fake:
        def __init__(self):
            self.n_slots = n_slots
            self.clock = 0
            self.abort_rids = set()
            self.prefills = []
            self.decode_calls = []

        def current_clock(self):
            return self.clock

        def prefill(self, slot, req, clock):
            self.prefills.append((req.rid, slot, clock))
            return S.StepResult(True, clock, token=req.rid)

        def decode(self, slots, clocks):
            self.decode_calls.append((list(slots), list(clocks)))
            if die_after_decodes is not None and \
                    len(self.decode_calls) >= die_after_decodes:
                raise RuntimeError("executor died mid-decode")
            return [S.StepResult(self._rid(s) not in self.abort_rids, c,
                                 token=self._rid(s))
                    for s, c in zip(slots, clocks)]

        def _rid(self, slot):
            return self._sched.slots[slot].req.rid

    return Fake()


def _make_sched(S, n_slots=2, max_request_aborts=3, **kw):
    q = S.RequestQueue(max_depth=64)
    ex = _fake_executor(S, n_slots=n_slots, **kw)
    sched = S.ContinuousBatchingScheduler(
        q, ex, S.ServeMetrics(), max_request_aborts=max_request_aborts)
    ex._sched = sched
    return q, ex, sched


def test_scheduler_refills_freed_slot_without_draining_batch(S):
    q, ex, sched = _make_sched(S, n_slots=2)
    r1, r2, r3 = (S.Request(1, max_new=2), S.Request(2, max_new=6),
                  S.Request(3, max_new=2))
    for r in (r1, r2, r3):
        q.offer(r)
    sched.step()
    assert r1.outcome is S.Outcome.COMPLETED
    assert r2.outcome is S.Outcome.PENDING
    sched.step()
    assert (3, 0, 0) in ex.prefills
    assert r2.outcome is S.Outcome.PENDING
    assert all(1 in slots for slots, _ in ex.decode_calls)
    while S.Outcome.PENDING in (r2.outcome, r3.outcome):
        sched.step()
    assert r2.tokens == [2] * 6 and r3.tokens == [3] * 2
    assert sched.metrics.completed == 3


def test_scheduler_pins_clock_at_prefill(S):
    q, ex, sched = _make_sched(S, n_slots=1)
    r1 = S.Request(1, max_new=3)
    q.offer(r1)
    ex.clock = 7
    sched.step()
    ex.clock = 9
    sched.step()
    assert r1.pinned_clock == 7
    assert ex.decode_calls[-1][1] == [7]
    assert r1.served_clocks == [7, 7, 7][: len(r1.served_clocks)]


def test_scheduler_abort_repins_then_fails_request(S):
    q, ex, sched = _make_sched(S, n_slots=1, max_request_aborts=2)
    r1 = S.Request(1, max_new=4)
    q.offer(r1)
    ex.clock = 5
    sched.step()
    assert r1.tokens == [1, 1]
    ex.abort_rids.add(1)
    ex.clock = 6
    sched.step()
    assert r1.aborts == 1 and r1.tokens == [] and r1.pinned_clock == -1
    sched.step()
    assert r1.pinned_clock == 6
    assert r1.outcome is S.Outcome.FAILED_ABORTS
    assert sched.metrics.failed_aborts == 1
    assert sched.metrics.snapshot_aborts == 2
    assert sched.slots == [None]


def test_scheduler_drain_finishes_inflight_and_closes_queue(S):
    q, ex, sched = _make_sched(S, n_slots=2)
    reqs = [S.Request(i, max_new=3) for i in range(1, 6)]
    for r in reqs:
        q.offer(r)
    assert sched.run_until_drained(timeout_s=5.0)
    assert all(r.outcome is S.Outcome.COMPLETED for r in reqs)
    assert q.offer(S.Request(99)) is S.Admission.CLOSED


def test_scheduler_crash_drain_sweeps_slots_then_reraises(S):
    q, ex, sched = _make_sched(S, n_slots=2, die_after_decodes=2)
    r1, r2 = S.Request(1, max_new=6), S.Request(2, max_new=6)
    r2.aborts = 2
    q.offer(r1)
    q.offer(r2)
    with pytest.raises(RuntimeError, match="died mid-decode"):
        sched.run_until_drained(timeout_s=5.0)
    assert r2.outcome is S.Outcome.FAILED_ABORTS
    assert r1.outcome is S.Outcome.PENDING
    assert r1.aborts == 1 and r1.tokens == [] and r1.pinned_clock == -1
    assert r1.served_clocks == []
    slot = sched.slots[0]
    assert slot is not None and not slot.decoding and slot.produced == 0
    assert sched.metrics.snapshot_aborts >= 2
    sched.executor = healthy = _fake_executor(S, n_slots=2)
    healthy.clock = 11
    healthy._sched = sched
    assert sched.run_until_drained(timeout_s=5.0)
    assert r1.outcome is S.Outcome.COMPLETED
    assert r1.pinned_clock == 11
    assert r1.tokens == [1] * 6


# ---------------------------------------------------------------------------
# the model server, both packages
# ---------------------------------------------------------------------------

BATCH, PROMPT, GEN = 2, 16, 6


def _setup(seed=0):
    """The float32 smoke config of both packages, the reference's params
    (jax tree) and the same params carried across (tensor tree)."""
    jc = dataclasses.replace(j_smoke_config(ARCH), dtype="float32")
    tc = dataclasses.replace(smoke_config(ARCH), dtype="float32")
    jp = J_ZOO.init_params(jc, jax.random.PRNGKey(seed))
    tp = ZOO.params_from_numpy(jax.tree.map(np.asarray, jp))
    prompts = np.random.default_rng(seed).integers(
        0, tc.vocab_size, (2 * BATCH, PROMPT)).astype(np.int32)
    return jc, tc, jp, tp, prompts


def _servers(mode, jc, tc, jp, tp):
    kw = dict(batch=BATCH, prompt_len=PROMPT, max_len=PROMPT + GEN)
    js = JServer(jc, mvcfg=JMVStoreConfig(mode=mode), params=jp, **kw)
    ts = Server(tc, mvcfg=MVStoreConfig(mode=mode), params=tp,
                device="cpu", **kw)
    return js, ts


def test_serve_batch_matches_the_reference():
    """Four seeded requests through two slots (so freed slots refill):
    the port's tokens are the reference's."""
    jc, tc, jp, tp, prompts = _setup()
    js, ts = _servers("Q", jc, tc, jp, tp)
    want = js.serve_batch(prompts, GEN)
    got = ts.serve_batch(prompts, GEN)
    assert got.shape == (2 * BATCH, GEN) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert ts.aborts == js.aborts == 0
    assert ts.stats()["commits"] == js.stats()["commits"] == 2 * BATCH
    assert ts.device.type == "cpu"
    assert ts.mv_state.live["embed"].device.type == "cpu"


def _negated_head(params, to_arr):
    out = dict(params)
    out["lm_head"] = to_arr(-np.asarray(params["lm_head"]))
    return out


def _commit_mid_decode(server, mv, prompts, new_params, mvcfg):
    """Submit ``prompts`` (one per slot), pump once so every slot has
    prefilled and decoded, commit ``new_params`` through the package's
    ``mv_commit``, then pump to the end."""
    reqs = [server.submit(p, GEN) for p in prompts]
    server.pump()
    assert all(r.pinned_clock == 0 and len(r.tokens) == 2 for r in reqs)
    server.mv_state = mv.mv_commit(server.mv_state, new_params,
                                   local_mode=mvcfg.mode, cfg=mvcfg)
    while any(r.outcome is r.outcome.PENDING for r in reqs):
        server.pump()
    return reqs


@pytest.mark.parametrize("mode", ["U", "Q"])
def test_commit_during_decode_matches_the_reference(mode):
    """Mode U: the pinned requests read the old version from the ring —
    no abort, and the tokens of a run without the commit.  Mode Q: each
    in-flight request aborts once and restarts at the new clock, on the
    new version.  Tokens, abort counts and clocks agree across
    packages."""
    jc, tc, jp, tp, prompts = _setup(seed=1)
    prompts = prompts[:BATCH]
    base_j, base_t = _servers(mode, jc, tc, jp, tp)
    baseline = base_t.serve_batch(prompts, GEN)
    np.testing.assert_array_equal(baseline, base_j.serve_batch(prompts,
                                                               GEN))
    js, ts = _servers(mode, jc, tc, jp, tp)
    jreqs = _commit_mid_decode(js, J_MV, prompts,
                               _negated_head(jp, jnp.asarray),
                               JMVStoreConfig(mode=mode))
    treqs = _commit_mid_decode(ts, T_MV, prompts,
                               _negated_head(tp, torch.from_numpy),
                               MVStoreConfig(mode=mode))
    got = np.array([r.tokens for r in treqs], np.int32)
    np.testing.assert_array_equal(
        got, np.array([r.tokens for r in jreqs], np.int32))
    assert ts.aborts == js.aborts
    assert [r.served_clocks for r in treqs] == \
        [r.served_clocks for r in jreqs]
    assert all(r.outcome is r.outcome.COMPLETED for r in treqs)
    if mode == "U":
        assert ts.aborts == 0
        np.testing.assert_array_equal(got, baseline)
        assert all(set(r.served_clocks) == {0} for r in treqs)
    else:
        assert ts.aborts == BATCH
        assert all(r.pinned_clock == 1 for r in treqs)
        assert not np.array_equal(got, baseline)


def test_cli_serves_on_the_cpu_when_asked(capsys):
    assert T_SERVE_MOD.main(["--smoke", "--device", "cpu", "--requests",
                             "2", "--batch", "2", "--prompt-len", "8",
                             "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "done on cpu: 2 requests x 3 tokens" in out
