"""``correct`` comes out false under the faults each cell can have, and
under its control, at reduced widths on the CPU: the rest of a run driven
as it is, the timed path broken underneath (the look for a card
skipped)."""
from __future__ import annotations

import pytest

from perfbench.harness import common
from perfbench.tests import smoke

SEED = 2**31 + 303
#: limits at this size, where the program's gaps are some thousandths
#: (the cells' limits are for their full widths)
SMALL = {"served_logit_gap": 0.02}


def _run(cell, mix, **kw):
    kw.setdefault("limits", SMALL)
    ctx = smoke.context(cell, mix=mix, seed=SEED, seconds=1.5, **kw)
    return common.load_module("drivers", ctx.traffic["driver"]).run(ctx)


def _checks(out):
    return {c.name: c for c in out.checks}


@pytest.fixture
def altered_token(monkeypatch):
    """Every decoded token is another than the model chose, where the
    executor produces it."""
    from repro_torch.launch import serve
    real = serve.ModelSlotExecutor.decode

    def decode(self, slots, clocks):
        res = real(self, slots, clocks)
        self.tokens = (self.tokens + 1) % self.cfg.vocab_size
        return [type(r)(r.ok, r.clock, token=int(self.tokens[i]))
                for i, r in zip(slots, res)]

    monkeypatch.setattr(serve.ModelSlotExecutor, "decode", decode)


def test_sound_runs_are_correct():
    for cell, mix in (("deepseek-7b.serve_Q", smoke.SERVE_MIX),
                      ("mamba2-780m.train_U", smoke.TRAIN_MIX)):
        out = _run(cell, mix)
        assert out.correct, (cell, out.checks)


def test_an_altered_token_is_not_correct(altered_token):
    out = _run("deepseek-7b.serve_Q", smoke.SERVE_MIX)
    assert not out.correct
    assert not _checks(out)["served_logit_gap"].ok


def _wrap_train_step(monkeypatch, wrap):
    from repro_torch.launch import steps
    real = steps.make_train_step

    def make(*a, **k):
        return wrap(real(*a, **k))

    monkeypatch.setattr(steps, "make_train_step", make)


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    def wrap(step):
        def same(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return same
    _wrap_train_step(monkeypatch, wrap)
    out = _run("mamba2-780m.train_U", smoke.TRAIN_MIX)
    assert not out.correct
    assert not _checks(out)["change_gap"].ok


def test_a_commit_that_stores_the_version_before(monkeypatch):
    """The ring's slot of each new clock holds the parameters of the clock
    before it: the version a reader at that clock would get is stale."""
    from perfbench.drivers import train
    from perfbench.harness import weights

    def wrap(step):
        def stale(state, batch):
            old = {p: t.clone() for p, t in train.flat(state.mv.live).items()}
            new, metrics = step(state, batch)
            K = int(new.mv.clock)
            for key, ts in new.mv.ring_ts.items():
                slot = ts.tolist().index(K)
                new.mv.ring[key][slot].copy_(old[weights.parse_path(key)])
            return new, metrics
        return stale
    _wrap_train_step(monkeypatch, wrap)
    out = _run("mamba2-780m.train_U", smoke.TRAIN_MIX)
    assert not out.correct
    assert not _checks(out)["change_gap"].ok


def test_half_of_the_batch_left_out(monkeypatch):
    def wrap(step):
        def half(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    _wrap_train_step(monkeypatch, wrap)
    out = _run("mamba2-780m.train_U", smoke.TRAIN_MIX)
    assert not out.correct
    assert not _checks(out)["change_gap"].ok


@pytest.mark.parametrize("cell,mix", [
    ("deepseek-7b.serve_Q", smoke.SERVE_MIX),
    ("mamba2-780m.train_U", smoke.TRAIN_MIX)])
def test_the_control_is_not_correct(cell, mix):
    """The reference in float8 e4m3 in the program's place, judged as the
    program is, comes out not correct (the served tokens' gap, or a
    training cell's gradient or change, over its limit); the limits at
    full size are set the same way from the card's readings (PERF.md)."""
    out = _run(cell, mix, calibrate=True)
    assert out.correct, out.checks
    assert out.control_correct is False, out.control
