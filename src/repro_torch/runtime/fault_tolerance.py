"""Fault tolerance: checkpoint/restart supervision for the train loop.

``TrainSupervisor.run`` drives step functions produced by
``launch/steps.py``, checkpoints through the MVStore snapshot reader
(never pausing the step pipeline), and on failure — a raised exception
from the step, an injected fault, or a straggler escalation — restores
the latest checkpoint and replays.  Because the data pipeline is
counter-based, replay is exact.  With a write-ahead log (``wal=``, a
``reliability/wal.WriteAheadLog``) every checkpoint also writes the log's
base image and every restore scans the log.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint.snapshotter import CheckpointManager
from repro_torch.runtime.straggler import StragglerMonitor


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault injection for tests/demos."""

    fail_at_steps: tuple = ()
    exception: type = RuntimeError


class TrainSupervisor:
    def __init__(self, *, ckpt_dir: str, ckpt_every: int = 20,
                 max_restarts: int = 5, reader=None,
                 straggler: Optional[StragglerMonitor] = None,
                 wal=None):
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.manager = CheckpointManager(ckpt_dir, reader=reader)
        self.straggler = straggler or StragglerMonitor()
        # optional durable commit log: checkpoints double as WAL
        # truncation points (the base image reclaims segments below the
        # floor), and every restore logs the journal's decided-but-
        # unpublished tail so drills can assert the committed prefix
        # survived the restart
        self.wal = wal
        self.restarts = 0
        self.events = []

    def run(self, *, state, train_step: Callable, batch_at: Callable,
            n_steps: int, start_step: int = 0,
            fault_plan: Optional[FaultPlan] = None,
            on_step: Optional[Callable] = None):
        """Run to n_steps with checkpoint/restart.  ``batch_at(step)``
        must be deterministic; ``train_step(state, batch) -> (state,
        metrics)``.  Each step is waited for (its loss read back) before
        it counts, so a fault on the device surfaces at its step."""
        step = start_step
        fault_plan = fault_plan or FaultPlan()
        fired = set()
        while step < n_steps:
            try:
                t0 = time.time()
                if step in fault_plan.fail_at_steps and step not in fired:
                    fired.add(step)
                    raise fault_plan.exception(
                        f"injected node failure at step {step}")
                state, metrics = train_step(state, batch_at(step))
                float(metrics["loss"])    # waits for the whole step
                self.straggler.observe(step, time.time() - t0)
                step += 1
                if on_step is not None:
                    on_step(step, state, metrics)
                if step % self.ckpt_every == 0:
                    self._checkpoint(step, state)
            except Exception as e:  # noqa: BLE001 — node failure path
                self.events.append(("failure", step, repr(e)))
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                step, state = self._restore(state)
                self.events.append(("restored", step, ""))
        self.manager.wait_idle()
        return step, state

    def _checkpoint(self, step, state):
        outcome = self.manager.submit(step, state.mv, state.opt,
                                      extra={"restarts": self.restarts})
        if self.wal is not None:
            # the first live block, cast to int64 as the reference's
            # base image is (one copy home)
            key = next(iter(state.mv.live))
            self.wal.checkpoint(state.mv.live[key], int(state.mv.clock))
        self.events.append(
            ("checkpoint", step,
             "ok" if outcome else getattr(outcome, "value", "aborted")))

    def _restore(self, template_state):
        self.manager.wait_idle()          # in-flight async save may be ours
        from repro_torch.reliability.recovery import replay_from_checkpoint
        try:
            out = replay_from_checkpoint(self.ckpt_dir, template_state)
        except FileNotFoundError:
            # cold restart: no checkpoint landed yet -> replay from step 0
            self.events.append(("cold_restart", 0, ""))
            out = 0, template_state
        if self.wal is not None:
            # counter-based replay recomputes the lost steps exactly, so
            # the WAL tail is not re-applied here — but its decided
            # records ARE the committed prefix, and the scan both proves
            # they survived and journals the torn tail for the drills.
            # The log's directory is ``wal.dir`` (the reference reads a
            # ``.path`` its WriteAheadLog does not have)
            from repro_torch.reliability.wal import scan_dir
            self.wal.flush()
            recs, torn, _base = scan_dir(self.wal.dir)
            undrained = sum(1 for r in recs if r.decided and not r.completed)
            self.events.append(
                ("wal_scan", out[0],
                 f"records={len(recs)} undrained={undrained} torn={torn}"))
        return out
