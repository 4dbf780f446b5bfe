"""Named fault-injection points for the commit pipelines.

Design contract with the hot paths:

* Call sites guard with ``if FP.ACTIVE is not None: FP.fire(point, tid)``
  — when no schedule is installed the cost is one module-attribute load
  and a ``None`` check.  This module is stdlib-only so the engine can
  import it without pulling in numpy or torch.
* A fired fault either raises ``FaultError`` (an ordinary error the
  retry machinery may handle), or simulates a crash.  Simulated crashes
  derive from ``BaseException`` and carry ``simulated_crash = True``;
  cleanup sites that model *transaction semantics* (abort, lock
  release, undo restore) must skip their work when they see that flag,
  because a real crash would never have run them.  Cleanup that models
  *hardware* (releasing an emulation mutex such as a stripe lock — the
  stand-in for an instantaneous CAS) still runs on unwind.
* ``fire`` sets a thread-local ``dying`` flag before raising a crash so
  nested hooks on the unwind path never double-fire, and so cleanup
  code can ask ``FP.dying()`` directly.

The eight points::

    pre_claim           before write locks are claimed
    post_claim          after all write locks are held
    pre_clock_tick      before the commit timestamp is taken
    pre_scatter         before heap publication starts
    mid_scatter         INSIDE the publish sweep — some lanes already
                        scattered, the rest not (the commit_fused
                        partial-lane completion fault; recovery must
                        redo the whole record idempotently)
    post_scatter        after heap publication completes
    pre_release         before write locks are released
    pre_manifest_publish before the checkpoint manifest rename

Actions: ``raise`` (recoverable ``FaultError``), ``kill`` (the owning
thread dies), ``crash`` (the simulated process drops; in-memory state
survives for the in-process recovery drills), and ``die`` — the REAL
thing: ``SIGKILL`` to our own pid, discarding ALL in-memory state.
``die`` is for subprocess drills only (the parent restarts a fresh
process and recovers from the durable WAL); firing it inside a test
runner would take the runner down with it.
"""
from __future__ import annotations

import os
import random
import signal
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

FAULT_POINTS: Tuple[str, ...] = (
    "pre_claim",
    "post_claim",
    "pre_clock_tick",
    "pre_scatter",
    "mid_scatter",
    "post_scatter",
    "pre_release",
    "pre_manifest_publish",
)

ACTIONS: Tuple[str, ...] = ("raise", "kill", "crash", "die")


class FaultError(RuntimeError):
    """An injected recoverable error (the txn machinery may retry)."""

    def __init__(self, point: str, tid: int = -1):
        super().__init__(f"injected fault at {point} (tid={tid})")
        self.point = point
        self.tid = tid


class SimulatedCrash(BaseException):
    """Base for injected crashes.

    Derives from BaseException so ``except Exception`` handlers in the
    code under test don't swallow it; ``simulated_crash`` is the flag
    transaction-semantic cleanup must check before undoing anything.
    """

    simulated_crash = True

    def __init__(self, point: str, tid: int = -1):
        super().__init__(f"simulated crash at {point} (tid={tid})")
        self.point = point
        self.tid = tid


class ThreadKilled(SimulatedCrash):
    """The owning thread died mid-commit; the process lives on."""


class ProcessCrashed(SimulatedCrash):
    """The whole simulated process dropped; recovery restarts it."""


class SimulatedProcessDeath(ProcessCrashed):
    """The OS process image is GONE — every in-memory structure (heap,
    lock table, descriptors, parked epoch records) is lost.  The ``die``
    action delivers a real ``SIGKILL``; this exception only surfaces if
    the signal could not be delivered (never, on POSIX)."""


def is_simulated_crash(exc: BaseException) -> bool:
    return getattr(exc, "simulated_crash", False)


@dataclass(frozen=True)
class Fault:
    """One explicit injection: fire ``action`` on the ``nth`` arrival
    at ``point`` (1-based, counted per point), optionally only for one
    thread id."""

    point: str
    nth: int = 1
    action: str = "kill"
    tid: Optional[int] = None

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r}")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.nth < 1:
            raise ValueError("nth is 1-based")


class FaultSchedule:
    """Deterministic schedule of injected faults.

    Two modes, composable:

    * explicit ``faults`` — a list of :class:`Fault` records, each
      matched against a per-(point, tid-filter) arrival counter;
    * periodic ``kill_every`` — roughly every ``kill_every``-th arrival
      at one of ``points`` fires ``action``, with the exact gap drawn
      from ``random.Random(seed)`` so runs are replayable but not
      phase-locked to the workload.

    ``max_fires`` caps total injections (None = unlimited).  The
    ``fired`` journal records ``(point, tid, action, arrival_index)``
    for every injection, in order.
    """

    def __init__(
        self,
        faults: Sequence[Fault] = (),
        *,
        seed: int = 0,
        kill_every: int = 0,
        points: Sequence[str] = ("pre_release",),
        action: str = "kill",
        max_fires: Optional[int] = None,
    ):
        for p in points:
            if p not in FAULT_POINTS:
                raise ValueError(f"unknown fault point {p!r}")
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = seed
        self.kill_every = int(kill_every)
        self.periodic_points = frozenset(points)
        self.periodic_action = action
        self.max_fires = max_fires
        self.fired: List[Tuple[str, int, str, int]] = []
        self._lock = threading.Lock()
        self._arrivals: Dict[str, int] = {p: 0 for p in FAULT_POINTS}
        self._total_arrivals = 0
        self._pending = list(self.faults)
        self._rng = random.Random(seed)
        self._next_periodic = self._draw_gap() if self.kill_every else -1
        self.process_dead = False

    def _draw_gap(self) -> int:
        # jitter +-25% around kill_every, never below 1
        lo = max(1, (3 * self.kill_every) // 4)
        hi = max(lo, (5 * self.kill_every) // 4)
        return self._total_arrivals + self._rng.randint(lo, hi)

    def arrive(self, point: str, tid: int) -> Optional[str]:
        """Record an arrival; return the action to take, or None."""
        with self._lock:
            if self.max_fires is not None and len(self.fired) >= self.max_fires:
                return None
            self._arrivals[point] += 1
            n = self._arrivals[point]
            for i, f in enumerate(self._pending):
                if f.point != point or f.nth != n:
                    continue
                if f.tid is not None and f.tid != tid:
                    continue
                del self._pending[i]
                self.fired.append((point, tid, f.action, n))
                return f.action
            if self.kill_every and point in self.periodic_points:
                self._total_arrivals += 1
                if self._total_arrivals >= self._next_periodic:
                    self._next_periodic = self._draw_gap()
                    self.fired.append((point, tid, self.periodic_action, n))
                    return self.periodic_action
            return None

    def arrivals(self, point: Optional[str] = None) -> int:
        with self._lock:
            if point is None:
                return sum(self._arrivals.values())
            return self._arrivals[point]


# --- global install point --------------------------------------------------

ACTIVE: Optional[FaultSchedule] = None

_tls = threading.local()


def install(schedule: FaultSchedule) -> FaultSchedule:
    global ACTIVE
    ACTIVE = schedule
    return schedule


def uninstall() -> None:
    global ACTIVE
    ACTIVE = None


class installed:
    """Context manager: install a schedule, always uninstall on exit."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule

    def __enter__(self) -> FaultSchedule:
        return install(self.schedule)

    def __exit__(self, *exc) -> None:
        uninstall()
        return None


def dying() -> bool:
    """True while the current thread is unwinding from a simulated crash."""
    return getattr(_tls, "dying", False)


def reset_thread() -> None:
    """Clear the dying flag — call when a 'dead' worker is resurrected."""
    _tls.dying = False


def fire(point: str, tid: int = -1) -> None:
    """Arrival at a fault point.  No-op unless a schedule is installed.

    Raises FaultError / ThreadKilled / ProcessCrashed per the schedule.
    """
    sched = ACTIVE
    if sched is None or getattr(_tls, "dying", False):
        return
    action = sched.arrive(point, tid)
    if action is None:
        return
    if action == "raise":
        raise FaultError(point, tid)
    _tls.dying = True
    if action == "kill":
        raise ThreadKilled(point, tid)
    sched.process_dead = True
    if action == "die":
        # the real thing: no unwind, no cleanup, no exception — the
        # kernel reaps us mid-instruction (subprocess drills only)
        os.kill(os.getpid(), signal.SIGKILL)
        raise SimulatedProcessDeath(point, tid)  # pragma: no cover
    raise ProcessCrashed(point, tid)
