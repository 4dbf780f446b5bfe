"""Continuous-batching scheduler over a fixed slot pool (the port's copy
of the reference's ``serve/scheduler.py``).

The scheduler owns WHICH request runs in WHICH slot and at WHAT
snapshot clock; it knows nothing about models or stores.  Executors
implement the ``SlotExecutor`` protocol:

  * ``n_slots``                    — fixed decode batch width
  * ``current_clock()``            — the store's commit clock now
  * ``prefill(slot, req, clock)``  — admit a request into a slot at a
    pinned snapshot clock; returns ``StepResult`` (ok + first token)
  * ``decode(slots, clocks)``      — ONE decode step for the active
    slots, each resolved at its pinned clock; returns a ``StepResult``
    per slot

Scheduling policy (the continuous-batching part): every ``step()``
first REFILLS free slots from the queue — a freed slot takes a new
request immediately, the batch never drains to empty before admitting
more — then runs one decode step for everything active.  A request's
snapshot clock is pinned at prefill; a Mode-Q snapshot abort (ok=False)
throws away the request's tokens and re-pins it at a fresh clock
(counted per request, surfaced in telemetry), and a request that aborts
``max_request_aborts`` times is failed — that is the abort-driven
shedding the serving eval's baselines exhibit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Protocol, Sequence

from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import Request, RequestQueue


@dataclasses.dataclass(frozen=True)
class StepResult:
    """One slot's outcome for one prefill/decode step."""

    ok: bool                      # snapshot read succeeded
    clock: int                    # clock the parameters came from
    token: Optional[int] = None   # produced token (None: non-token executor)


class SlotExecutor(Protocol):
    n_slots: int

    def current_clock(self) -> int: ...

    def prefill(self, slot: int, req: Request, clock: int) -> StepResult: ...

    def decode(self, slots: Sequence[int], clocks: Sequence[int]
               ) -> List[StepResult]: ...


@dataclasses.dataclass
class _Slot:
    req: Request
    produced: int = 0             # tokens produced so far (incl. prefill)
    decoding: bool = False        # False until prefill succeeds


class ContinuousBatchingScheduler:
    """Keeps ``executor.n_slots`` slots full from ``queue``."""

    def __init__(self, queue: RequestQueue, executor: SlotExecutor,
                 metrics: Optional[ServeMetrics] = None, *,
                 max_request_aborts: int = 8):
        self.queue = queue
        self.executor = executor
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.max_request_aborts = max_request_aborts
        self.slots: List[Optional[_Slot]] = [None] * executor.n_slots

    # -- introspection --------------------------------------------------
    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None and s.decoding)

    @property
    def busy(self) -> bool:
        return any(s is not None for s in self.slots) \
            or self.queue.depth > 0

    # -- the loop body ---------------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration: refill freed slots, one decode step.

        Returns True if any slot did work (prefill or decode) — the
        service loop uses False to idle-sleep instead of spinning.
        """
        worked = self._refill()
        m = self.metrics
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.decoding]
        # occupancy counts steps with work IN the system (occupied slots
        # or queued requests); pure idle polling would otherwise dominate
        # the denominator under light open-loop load
        if any(s is not None for s in self.slots) or self.queue.depth > 0:
            m.on_step(len(active), len(self.slots))
        if not active:
            return worked
        clocks = [self.slots[i].req.pinned_clock for i in active]
        results = self.executor.decode(active, clocks)
        now = time.perf_counter()
        for i, res in zip(active, results):
            slot = self.slots[i]
            if res.ok:
                self._advance(i, slot, res, now)
            else:
                self._abort(i, slot, now)
        return True

    def run_until_drained(self, timeout_s: Optional[float] = None,
                          idle_sleep_s: float = 1e-4) -> bool:
        """Graceful drain: close the queue, finish in-flight requests.

        Returns True if fully drained, False on timeout (remaining
        requests are failed so callers see a complete accounting).
        """
        self.queue.close()
        t0 = time.perf_counter()
        try:
            while self.busy:
                if timeout_s is not None \
                        and time.perf_counter() - t0 > timeout_s:
                    self._fail_remaining()
                    return False
                if not self.step():
                    time.sleep(idle_sleep_s)
        except BaseException:
            # executor crash mid-drain: leave no slot half-served — every
            # in-flight request is either re-admitted (salvageable) or
            # failed (at the abort cap) before the crash propagates
            self._crash_sweep()
            raise
        return True

    # -- internals -------------------------------------------------------
    def _refill(self) -> bool:
        """Fill free slots from the queue and prefill newcomers/re-pins."""
        worked = False
        for i, slot in enumerate(self.slots):
            if slot is None:
                req = self.queue.get()
                if req is None:
                    continue
                slot = _Slot(req)
                self.slots[i] = slot
            if slot.decoding:
                continue
            worked = True
            rc = self.executor.current_clock()
            res = self.executor.prefill(i, slot.req, rc)
            now = time.perf_counter()
            if not res.ok:
                # prefill snapshot raced a commit: retry next pass at a
                # fresher clock (counted — this is Mode Q's retry path)
                slot.req.prefill_retries += 1
                self.metrics.on_prefill_retry()
                continue
            req = slot.req
            req.pinned_clock = res.clock
            req.served_clocks.append(res.clock)
            if res.token is not None:
                req.tokens.append(res.token)
            slot.produced = 1
            slot.decoding = True
            if req.t_first_token < 0:
                req.t_first_token = now
            if slot.produced >= req.max_new:
                self._complete(i, slot, now)
        return worked

    def _advance(self, i: int, slot: _Slot, res: StepResult,
                 now: float) -> None:
        req = slot.req
        req.served_clocks.append(res.clock)
        if res.token is not None:
            req.tokens.append(res.token)
        slot.produced += 1
        if slot.produced >= req.max_new:
            self._complete(i, slot, now)

    def _abort(self, i: int, slot: _Slot, now: float) -> None:
        """Mode-Q snapshot abort: restart the request at a fresh clock."""
        req = slot.req
        req.aborts += 1
        self.metrics.on_snapshot_abort()
        if req.aborts >= self.max_request_aborts:
            self.metrics.on_failed(req, now)
            self._free(i)
            return
        # discard progress; _refill() re-prefills at a fresh clock
        req.tokens.clear()
        req.served_clocks.clear()
        req.pinned_clock = -1
        slot.produced = 0
        slot.decoding = False

    def _complete(self, i: int, slot: _Slot, now: float) -> None:
        req = slot.req
        self.metrics.on_complete(req, now,
                                 store_clock=self.executor.current_clock())
        if req.t_dequeued >= 0:
            self.queue.note_service_time(now - req.t_dequeued)
        self._free(i)

    def _free(self, i: int) -> None:
        self.slots[i] = None

    def _crash_sweep(self) -> dict:
        """Sweep the slot pool after an executor crash.

        A request caught mid-decode when the executor died holds a
        pinned clock and partial tokens that no longer mean anything —
        the snapshot it was reading may not survive recovery.  Requests
        below the abort cap are re-admitted: progress discarded, decode
        state reset, charged one abort, left in their slot so a later
        drain (same or fresh scheduler over this slot list) re-prefills
        them at a post-recovery clock.  Requests at the cap are FAILED
        so callers still see a complete accounting.  Queued (never
        admitted) requests are untouched — they carry no stale state.
        """
        now = time.perf_counter()
        swept = {"readmitted": 0, "failed": 0}
        for i, slot in enumerate(self.slots):
            if slot is None or not slot.decoding:
                continue
            req = slot.req
            req.aborts += 1
            self.metrics.on_snapshot_abort()
            if req.aborts >= self.max_request_aborts:
                self.metrics.on_failed(req, now)
                self._free(i)
                swept["failed"] += 1
                continue
            req.tokens.clear()
            req.served_clocks.clear()
            req.pinned_clock = -1
            slot.produced = 0
            slot.decoding = False
            swept["readmitted"] += 1
        return swept

    def _fail_remaining(self) -> None:
        now = time.perf_counter()
        for i, slot in enumerate(self.slots):
            if slot is not None:
                self.metrics.on_failed(slot.req, now)
                self._free(i)
        while True:
            req = self.queue.get()
            if req is None:
                break
            self.metrics.on_failed(req, now)
