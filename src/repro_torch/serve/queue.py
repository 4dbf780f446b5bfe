"""Request queue with arrival timestamping and admission control (the
port's copy of the reference's ``serve/queue.py``).

The queue is the service's back-pressure boundary: an open-loop load
generator offers requests at wall-clock arrival times regardless of how
fast the scheduler drains them, so when the store is slow (e.g. Mode-Q
aborts burn decode steps) depth grows and the queue SHEDS instead of
letting latency run away unbounded.  Shedding is a typed outcome
(`Admission`), never an exception — the caller records it in telemetry.

Admission rejects when either bound trips:
  * depth:  queued requests >= ``max_depth``
  * wait:   estimated queue wait exceeds ``wait_budget_s``, where the
    estimate is ``depth * service_time / n_servers`` — the classic
    M/M/c eyeball using observed per-request service time fed back by
    the scheduler (``note_service_time``).

With ``autotune=True`` (the default when a budget is set) the wait
estimate uses ``max(EMA, rolling p99)`` of observed service times
instead of the EMA alone: an EMA is mean-seeking, so a bimodal service
distribution (fast cache-hit decodes + occasional Mode-Q abort storms)
lets the mean admit a queue whose TAIL blows the budget.  Tracking the
p99 reservoir effectively TIGHTENS the budget under slow-tail service —
``effective_wait_budget_s`` reports the equivalent fixed budget — and
relaxes back as the tail drains, with no operator knob.

Thread-safe: the load generator and the scheduler loop may live on
different threads.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class Admission(enum.Enum):
    """Typed admission outcome for one offered request."""

    ADMITTED = "admitted"
    SHED_DEPTH = "shed_depth"      # bounded queue full
    SHED_WAIT = "shed_wait"        # estimated wait over budget
    CLOSED = "closed"              # queue draining / shut down

    @property
    def shed(self) -> bool:
        return self in (Admission.SHED_DEPTH, Admission.SHED_WAIT)


class Outcome(enum.Enum):
    """Lifecycle outcome of an admitted request."""

    PENDING = "pending"
    COMPLETED = "completed"
    FAILED_ABORTS = "failed_aborts"   # gave up after max snapshot aborts


@dataclasses.dataclass
class Request:
    """One generation request moving through queue -> slot -> done.

    Timestamps are perf_counter seconds; ``-1.0`` means "not yet".
    ``pinned_clock`` is the snapshot clock the request is being served
    at (re-pinned after a Mode-Q abort); ``served_clocks`` records every
    clock a produced token actually came from, so telemetry can tell a
    single-version request from one that silently mixed parameter
    versions (the unversioned baseline's failure mode).
    """

    rid: int
    payload: Any = None               # model path: [S] int32 prompt
    max_new: int = 8                  # tokens wanted (incl. prefill token)
    t_arrival: float = -1.0
    t_admitted: float = -1.0
    t_dequeued: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0
    pinned_clock: int = -1
    served_clocks: List[int] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    aborts: int = 0                   # snapshot-read aborts (Mode Q)
    prefill_retries: int = 0
    outcome: Outcome = Outcome.PENDING

    @property
    def queue_wait_s(self) -> float:
        if self.t_dequeued < 0 or self.t_arrival < 0:
            return 0.0
        return self.t_dequeued - self.t_arrival

    @property
    def ttft_s(self) -> float:
        if self.t_first_token < 0 or self.t_arrival < 0:
            return 0.0
        return self.t_first_token - self.t_arrival

    @property
    def latency_s(self) -> float:
        if self.t_done < 0 or self.t_arrival < 0:
            return 0.0
        return self.t_done - self.t_arrival

    @property
    def mixed_versions(self) -> bool:
        return len(set(self.served_clocks)) > 1


class RequestQueue:
    """Bounded FIFO with wait-budget admission control.

    ``n_servers`` is the scheduler's slot count — the wait estimate
    assumes freed slots drain the queue ``n_servers`` at a time.  The
    service-time EMA starts at ``est_service_s`` and is updated by the
    scheduler on every completion, so admission adapts to the measured
    speed of the store it happens to be serving from.
    """

    def __init__(self, max_depth: int = 64,
                 wait_budget_s: Optional[float] = None,
                 n_servers: int = 1, est_service_s: float = 0.05,
                 ema_alpha: float = 0.2, autotune: bool = True,
                 reservoir_capacity: int = 512):
        from repro_torch.serve.metrics import PercentileReservoir
        self.max_depth = max_depth
        self.wait_budget_s = wait_budget_s
        self.n_servers = max(1, n_servers)
        self.ema_alpha = ema_alpha
        self.autotune = autotune
        self._service_ema = est_service_s
        self._service_p99 = PercentileReservoir(capacity=reservoir_capacity)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._closed = False
        self.counters: Dict[str, int] = {
            "offered": 0, "admitted": 0, "shed_depth": 0,
            "shed_wait": 0, "closed": 0,
        }

    # -- admission ------------------------------------------------------
    def offer(self, req: Request, now: Optional[float] = None) -> Admission:
        """Admit or shed ``req``; stamps arrival/admission times."""
        now = time.perf_counter() if now is None else now
        req.t_arrival = now if req.t_arrival < 0 else req.t_arrival
        with self._lock:
            self.counters["offered"] += 1
            if self._closed:
                self.counters["closed"] += 1
                return Admission.CLOSED
            if len(self._q) >= self.max_depth:
                self.counters["shed_depth"] += 1
                return Admission.SHED_DEPTH
            if (self.wait_budget_s is not None
                    and self._estimated_wait() > self.wait_budget_s):
                self.counters["shed_wait"] += 1
                return Admission.SHED_WAIT
            req.t_admitted = now
            self._q.append(req)
            self.counters["admitted"] += 1
            return Admission.ADMITTED

    def get(self, now: Optional[float] = None) -> Optional[Request]:
        """Non-blocking pop for the scheduler's refill pass."""
        with self._lock:
            if not self._q:
                return None
            req = self._q.popleft()
        req.t_dequeued = time.perf_counter() if now is None else now
        return req

    # -- feedback / introspection --------------------------------------
    def note_service_time(self, dt: float) -> None:
        """Scheduler feedback: observed per-request service seconds."""
        with self._lock:
            a = self.ema_alpha
            self._service_ema = (1 - a) * self._service_ema + a * dt
            self._service_p99.add(dt)

    def _per_request_s(self) -> float:
        # caller holds the lock.  Autotune: plan for the TAIL, not the
        # mean — max(EMA, p99) so a slow-tail service distribution
        # tightens admission while a uniform one degrades to the EMA.
        if self.autotune and self._service_p99.count:
            p99 = self._service_p99.percentile(99)
            if p99 == p99:                  # not NaN
                return max(self._service_ema, p99)
        return self._service_ema

    def _estimated_wait(self) -> float:
        # caller holds the lock
        return len(self._q) * self._per_request_s() / self.n_servers

    def estimated_wait_s(self) -> float:
        with self._lock:
            return self._estimated_wait()

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def service_ema_s(self) -> float:
        with self._lock:
            return self._service_ema

    @property
    def service_p99_s(self) -> float:
        with self._lock:
            return self._service_p99.percentile(99)

    @property
    def effective_wait_budget_s(self) -> Optional[float]:
        """The fixed budget this queue currently behaves like: the
        configured budget scaled by ``ema / max(ema, p99)``.  Equal to
        ``wait_budget_s`` when autotune is off or the tail is no slower
        than the mean; TIGHTER (smaller) under a slow tail."""
        with self._lock:
            if self.wait_budget_s is None:
                return None
            per = self._per_request_s()
            if per <= 0:
                return self.wait_budget_s
            return self.wait_budget_s * self._service_ema / per

    # -- drain ----------------------------------------------------------
    def close(self) -> None:
        """Stop admitting; already-queued requests still drain."""
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed
