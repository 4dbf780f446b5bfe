"""Serving telemetry: streaming percentiles, QPS, occupancy, clock lag
(the port's copy of the reference's ``serve/metrics.py``).

Everything here is O(1)-ish per event so it can sit inside the decode
loop: percentile distributions go through a fixed-capacity reservoir
(Vitter's Algorithm R — uniform sample of an unbounded stream), QPS
comes from a sliding window of completion timestamps, and slot
occupancy is two counters bumped once per scheduler step.

``ServeMetrics.summary()`` emits one FLAT row in the shape of the JAX
package's eval rows.
"""
from __future__ import annotations

import random
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.stats_schema import normalize_stats
from repro_torch.serve.queue import Outcome, Request


class PercentileReservoir:
    """Streaming percentile estimator (Algorithm-R reservoir sample).

    Keeps a uniform sample of ``capacity`` observations; quantiles are
    exact while ``count <= capacity`` (np.percentile over everything)
    and an unbiased estimate past it.  Deterministic under a fixed seed
    — replacement uses its own ``random.Random``, not the global RNG.
    """

    def __init__(self, capacity: int = 4096, seed: int = 0):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._rng = random.Random(seed)
        self._buf: List[float] = []
        self.count = 0

    def add(self, x: float) -> None:
        self.count += 1
        if len(self._buf) < self.capacity:
            self._buf.append(float(x))
            return
        j = self._rng.randrange(self.count)
        if j < self.capacity:
            self._buf[j] = float(x)

    def percentile(self, q: float) -> float:
        """q in [0, 100]; NaN when no samples have been observed."""
        if not self._buf:
            return float("nan")
        return float(np.percentile(np.asarray(self._buf), q))

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)
                    ) -> Dict[str, float]:
        return {f"p{g:g}": self.percentile(g) for g in qs}

    @property
    def mean(self) -> float:
        return float(np.mean(self._buf)) if self._buf else float("nan")


class ServeMetrics:
    """Per-request and per-step telemetry for the serving loop.

    The scheduler calls ``on_step`` once per iteration (occupancy),
    ``on_snapshot_abort`` per failed decode/prefill snapshot read, and
    ``on_complete``/``on_failed`` at end of a request's life.  Torn
    reads (a resolved view mixing parameter versions WITHIN one step —
    the invariant the executor checks) land in ``violations``; the
    unversioned baseline's cross-step version mixing is the separate,
    non-gating ``mixed_version_requests``.
    """

    def __init__(self, reservoir_capacity: int = 4096, seed: int = 0,
                 qps_window_s: float = 2.0):
        mk = lambda i: PercentileReservoir(reservoir_capacity, seed + i)
        self.latency = mk(1)          # request total latency (s)
        self.ttft = mk(2)             # time to first token (s)
        self.queue_wait = mk(3)       # arrival -> dequeued (s)
        self.clock_lag = mk(4)        # store clock - pinned clock at done
        self.completed = 0
        self.failed_aborts = 0        # requests dropped after max aborts
        self.snapshot_aborts = 0      # per-step ok=False events (Mode Q)
        self.prefill_retries = 0
        self.mixed_version_requests = 0
        self.violations = 0           # torn reads — gates the eval CLI
        self.tokens_out = 0
        self.steps = 0
        self.active_slot_steps = 0
        self.total_slot_steps = 0
        self.qps_window_s = qps_window_s
        self._done_ts: deque = deque()
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- scheduler hooks ------------------------------------------------
    def on_step(self, active_slots: int, total_slots: int) -> None:
        self.steps += 1
        self.active_slot_steps += active_slots
        self.total_slot_steps += total_slots

    def on_snapshot_abort(self, n: int = 1) -> None:
        self.snapshot_aborts += n

    def on_prefill_retry(self, n: int = 1) -> None:
        self.prefill_retries += n

    def on_violation(self, n: int = 1) -> None:
        self.violations += n

    def on_complete(self, req: Request, now: Optional[float] = None,
                    store_clock: Optional[int] = None) -> None:
        now = time.perf_counter() if now is None else now
        req.t_done = now
        req.outcome = Outcome.COMPLETED
        self.completed += 1
        self.tokens_out += len(req.tokens) if req.tokens else req.max_new
        self.latency.add(req.latency_s)
        self.ttft.add(req.ttft_s)
        self.queue_wait.add(req.queue_wait_s)
        if store_clock is not None and req.pinned_clock >= 0:
            self.clock_lag.add(store_clock - req.pinned_clock)
        if req.mixed_versions:
            self.mixed_version_requests += 1
        self._t_first = now if self._t_first is None else self._t_first
        self._t_last = now
        self._done_ts.append(now)
        cutoff = now - self.qps_window_s
        while self._done_ts and self._done_ts[0] < cutoff:
            self._done_ts.popleft()

    def on_failed(self, req: Request, now: Optional[float] = None) -> None:
        req.t_done = time.perf_counter() if now is None else now
        req.outcome = Outcome.FAILED_ABORTS
        self.failed_aborts += 1

    # -- derived --------------------------------------------------------
    @property
    def occupancy(self) -> float:
        if self.total_slot_steps == 0:
            return 0.0
        return self.active_slot_steps / self.total_slot_steps

    def rolling_qps(self, now: Optional[float] = None) -> float:
        """Completions per second over the trailing window."""
        if not self._done_ts:
            return 0.0
        now = time.perf_counter() if now is None else now
        window = min(self.qps_window_s,
                     max(now - self._done_ts[0], 1e-9))
        n = sum(1 for t in self._done_ts if t >= now - self.qps_window_s)
        return n / window

    def achieved_qps(self, measured_s: Optional[float] = None) -> float:
        if measured_s and measured_s > 0:
            return self.completed / measured_s
        if self._t_first is None or self._t_last is None \
                or self._t_last <= self._t_first:
            return 0.0
        return self.completed / (self._t_last - self._t_first)

    # -- the results-schema row ----------------------------------------
    def summary(self, measured_s: Optional[float] = None,
                backend: str = "", mode: str = "-") -> Dict:
        """Flat row (the eval rows' shape): latency in ms."""
        ms = 1e3
        row = {
            "completed": self.completed,
            "failed_aborts": self.failed_aborts,
            "snapshot_aborts": self.snapshot_aborts,
            "prefill_retries": self.prefill_retries,
            "mixed_version_requests": self.mixed_version_requests,
            "violations": self.violations,
            "tokens_out": self.tokens_out,
            "qps": self.achieved_qps(measured_s),
            "p50_ms": self.latency.percentile(50) * ms,
            "p95_ms": self.latency.percentile(95) * ms,
            "p99_ms": self.latency.percentile(99) * ms,
            "ttft_p50_ms": self.ttft.percentile(50) * ms,
            "ttft_p99_ms": self.ttft.percentile(99) * ms,
            "queue_wait_p50_ms": self.queue_wait.percentile(50) * ms,
            "queue_wait_p99_ms": self.queue_wait.percentile(99) * ms,
            "clock_lag_p50": self.clock_lag.percentile(50),
            "clock_lag_p99": self.clock_lag.percentile(99),
            "occupancy": self.occupancy,
            "scheduler_steps": self.steps,
        }
        # normalized TM-stats projection: a serving row is a reader-side
        # transaction stream — completions commit, snapshot aborts abort
        row["stm_stats"] = normalize_stats(
            {"commits": self.completed,
             "aborts": self.snapshot_aborts + self.prefill_retries,
             "ro_commits": self.completed},
            backend=backend, mode=mode)
        return row
