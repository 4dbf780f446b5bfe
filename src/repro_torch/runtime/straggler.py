"""Straggler mitigation: step-time monitoring + escalation policy.

This package's own copy of the JAX package's ``runtime/straggler.py``
(plain Python).

On a real pod, a straggling host shows up as a slow all-reduce for
everyone.  The monitor tracks a robust running median of step times and
flags steps exceeding ``threshold x median``.  Escalation is pluggable:
the default policy logs; the supervisor can be wired to treat a persistent
straggler as a failure (checkpoint-restore onto a healthy mesh via
runtime/elastic.py), which is the standard large-fleet response.
"""
from __future__ import annotations

import collections
import statistics
from typing import Callable, List, Optional


class StragglerMonitor:
    def __init__(self, *, window: int = 32, threshold: float = 3.0,
                 persist: int = 3,
                 escalate: Optional[Callable[[int, float], None]] = None):
        self.window = window
        self.threshold = threshold
        self.persist = persist
        self.escalate = escalate
        self._times = collections.deque(maxlen=window)
        self._consecutive = 0
        self.flagged: List[tuple] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step was flagged as straggling."""
        if len(self._times) >= 8:
            med = statistics.median(self._times)
            if seconds > self.threshold * med:
                self._consecutive += 1
                self.flagged.append((step, seconds, med))
                if self.escalate and self._consecutive >= self.persist:
                    self.escalate(step, seconds)
                    self._consecutive = 0
                self._times.append(seconds)
                return True
        self._consecutive = 0
        self._times.append(seconds)
        return False

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0
