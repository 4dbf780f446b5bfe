"""Serving host code of the port: a request queue with admission control
(``queue.py``), a continuous-batching scheduler over a fixed slot pool
(``scheduler.py``) and streaming tail-latency telemetry (``metrics.py``).
``launch/serve.py``'s ``Server`` drives them over the model.  The
reference's store-level ``service.py`` (``SnapshotService``,
``SyntheticTrainer``) and its CLI are not ported yet.
"""
from repro_torch.serve.metrics import PercentileReservoir, ServeMetrics
from repro_torch.serve.queue import Admission, Outcome, Request, RequestQueue
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         SlotExecutor, StepResult)

__all__ = [
    "Admission", "Outcome", "Request", "RequestQueue",
    "PercentileReservoir", "ServeMetrics",
    "ContinuousBatchingScheduler", "SlotExecutor", "StepResult",
]
