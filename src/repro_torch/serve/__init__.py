"""Snapshot-serving subsystem of the port: continuous batching over
MVStore snapshots.

A request queue with admission control (``queue.py``), a
continuous-batching scheduler that keeps a fixed slot pool full and
resolves every decode step at a per-request snapshot clock through
``mv_snapshot`` (``scheduler.py``), streaming tail-latency telemetry
(``metrics.py``), and the service loop + open-loop load generator tying
them together over a store on the card (``service.py``).
``launch/serve.py``'s ``Server`` drives the same scheduler over a model.

    from repro_torch.serve import SnapshotService, ServiceConfig
    svc = SnapshotService.synthetic(ServiceConfig(mode="U"))
    summary = svc.run_open_loop()

``python -m repro_torch.serve --duration 2 --target-qps 50`` runs the
same loop from the CLI; the ``serving`` workload in ``repro_torch.eval``
drives it across the multiverse / Mode-Q / unversioned serving policies.
"""
from repro_torch.serve.metrics import PercentileReservoir, ServeMetrics
from repro_torch.serve.queue import Admission, Outcome, Request, RequestQueue
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         SlotExecutor, StepResult)
from repro_torch.serve.service import (OpenLoopLoadGen, ServiceConfig,
                                       SnapshotService, StoreExecutor,
                                       SyntheticTrainer)

__all__ = [
    "Admission", "Outcome", "Request", "RequestQueue",
    "PercentileReservoir", "ServeMetrics",
    "ContinuousBatchingScheduler", "SlotExecutor", "StepResult",
    "OpenLoopLoadGen", "ServiceConfig", "SnapshotService",
    "StoreExecutor", "SyntheticTrainer",
]
