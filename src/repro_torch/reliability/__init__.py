"""Fault injection for the commit pipelines (``faultpoints``).

The port keeps its own copy of the JAX package's stdlib-only
``faultpoints`` module, so the engine's hooks are the same named points.
Recovery and the write-ahead log are not ported yet.
"""
from repro_torch.reliability.faultpoints import (  # noqa: F401
    FAULT_POINTS,
    Fault,
    FaultError,
    FaultSchedule,
    ProcessCrashed,
    SimulatedCrash,
    SimulatedProcessDeath,
    ThreadKilled,
)

__all__ = [
    "FAULT_POINTS", "Fault", "FaultError", "FaultSchedule",
    "ProcessCrashed", "SimulatedCrash", "SimulatedProcessDeath",
    "ThreadKilled",
]
