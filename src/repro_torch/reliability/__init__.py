"""Fault injection for the commit pipelines (``faultpoints``), the
training restore path (``recovery.replay_from_checkpoint``) and the
sharded store's cross-shard commit record (``recovery.EpochRecord``).

The port keeps its own copy of the JAX package's stdlib-only
``faultpoints`` module, so the engine's hooks are the same named points.
The rest of ``recovery`` and the write-ahead log are not ported yet;
``recovery`` is imported where it is used, as the reference does.
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
