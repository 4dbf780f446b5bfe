"""repro_torch.reliability — deterministic fault injection + crash recovery.

The paper's consistency claim ("a versioned snapshot is always a
committed prefix") is exactly the property a crash-recovery path needs,
so this package makes failure a first-class, replayable scenario:

  * ``faultpoints`` — named injection points threaded through the commit
    pipelines (solo, group, MVStore fused publish) and the checkpointer
    (the port keeps its own copy of the JAX package's stdlib-only
    module, so the engine's hooks are the same named points).
  * ``recovery`` — scans the heap / lock table / MV ring after a
    simulated crash: releases orphaned locks held by dead owners, rolls
    encounter-time writes back from undo logs, rolls decided buffered
    commits FORWARD from their write maps (the ``publish_started``
    commit record), truncates torn ring rows past the last durable
    clock, repairs torn PackedVLT mirror rows, resolves a parked
    cross-shard epoch, and replays training state from the latest
    checkpoint manifest.
  * ``wal`` — the durable twin of the commit record: an fsync'd,
    CRC-framed write-ahead log (the JAX package's file format) and
    ``recover_from_wal``, which rebuilds a fresh engine, MVStore handle
    or sharded store from the log alone.

Import ``faultpoints`` directly from hot paths; the heavier modules load
lazily so the engine's import stays light.
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
    "recover_engine", "recover_handle", "RecoveryReport",
    "WriteAheadLog", "attach_wal", "recover_from_wal",
]


def __getattr__(name):
    # recovery/wal pull in numpy/torch/engine internals; keep the package
    # import featherweight for the faultpoints hooks in core modules
    if name in ("recover_engine", "recover_handle", "RecoveryReport",
                "check_engine_invariants", "check_store_invariants",
                "replay_from_checkpoint"):
        from repro_torch.reliability import recovery
        return getattr(recovery, name)
    if name in ("WriteAheadLog", "attach_wal", "recover_from_wal",
                "WalRecord", "scan_dir"):
        from repro_torch.reliability import wal
        return getattr(wal, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
