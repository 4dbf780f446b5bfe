"""Transaction descriptor: the one per-thread context every backend shares.

The paper's Alg. 1 thread-locals and the baselines' contexts were two
parallel class hierarchies (``stm._TxCtx`` vs ``baselines._Ctx``) holding
the same state under different names.  ``TxnDescriptor`` is their union:

  * ``read_set``   — ``(lock_idx, version_seen)`` pairs for commit-time
                     revalidation (lock-version backends);
  * ``read_vals``  — ``(addr, value)`` pairs for value validation (NOrec);
  * ``write_map``  — buffered writes (addr -> new value; TL2/NOrec);
  * ``locked_idxs``— the set of encounter-time-locked LOCK INDICES (DCTL
                     family; irrevocable read-locks land here too) —
                     kept separate from ``write_map`` so the commit
                     pipeline's release paths always deal in deduped
                     indices, never raw addresses (``engine/commit.py``
                     normalization note);
  * ``undo``       — in-place write undo log (addr -> old value) for
                     encounter-time backends, including Multiverse;
  * ``versioned_write_set`` — addr -> (vlist, node) for TBD-version
                     rollback (Multiverse only);
  * ``alloc_log``  — txn-local allocations, freed by the engine on abort.

State lifetimes (paper Alg. 1 l.10): ``reset()`` clears per-ATTEMPT state
before each retry; ``reset_operation()`` additionally clears state that
persists across retries of one logical operation (attempt count, the K1
versioned flag, its livelock guard).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.core import modes as M

#: per-descriptor counters the engine aggregates into the stats schema
COUNTER_KEYS = ("commits", "aborts", "versioned_commits", "ro_commits",
                "mode_cas")


class TxnDescriptor:
    __slots__ = (
        "tid", "attempts", "active", "stats",
        # per-attempt
        "r_clock", "read_only", "read_cnt", "read_set", "read_vals",
        "write_map", "locked_idxs", "undo", "versioned_write_set",
        "alloc_log", "local_mode_counter", "local_mode",
        "dedup_read_set", "read_set_seen", "publish_started", "wal_lsn",
        # per-operation (survive retries)
        "versioned", "no_versioning", "initial_versioned_ts", "irrevocable")

    def __init__(self, tid: int):
        self.tid = tid
        self.attempts = 0
        self.active = False
        self.versioned = False
        self.no_versioning = False
        self.irrevocable = False
        self.initial_versioned_ts: Optional[int] = None
        self.stats = {k: 0 for k in COUNTER_KEYS}
        self.reset()

    def reset(self) -> None:
        """Per-attempt reset (called by the engine at ``begin``)."""
        self.r_clock = 0
        self.read_only = True
        self.read_cnt = 0
        self.local_mode_counter = 0
        self.local_mode = M.MODE_Q
        self.read_set: List[tuple] = []
        self.read_vals: List[tuple] = []
        self.write_map: Dict[int, Any] = {}
        self.locked_idxs: set = set()
        self.undo: Dict[int, Any] = {}
        self.versioned_write_set: Dict[int, tuple] = {}
        self.alloc_log: List[tuple] = []
        # traversal-level read-set dedup (engine/traverse.py): while set,
        # the bulk read path skips (lock_idx, version) pairs already
        # tracked — repeated frontier visits stop inflating commit-time
        # revalidation
        self.dedup_read_set = False
        self.read_set_seen: set = set()
        # commit record for crash recovery (reliability/): set once the
        # commit DECIDED and heap publication is about to begin — after a
        # crash, True means roll FORWARD from write_map, False means roll
        # back from undo
        self.publish_started = False
        # the durable twin (reliability/wal.py): lsn of this attempt's
        # WAL PREPARE; an abandoned prepare (abort/crash before DECIDE)
        # simply never replays
        self.wal_lsn: Optional[int] = None

    def reset_operation(self) -> None:
        """Per-operation reset (a NEW logical operation, not a retry)."""
        self.attempts = 0
        self.versioned = False
        self.no_versioning = False
        self.initial_versioned_ts = None

    @property
    def has_writes(self) -> bool:
        return bool(self.write_map or self.locked_idxs or self.undo
                    or self.versioned_write_set)
