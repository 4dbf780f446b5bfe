"""Normalized TM statistics schema shared by every backend.

Every substrate — Multiverse, the four baselines, and the Layer-B
MVStoreHandle — reports the SAME key set from ``stats()``.  Counters a
backend does not implement stay 0 (a TL2 instance never versions, so its
``versioned_commits`` is structurally zero, not missing).  This is what
lets benchmarks/run.py and the conformance tests treat backends uniformly
instead of special-casing key sets per TM.

Keys:
  commits              update-transaction commits
  aborts               aborts (all causes)
  ro_commits           read-only commits
  versioned_commits    read-only commits that used the versioned path
  mode_cas             successful Q->QtoU CASes by worker transactions
  mode_transitions     total mode-counter advances
  unversioned_buckets  buckets (word level) / blocks (store level) reclaimed
  ebr_freed            version nodes freed by epoch-based reclamation
  rolled_forward       crashed commits recovery redid (decided records)
  rolled_back          crashed attempts recovery dropped (undecided)
  locks_swept          orphaned lock words the owner scan released
  torn_rows_repaired   torn PackedVLT mirror rows reset by recovery
  wal_records_replayed durable WAL records replayed on restart
  mode                 current global mode name ("Q"/"QtoU"/"U"/"UtoQ"),
                       or "-" for backends with no mode machinery
  backend              backend class/registry name

The five recovery counters are ``reliability.recovery.RecoveryReport``
projected through ``as_stats()`` — every ``recover_*`` accumulates them
into the target's ``recovery_counters`` so they surface here instead of
as ad-hoc report fields.
"""
from __future__ import annotations

from typing import Dict, Optional

RECOVERY_STAT_KEYS = (
    "rolled_forward",
    "rolled_back",
    "locks_swept",
    "torn_rows_repaired",
    "wal_records_replayed",
)

STATS_COUNTER_KEYS = (
    "commits",
    "aborts",
    "ro_commits",
    "versioned_commits",
    "mode_cas",
    "mode_transitions",
    "unversioned_buckets",
    "ebr_freed",
) + RECOVERY_STAT_KEYS

STATS_KEYS = STATS_COUNTER_KEYS + ("mode", "backend")


def base_stats(backend: str = "", mode: str = "-") -> Dict[str, object]:
    """A zeroed stats dict in the shared schema."""
    out: Dict[str, object] = {k: 0 for k in STATS_COUNTER_KEYS}
    out["mode"] = mode
    out["backend"] = backend
    return out


def normalize_stats(raw: Optional[Dict], backend: str = "",
                    mode: Optional[str] = None) -> Dict[str, object]:
    """Project an arbitrary stats dict onto the shared schema.

    Unknown keys are dropped, missing counters default to 0; ``mode`` and
    ``backend`` fall back to the raw dict's values when not given.
    """
    raw = raw or {}
    out = base_stats(backend=backend or str(raw.get("backend", "")),
                     mode=mode or str(raw.get("mode", "-")))
    for k in STATS_COUNTER_KEYS:
        if k in raw:
            out[k] = int(raw[k])
    return out
