"""The paper's own experimental configuration (SS5 of the paper).

These are the STM-level tunables and workload definitions used to reproduce
the paper's figures with the Layer-A faithful STM (core/stm.py + structs/).
"""
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MultiverseParams:
    """Tunable parameters, defaults exactly as SS5 'Tunable Parameters'."""

    k1: int = 100      # unversioned-reader attempts before going versioned
    k2: int = 16       # attempts before an unversioned reader CASes Q->QtoU
    k3: int = 28       # attempts before a versioned reader CASes Q->QtoU
    s: int = 10        # consecutive small txns to clear the sticky-U bit
    l: int = 10        # length of the commit-ts-delta average list (L)
    p: float = 0.10    # prefix fraction of the sorted delta list (P)
    lock_table_bits: int = 16       # 2^16 entries in lock/bloom/VLT tables
    bloom_bits: int = 64            # bits per per-bucket bloom filter
    unversion_poll_ms: float = 2.0  # background-thread poll period
    max_ring: int = 0               # 0 = unbounded version lists (paper)


@dataclass(frozen=True)
class WorkloadConfig:
    """One benchmark workload, paper SS5 style.

    Percentages over regular-thread ops; remaining weight after search/rq is
    split equally between insert and delete.  Dedicated updaters perform
    writes that never commit read-only and are NOT counted in throughput.
    """

    name: str
    structure: str = "abtree"       # abtree | hashmap | extbst
    prefill: int = 1_000_000
    key_range: int = 2_000_000
    search_pct: float = 0.8999
    rq_pct: float = 0.0001
    rq_size: int = 10_000
    n_threads: int = 8
    n_dedicated_updaters: int = 0
    duration_s: float = 2.0
    trials: int = 1
    updater_sleep_s: float = 0.0   # throttle dedicated updaters (GIL cal.)


# The representative workloads of Fig. 1 / Fig. 6 (scaled down for this
# container in benchmarks/ -- prefill and duration shrink, ratios preserved).
FIG6_WORKLOADS = [
    WorkloadConfig("no_rq_0upd", rq_pct=0.0, search_pct=0.90),
    WorkloadConfig("rq_0upd", rq_pct=0.0001, search_pct=0.8999),
    WorkloadConfig("no_rq_16upd", rq_pct=0.0, search_pct=0.90,
                   n_dedicated_updaters=4),
    WorkloadConfig("rq_16upd", rq_pct=0.0001, search_pct=0.8999,
                   n_dedicated_updaters=4),
]

DEFAULT_PARAMS = MultiverseParams()
