"""repro_torch.api — the port's public transactional surface.

    from repro_torch.api import make_tm, atomic, run

    tm = make_tm("multiverse", n_threads=4, array_heap=True)   # the card
    base = tm.alloc(100, 0)

    @atomic(tm)
    def incr(tx, i):
        tx.write(base + i, tx.read(base + i) + 1)

    run(tm, lambda tx: int(tx.read_bulk(range(base, base + 100)).sum()))
    tm.stats()                                  # normalized schema
    tm.stop()

``device="cpu"`` runs the same code on the CPU, with each kernel's plain
PyTorch version.  ``state.load_numpy_state`` / ``dump_numpy_state`` move
the array state in and out as numpy arrays.
"""
from repro_torch.api.adapters import WordSubstrate  # noqa: F401
from repro_torch.api.registry import (  # noqa: F401
    backend_names,
    make_tm,
    register_backend,
)
from repro_torch.api.state import (  # noqa: F401
    dump_numpy_state,
    load_numpy_state,
)
from repro_torch.api.substrate import (  # noqa: F401
    AbortTx,
    MaxRetriesExceeded,
    Substrate,
    SubstrateBase,
    Txn,
    as_substrate,
    atomic,
    run,
)
from repro_torch.core.stats_schema import (  # noqa: F401
    STATS_KEYS,
    base_stats,
    normalize_stats,
)

__all__ = [
    "AbortTx", "MaxRetriesExceeded", "STATS_KEYS", "Substrate",
    "SubstrateBase", "Txn", "WordSubstrate", "as_substrate", "atomic",
    "backend_names", "base_stats", "dump_numpy_state", "load_numpy_state",
    "make_tm", "normalize_stats", "register_backend", "run",
]
