"""repro_torch.core.engine — the shared transaction-engine layer.

One ``TransactionEngine`` (heap + clock + lock table + descriptors +
commit/abort orchestration) drives every word-level backend; the
algorithm itself is a ``TMPolicy`` object (``core/stm.py``,
``core/baselines.py``).  Layered as:

    descriptor.py   TxnDescriptor — unified per-thread txn context
    validation.py   commit-time revalidation (scalar + bulk kernel)
    bulkread.py     batched reads (Txn.read_bulk): three gather_read
                    launches + stability predicate, scalar fallback
    commit.py       lock-acquire / write-back / release / rollback steps
    groupcommit.py  CommitBatcher: conflict-disjoint groups published at
                    one clock tick through the commit_fused kernel
    policy.py       TMPolicy protocol + PolicyBase defaults
    arrayheap.py    ObjectHeap / device ArrayHeap / packed ArrayLockTable
    engine.py       TransactionEngine + the _Tx user handle
"""
from repro_torch.core.engine.arrayheap import (  # noqa: F401
    ArrayHeap,
    ArrayLockTable,
    ObjectHeap,
    resolve_device,
)
from repro_torch.core.engine.bulkread import (  # noqa: F401
    as_addr_array,
    bulk_read_lockver,
    heap_gather,
)
from repro_torch.core.engine.descriptor import (  # noqa: F401
    COUNTER_KEYS,
    TxnDescriptor,
)
from repro_torch.core.engine.engine import (  # noqa: F401
    TMBase,
    TransactionEngine,
    _Tx,
)
from repro_torch.core.engine.errors import (  # noqa: F401
    AbortTx,
    MaxRetriesExceeded,
)
from repro_torch.core.engine.policy import PolicyBase, TMPolicy  # noqa: F401
from repro_torch.core.engine.validation import (  # noqa: F401
    BULK_MIN,
    V_EQ,
    V_LE,
    V_LT,
)

__all__ = [
    "ArrayHeap", "ArrayLockTable", "BULK_MIN", "COUNTER_KEYS",
    "MaxRetriesExceeded", "AbortTx", "ObjectHeap", "PolicyBase", "TMBase",
    "TMPolicy", "TransactionEngine", "TxnDescriptor", "V_EQ", "V_LE",
    "V_LT", "as_addr_array", "bulk_read_lockver", "heap_gather",
    "resolve_device",
]
