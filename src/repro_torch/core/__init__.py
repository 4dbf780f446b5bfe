"""The word-level Multiverse STM (``stm.py``) and what it is built from:
the clock, lock table, bloom filters, version lists and their device
mirror (``vlt.py``), epoch-based reclamation, the mode machine and the
K/S/L/P heuristics, over the transaction engine in ``engine/``; and
the same dynamic multiversioning at parameter-block granularity, the
MVStore (``mvstore.py``), driven by ``mvcontroller.py``."""
from repro_torch.core.mvstore import (  # noqa: F401
    MVStoreState,
    mv_commit,
    mv_init,
    mv_snapshot,
    ring_bytes,
    unversion_blocks,
    version_blocks,
    versioned_paths,
)
