"""Transactional data structures over the `repro_torch.api` substrate surface.

Each structure takes any `make_tm(...)` product (or raw TM) at
construction and uniform `Txn` handles per operation, so one
implementation serves every backend: the five word-level TMs over
`repro_torch.core.engine` (object heap or the int64 array heap on the
card) and the MVStore's int32 block.  Long read-only operations (range
queries, size queries) are frontier-at-a-time
(`repro_torch.core.engine.traverse`): contiguous regions move through
`tx.read_bulk`, hashmap overflow chains advance in lockstep
(`chase_bulk`), and the tree range queries are ordered frontier walks
(`traverse_bulk`, one batch per level, brought home in one copy) — so
the long-running reads the paper studies vectorize end-to-end instead of
chasing pointers word-at-a-time through Python.
"""
from repro_torch.structs.abtree import ABTree  # noqa: F401
from repro_torch.structs.extbst import ExternalBST  # noqa: F401
from repro_torch.structs.hashmap import HashMap  # noqa: F401

STRUCTS = {"abtree": ABTree, "hashmap": HashMap, "extbst": ExternalBST}
