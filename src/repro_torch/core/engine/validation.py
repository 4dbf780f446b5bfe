"""Commit-time read-set revalidation strategies (the paper's hot path).

Every lock-version backend revalidates its read set at commit with one of
three predicates over the current lock word vs what the transaction saw:

  * ``V_LT``  (Multiverse/DCTL, deferred clock): own locks pass; foreign
    locks/flags conflict; otherwise ``version < r_clock`` (Alg. 2
    validateLock);
  * ``V_LE``  (TL2): locked-by-other conflicts; ``version <= r_clock``;
  * ``V_EQ``  (TinySTM): locked-by-other conflicts; ``version == seen``.

``revalidate`` is the single entry point: it runs the word-at-a-time
scalar loop for small read sets and switches to the BULK path once the
read set is large enough to amortize it: ``validate_words`` over the
lock table's packed row — on the card ONE launch that gathers each
entry's lock word, splits it and evaluates the predicate, and one
read-back of the verdict.  On a CPU lock table the same call takes the
kernel's plain PyTorch version (the gather, the field split and
``validate_plain``).

NOrec validates VALUES, not versions: ``validate_values`` re-reads each
``(addr, value)`` pair against the heap — in one heap gather once the
value log reaches ``BULK_MIN`` entries (on the card a per-word read is
one blocking copy each).
"""
from __future__ import annotations

from itertools import chain
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels import validate as VK
from repro_torch.kernels.validate import V_EQ, V_LE, V_LT  # noqa: F401

#: read-set size at which the bulk path engages
BULK_MIN = 256


def check_entry(st, seen: int, r_clock: int, tid: int, mode: int) -> bool:
    """One lock word against one read-set entry (the scalar predicate)."""
    if mode == V_LT:
        if st.locked:
            return st.tid == tid
        return not st.flag and st.version < r_clock
    if st.locked and st.tid != tid:
        return False
    return st.version <= r_clock if mode == V_LE else st.version == seen


def revalidate_scalar(locks, read_set: List[tuple], r_clock: int, tid: int,
                      mode: int) -> bool:
    """The word-at-a-time loop (exact historical behavior)."""
    for idx, seen in read_set:
        if not check_entry(locks.read(idx), seen, r_clock, tid, mode):
            return False
    return True


def revalidate_bulk(locks, read_set: List[tuple], r_clock: int, tid: int,
                    mode: int) -> Optional[bool]:
    """Bulk revalidation; ``None`` when the lock table keeps no packed
    row (the host ``LockTable``)."""
    row = getattr(locks, "row", None)
    if row is None:
        return None
    # the (lock index, seen version) pairs in one pass over the tuples
    entries = np.fromiter(chain.from_iterable(read_set), np.int64,
                          2 * len(read_set)).reshape(-1, 2)
    return bool(VK.validate_words(row, entries, r_clock, tid, mode)[0])


def revalidate(locks, read_set: List[tuple], r_clock: int, tid: int,
               mode: int, bulk_min: int = BULK_MIN) -> bool:
    """Scalar below ``bulk_min`` entries, bulk at/above it."""
    if len(read_set) >= bulk_min:
        ok = revalidate_bulk(locks, read_set, r_clock, tid, mode)
        if ok is not None:
            return ok
    return revalidate_scalar(locks, read_set, r_clock, tid, mode)


def validate_values(heap, read_vals: List[tuple]) -> bool:
    """NOrec value validation: every read value must still be in place."""
    gather = getattr(heap, "gather", None)
    if gather is not None and len(read_vals) >= BULK_MIN:
        addrs = np.fromiter((p[0] for p in read_vals), np.int64,
                            len(read_vals))
        got = gather(addrs)
        if isinstance(got, torch.Tensor):
            got = got.tolist()
        return all(g == p[1] for g, p in zip(got, read_vals))
    for addr, val in read_vals:
        if heap[addr] != val:
            return False
    return True
