"""Batched transactional reads (`Txn.read_bulk`) for lock-version policies.

The paper's long-running read-only transactions scan thousands of words;
word-at-a-time through Python, the scan measures the interpreter rather
than the TM.  This module is the engine-level batch: ONE heap gather
bracketed by TWO consistent lock-word gathers — three ``gather_read``
launches on the device — then a stability predicate over the two lock
snapshots, evaluated on the host after one copy of the gathered words.

Soundness argument, per element ``i``:

  * ``pre``/``post`` are consistent (locked, version, tid, flag) tuples —
    the lock table packs each word into one int64, read once per gather,
    so no field tearing;
  * if ``pre.version == post.version``, both unlocked and unflagged, the
    heap word cannot have been mutated between the two gathers: every
    writer in the lock-version family locks the word before touching data
    and republishes a bumped version on release;
  * ``version <(=) r_clock`` then places the stable value at/before the
    transaction's snapshot — exactly the scalar read's validation.

On the device this argument needs the three gathers to run in the order
they were issued relative to every writer's lock and data writes: all of
them go to the one default stream (``kernels/_lib.py``), which executes
in issue order.

Elements that FAIL the predicate (locked, flagged, version too new, or
torn between the gathers) are NOT errors: the caller re-reads just those
through the policy's scalar path, which spins/extends/aborts with the
policy's exact semantics.

Multiverse's VERSIONED readers add a vectorized middle tier between the
batch and the scalar walk: the failed elements resolve through ONE
``PackedVLT.select`` over the device mirror (the ``version_select``
kernel), and only what the mirror cannot represent walks the version
lists (``MultiversePolicy._bulk_versioned_gather``).

Own writes: encounter-time policies see their in-place values in the
heap gather already, but those addresses skip validation and the read
set (the scalar paths return them early).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.engine.arrayheap import ArrayHeap
from repro_torch.kernels._lib import to_device

__all__ = ["as_addr_array", "bulk_read_lockver", "finish_with_scalar",
           "gather_lockver", "heap_gather", "lockver_verdict"]


def as_addr_array(addrs: Sequence[int]) -> np.ndarray:
    """Normalize any address batch (range, list, ndarray, tensor) to a
    host int64[N] array."""
    if isinstance(addrs, np.ndarray):
        return addrs.astype(np.int64, copy=False).reshape(-1)
    if isinstance(addrs, range):
        return np.arange(addrs.start, addrs.stop, addrs.step, np.int64)
    if isinstance(addrs, torch.Tensor):
        return addrs.reshape(-1).cpu().numpy().astype(np.int64, copy=False)
    return np.fromiter((int(a) for a in addrs), np.int64)


def heap_gather(heap, addrs: np.ndarray, dev_idx=None):
    """``heap[addrs]`` in one pass.

    ``ArrayHeap`` answers with one ``gather_read`` launch (an int64
    tensor on its device; ``dev_idx`` is the addresses already copied
    there); ``ObjectHeap`` with one list pass; anything else falls back
    to scalar indexing.
    """
    if isinstance(heap, ArrayHeap):
        return heap.gather(addrs, dev_idx)
    g = getattr(heap, "gather", None)
    if g is None:
        return [heap[int(a)] for a in addrs]
    return g(addrs)


def gather_lockver(eng, addrs: np.ndarray):
    """Enqueue a batch's three gathers: lock words, heap words, lock
    words again — three ``gather_read`` launches in this order on the one
    stream.  One host->device copy carries both index sets.

    Returns ``(idxs, idx_dev, words, vals)``: the lock indices (host and
    device), the two lock snapshots as one [2, N] device tensor (not yet
    copied back, so a caller can enqueue more reads keyed by the same
    indices and copy everything back at once), and the gathered values.
    """
    locks = eng.locks
    n = addrs.size
    idxs = locks.index_bulk(addrs)
    both = to_device(np.concatenate((idxs, addrs)), eng.device)
    words = torch.empty((2, n), dtype=torch.int64, device=eng.device)
    locks.words_at(idxs, both[:n], out=words[0])     # pre-gather
    vals = heap_gather(eng.heap, addrs, both[n:])    # heap gather
    locks.words_at(idxs, both[:n], out=words[1])     # post-gather
    return idxs, both[:n], words, vals


def lockver_verdict(eng, d, addrs: np.ndarray, idxs: np.ndarray,
                    words: np.ndarray, *, inclusive: bool, track: bool):
    """The stability predicate over the two lock snapshots (host
    ``words`` [2, N]).

    ``inclusive`` selects the version predicate for NEW reads:
    ``version <= r_clock`` vs strict ``<`` (the Multiverse/DCTL deferred
    clock).  ``track`` appends accepted entries to ``d.read_set`` for
    commit-time revalidation — versioned Multiverse readers pass
    ``track=False``.

    Returns ``(ok, frozen)`` host bool[N] masks.  ``frozen`` marks the
    elements whose lock word was free, unflagged and unchanged across
    the two gathers, whatever its version (what Multiverse's Mode-U
    lock-freeze read needs).  Own in-place writes (``addr in d.undo``)
    are accepted as-is, unvalidated and untracked, like the scalar
    paths.
    """
    locks = eng.locks
    ver1, _, meta1 = locks.host_fields(words[0])
    ver2, _, meta2 = locks.host_fields(words[1])
    # locked-by-me also fails here: the scalar fallback resolves own locks
    # exactly (and encounter-time policies reach own writes via d.undo)
    stable = ver1 == ver2
    locked = ((meta1 | meta2) & 1) != 0
    flagged = ((meta1 | meta2) & 2) != 0
    frozen = ~locked & ~flagged & stable
    if inclusive:
        ok = frozen & (ver1 <= d.r_clock)
    else:
        ok = frozen & (ver1 < d.r_clock)
    if d.undo:
        own = np.fromiter(d.undo.keys(), np.int64, len(d.undo))
        own_mask = np.isin(addrs, own)
        ok = ok | own_mask
    else:
        own_mask = None
    if track:
        accept = ok if own_mask is None else (ok & ~own_mask)
        sel = np.nonzero(accept)[0]
        pairs = zip(idxs[sel].tolist(), ver1[sel].tolist())
        if d.dedup_read_set:
            # traversal-level dedup: a repeated visit re-proves the same
            # (idx, version) pair; the same index at a DIFFERENT version
            # must still be tracked (V_EQ revalidates the version seen)
            seen = d.read_set_seen
            rs = d.read_set
            for p in pairs:
                if p not in seen:
                    seen.add(p)
                    rs.append(p)
        else:
            d.read_set.extend(pairs)
    return ok, frozen


def bulk_read_lockver(eng, d, addrs: np.ndarray, *, inclusive: bool,
                      track: bool = True):
    """One batched read attempt against the lock-version protocol: the
    three gathers, one copy back, the verdict.  Returns ``(values, ok,
    frozen)``: ``values`` is the gathered batch (a device tensor, or a
    list on an object heap), meaningful where ``ok``; see
    ``lockver_verdict`` for the masks."""
    idxs, _, words, vals = gather_lockver(eng, addrs)
    ok, frozen = lockver_verdict(eng, d, addrs, idxs, words.cpu().numpy(),
                                 inclusive=inclusive, track=track)
    return vals, ok, frozen


def finish_with_scalar(eng, d, addrs: np.ndarray, vals, ok, scalar_read):
    """Materialize the batch result: accepted elements from the gather,
    everything else re-read through ``scalar_read(eng, d, addr)``.
    Returns the gathered device tensor untouched on a clean batch (the
    fast path a scan sums over), a list when any element was re-read."""
    if bool(ok.all()):
        return vals
    out = vals if isinstance(vals, list) else vals.tolist()
    for i in np.nonzero(~ok)[0]:
        out[i] = scalar_read(eng, d, int(addrs[i]))
    return out
