"""Batched transactional reads (`Txn.read_bulk`) for lock-version policies.

The paper's long-running read-only transactions scan thousands of words;
word-at-a-time through Python, the scan measures the interpreter rather
than the TM.  This module is the engine-level batch: ONE heap gather
bracketed by TWO consistent lock-word gathers — on an ``ArrayHeap`` one
bracketed ``gather_read`` launch that reads each element's lock word,
heap word and lock word again — then a stability predicate over the two
lock snapshots, evaluated on the host after one copy of the gathered
words.

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

On the device this argument needs the pre, heap and post reads to be
ordered against every writer's lock and data writes.  Every device write
of the STM's state — lock CAS and unlock (``arrayheap.py``), scatters,
publishes — is a launch or copy on the one default stream
(``kernels/_lib.py``), which executes in issue order, so no write can
land while one kernel runs: a single kernel that reads the pre word, the
heap word and the post word sees them at least as consistently as three
launches would, between which another thread's write may be enqueued.
The predicate, the verdict and the scalar fallback are the same for
both.  An ``ObjectHeap`` (host values) keeps the three gathers.

Elements that FAIL the predicate (locked, flagged, version too new, or
torn between the gathers) are NOT errors: the caller re-reads just those
through the policy's scalar path, which spins/extends/aborts with the
policy's exact semantics.

Multiverse's VERSIONED readers add a vectorized middle tier between the
batch and the scalar walk: ``gather_versioned`` enqueues ONE
``PackedVLT.select`` (one ``mirror_select`` launch) right behind the
bracketed gather, into the same output block, and brings the lock words
and the mirror's answer home in one copy; the failed elements take the
mirror's answer, and only what the mirror cannot represent walks the
version lists (``MultiversePolicy._bulk_versioned_gather``).

Own writes: encounter-time policies see their in-place values in the
heap gather already, but those addresses skip validation and the read
set (the scalar paths return them early).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.engine.arrayheap import ArrayHeap
from repro_torch.kernels import gather_read as GR
from repro_torch.kernels._lib import to_device

__all__ = ["as_addr_array", "bulk_read_lockver", "finish_with_scalar",
           "gather_lockver", "gather_row", "gather_versioned", "heap_gather",
           "lockver_verdict", "shard_partition"]


def shard_partition(shard_ids: np.ndarray, n_shards: int):
    """Group a routed address batch by shard: ``[(sid, positions)]``.

    ``shard_ids[i]`` is the shard owning batch element ``i``
    (``0 <= sid < n_shards``).  Returns one entry per shard actually
    present, ``positions`` ascending (stable sort), so the caller runs
    ONE gather/scatter per shard and reassembles order-preserving with
    ``out[positions] = shard_vals`` — the routing layer between a
    cross-shard bulk op and the per-shard kernel launches.
    """
    sid = np.asarray(shard_ids, np.int64)
    order = np.argsort(sid, kind="stable")
    bounds = np.searchsorted(sid[order], np.arange(n_shards + 1))
    return [(s, order[bounds[s]:bounds[s + 1]])
            for s in range(n_shards) if bounds[s] < bounds[s + 1]]


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


def gather_row(row: torch.Tensor, addrs: np.ndarray) -> torch.Tensor:
    """``row[addrs]`` for any 1-D int64 or int32 value row — the MVStore
    block and its ring rows: one ``gather_read`` launch on the card (the
    plain version on the CPU), returning a tensor of the row's dtype on
    its device.  Every address must lie in ``[0, len(row))``, at both
    ends, or ``IndexError`` is raised before anything launches."""
    return GR.gather_read(row, addrs)


def heap_gather(heap, addrs: np.ndarray):
    """``heap[addrs]`` in one pass.

    ``ArrayHeap`` answers with one ``gather_read`` launch (an int64
    tensor on its device); ``ObjectHeap`` with one list pass; anything
    else falls back to scalar indexing.
    """
    if isinstance(heap, ArrayHeap):
        return heap.gather(addrs)
    g = getattr(heap, "gather", None)
    if g is None:
        return [heap[int(a)] for a in addrs]
    return g(addrs)


def gather_lockver(eng, addrs: np.ndarray):
    """Enqueue a batch's bracketed gather: lock words, heap words, lock
    words again.  On an ``ArrayHeap`` that is ONE ``gather_read`` launch
    (``ArrayHeap.gather_bracketed``, under the heap lock, so ``alloc``
    cannot swap the buffer); on an ``ObjectHeap`` two lock-word launches
    around the host gather.

    Returns ``(idxs, idx_dev, words, vals)``: the lock indices (host and
    device), the two lock snapshots as one [2, N] device tensor (not yet
    copied back, so a caller can enqueue more reads keyed by the same
    indices and copy everything back at once), and the gathered values
    (on an ``ArrayHeap``, ``words`` and ``vals`` are views of the one
    output block).
    """
    locks = eng.locks
    idxs = locks.index_bulk(addrs)
    if isinstance(eng.heap, ArrayHeap):
        out = eng.heap.gather_bracketed(locks.row, idxs, addrs)
        _, _, vals, idx_dev = out.unbind(0)
        return idxs, idx_dev, out[:2], vals
    idx_dev = to_device(idxs, eng.device)
    words = torch.empty((2, addrs.size), dtype=torch.int64,
                        device=eng.device)
    locks.words_at(idxs, idx_dev, out=words[0])     # pre-gather
    vals = heap_gather(eng.heap, addrs)             # heap gather
    locks.words_at(idxs, idx_dev, out=words[1])     # post-gather
    return idxs, idx_dev, words, vals


def gather_versioned(eng, addrs: np.ndarray, mirror, r_clock: int):
    """A versioned bulk read's device work: the bracketed gather, then
    ONE ``mirror.select`` over every element behind it on the one stream
    (the post-gather is the lock gate the mirror rows need), both into
    one output block, and ONE copy back of that block.

    On an ``ArrayHeap`` the block is [6, N] (``gather_bracketed``'s four
    rows, then the mirror's values and codes) and the mirror takes the
    index copy the gather staged for a long chunk; on an ``ObjectHeap``
    it is [4, N] (the two lock snapshots around the host gather, then the
    mirror's rows), both index sets staged once.  Returns ``(idxs, words,
    mirror_rows, vals)``: the host lock indices, the two lock snapshots
    and the mirror's [2, N] (values, codes), both on the host, and the
    gathered values (a row of the block on an ``ArrayHeap``)."""
    locks = eng.locks
    idxs = locks.index_bulk(addrs)
    if isinstance(eng.heap, ArrayHeap):
        block, staged = eng.heap.gather_bracketed(locks.row, idxs, addrs,
                                                  rows=6, with_index=True)
        mirror.select(idxs, addrs, r_clock, dev_idx=staged, out=block[4:])
        host = block.cpu().numpy()
        return idxs, host[:2], host[4:], block[2]
    n = addrs.size
    both = to_device(np.concatenate((idxs, addrs)), eng.device)
    block = torch.empty((4, n), dtype=torch.int64, device=eng.device)
    locks.words_at(idxs, both[:n], out=block[0])     # pre-gather
    vals = heap_gather(eng.heap, addrs)             # heap gather
    locks.words_at(idxs, both[:n], out=block[1])     # post-gather
    mirror.select(idxs, addrs, r_clock, dev_idx=both, out=block[2:])
    host = block.cpu().numpy()
    return idxs, host[:2], host[2:], vals


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
    bracketed gather, one copy back, the verdict.  Returns ``(values, ok,
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
