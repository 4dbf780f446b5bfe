"""Frontier-at-a-time traversal: pointer-chasing long reads in batches.

``Txn.read_bulk`` made flat scans array operations, but the struct long
reads the paper studies (range queries, size queries) are POINTER chases:
the next address depends on the last value, so a naive port walks the
interpreter hop by hop and the benchmark measures Python, not the TM.
This module closes that gap with level-synchronous traversal: per step,
the words of the ENTIRE current frontier are gathered in ONE
``tx.read_bulk`` batch, and a caller-supplied expand function turns them
into emitted results and the next frontier.  A structure of depth ``D``
with ``N`` nodes costs ``O(D)`` batched reads instead of ``O(N)`` scalar
reads.

Two entry points share the contract:

  * ``traverse_bulk(tx, roots, expand, limit=...)`` — ORDERED traversal
    (DFS/in-order) with early termination: an explicit worklist keeps
    every pending node and every emitted value in left-to-right order, so
    tree range queries emit in key order and can stop at ``limit`` even
    though expansion is breadth-batched.  Depth is heap-allocated list
    length, never Python stack.
  * ``chase_bulk(tx, cursors, advance)`` — UNORDERED uniform chase for
    single-word frontiers (overflow chains, free lists): ``advance``
    receives the whole cursor/value arrays and returns the next cursor
    array, so a round is pure numpy with no per-item Python.

Where the words live.  On an array heap or an MVStore block a clean
``read_bulk`` batch is a tensor on the store's device; reading it word by
word (``int(words[i])``) would cost one device-to-host copy and one wait
per word.  So each round's batch comes home ONCE (``host_words``), before
any ``expand`` or ``advance`` runs: callbacks see an ndarray slice on a
clean batch and a list slice when ``read_bulk`` re-read some element
through the scalar protocol, as the host-memory heaps give them.

Consistency: both functions read ONLY through ``tx.read_bulk``, which
already guarantees that every element is either proven consistent by the
vectorized predicate or transparently re-read through the owning
policy's exact scalar protocol (see ``engine/bulkread.py``).  What this
layer adds is purely the batching schedule.  The one observable
difference from a hand-rolled scalar walk: a frontier step reads every
pending node's words even when an earlier sibling would have satisfied
``limit`` first, so a concurrent writer on a node the scalar walk would
never have reached can abort the batched walk.

``expand(state, words, emit, push)`` contract:

  * ``state`` — the opaque per-item state given at push time (or the
    root tuple's third element; ``None`` if omitted);
  * ``words`` — this item's ``span`` gathered words, ``words[i]`` being
    the value at ``addr + i``;
  * ``emit(value)`` — append ``value`` to the traversal's result, in
    traversal order;
  * ``push(addr, span, state=None)`` — schedule a child item, in
    traversal order relative to this item's other emits/pushes.

``emit``/``push`` must be called synchronously inside ``expand``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["chase_bulk", "frontier_addrs", "host_words", "traverse_bulk"]

_EMIT = True
_PEND = False


def host_words(words):
    """A ``read_bulk`` result on the host: a tensor (a clean batch from an
    array heap or a store block) comes home in one copy as an ndarray of
    its dtype; a list (some element re-read through the scalar protocol)
    is returned as it is."""
    if isinstance(words, torch.Tensor):
        return words.cpu().numpy()
    return words


class _dedup_read_set:
    """Context manager: dedup read-set tracking for a traversal's reads.

    A traversal revisits lock indices across rounds (sibling nodes
    sharing a lock bucket, chains re-walked by nested queries); while
    the flag is set, the bulk read paths skip (idx, version) pairs
    already tracked, so commit-time revalidation stays proportional to
    the DISTINCT footprint, not the visit count.  Restores the previous
    flag on exit, so nested traversals compose; contexts without the
    flag (the MVStore's ``_MVCtx`` — no read set to dedup) are a no-op.
    """

    __slots__ = ("_ctx", "_prev")

    def __init__(self, tx):
        ctx = getattr(tx, "_ctx", None)
        self._ctx = ctx if hasattr(ctx, "dedup_read_set") else None

    def __enter__(self):
        if self._ctx is not None:
            self._prev = self._ctx.dedup_read_set
            self._ctx.dedup_read_set = True

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.dedup_read_set = self._prev


def frontier_addrs(bases: np.ndarray, spans: np.ndarray):
    """Flatten ``[(base, span), ...]`` into one address vector.

    Returns ``(addrs, starts, ends)`` where item ``k``'s words live at
    ``addrs[starts[k]:ends[k]]`` — the single home of the span-
    concatenation arithmetic (vectorized: no per-item ``range``)."""
    ends = np.cumsum(spans)
    starts = ends - spans
    addrs = np.repeat(bases - starts, spans) + np.arange(int(ends[-1]),
                                                         dtype=np.int64)
    return addrs, starts, ends


def traverse_bulk(tx, roots: Iterable[Sequence], expand: Callable,
                  *, limit: Optional[int] = None) -> List[Any]:
    """Ordered frontier-at-a-time traversal; returns emitted values.

    ``roots`` is an iterable of ``(addr, span)`` or ``(addr, span,
    state)`` items.  Per round, every pending item's words are gathered
    in ONE ``tx.read_bulk`` batch, brought home in one copy, and
    ``expand`` replaces each item — in worklist order — with its emits
    and child pushes, so the result list is exactly the scalar DFS
    emission order.  ``limit`` stops the traversal as soon as the
    RESOLVED prefix holds that many values (items right of an unexpanded
    node are never emitted early).
    """
    work: List[tuple] = []
    for r in roots:
        work.append((_PEND, int(r[0]), int(r[1]),
                     r[2] if len(r) > 2 else None))
    out: List[Any] = []
    with _dedup_read_set(tx):
        return _traverse_loop(tx, work, out, expand, limit)


def _traverse_loop(tx, work: List[tuple], out: List[Any],
                   expand: Callable, limit: Optional[int]) -> List[Any]:
    while work:
        # drain the resolved prefix (everything left of the first
        # pending item is final — this is what preserves DFS order)
        i, n = 0, len(work)
        while i < n and work[i][0]:
            out.append(work[i][1])
            i += 1
            if limit is not None and len(out) >= limit:
                return out
        if i:
            del work[:i]
        if not work:
            break
        # ONE batched read of the whole pending frontier, ONE copy home
        pend = [e for e in work if not e[0]]
        m = len(pend)
        bases = np.fromiter((e[1] for e in pend), np.int64, m)
        spans = np.fromiter((e[2] for e in pend), np.int64, m)
        addrs, starts, ends = frontier_addrs(bases, spans)
        words = host_words(tx.read_bulk(addrs))
        starts, ends = starts.tolist(), ends.tolist()
        # expand each pending item in place, order preserved
        new_work: List[tuple] = []
        append = new_work.append

        def emit(value):
            append((_EMIT, value, 0, None))

        def push(addr, span, state=None):
            append((_PEND, int(addr), int(span), state))

        k = 0
        for e in work:
            if e[0]:
                append(e)
            else:
                expand(e[3], words[starts[k]:ends[k]], emit, push)
                k += 1
        work = new_work
    return out


def chase_bulk(tx, cursors, advance: Callable) -> int:
    """Vectorized pointer chase for uniform single-word frontiers.

    Per round, the words at every cursor address are gathered in ONE
    ``tx.read_bulk`` batch, brought home in one copy, and
    ``advance(cursors, values)`` returns the next cursor array
    (empty/None ends the chase) — accumulation lives in the caller's
    closure.  ``values`` is a host int64 ndarray on a clean batch from an
    array heap or a store block, the list ``read_bulk`` returned
    otherwise.  Returns the number of rounds (== the longest chain's
    length in hops), which is also the number of ``read_bulk`` calls
    issued.
    """
    cur = np.asarray(cursors, dtype=np.int64)
    rounds = 0
    with _dedup_read_set(tx):
        while cur.size:
            vals = tx.read_bulk(cur)
            if isinstance(vals, torch.Tensor):
                vals = host_words(vals).astype(np.int64, copy=False)
            rounds += 1
            nxt = advance(cur, vals)
            if nxt is None:
                break
            cur = np.asarray(nxt, dtype=np.int64)
    return rounds
