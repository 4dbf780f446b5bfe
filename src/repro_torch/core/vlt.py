"""Version List Table (paper SS3.1, Fig. 2) + its packed device mirror.

Each bucket is a linked list of VLT nodes; a node holds (1) the head of a
version list, (2) the address it tracks, (3) the next bucket node.  Version
lists are linked lists of VListNode(older, timestamp, data, tbd), newest
first.  The address's lock (same index) protects all VLT mutations.  The
lists are host Python objects.

DELETED_TS marks versions rolled back by an aborted writer so concurrent
traversals are never permanently blocked on a TBD mark (paper SS4.1).

The bucket lists are what writers MUTATE; what bulk readers need is a
gather-friendly view of what they would FIND.  ``PackedVLT`` is that
view: int64 tensors ON THE DEVICE, indexed like the lock table, holding
each bucket's newest ``depth`` COMMITTED ``(timestamp, data)`` pairs,
maintained under the same address lock that protects the list mutations
and bracketed by a per-row seqlock for lock-free readers.  A versioned
bulk read resolves its recently-written minority through ONE
``PackedVLT.gather`` (the ``version_select`` kernel over the gathered
rows) and ``resolve`` instead of walking version lists node by node.  Rows the mirror
cannot represent (hash-colliding addresses beyond the ways, non-integer
payloads, versions deeper than ``depth``) fail ``resolve`` and fall back
to the exact scalar traversal.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine.arrayheap import resolve_device
from repro_torch.kernels import version_select as VS
from repro_torch.kernels._lib import to_device

DELETED_TS = -2

#: empty mirror slot: never strictly below any snapshot clock, so the
#: selection predicate rejects it with no special-casing
EMPTY_TS = 1 << 62


class VListNode:
    __slots__ = ("older", "timestamp", "data", "tbd", "freed")

    def __init__(self, older, timestamp, data, tbd):
        self.older = older
        self.timestamp = timestamp
        self.data = data
        self.tbd = tbd
        self.freed = False          # EBR poison bit (use-after-free checks)


class VersionList:
    __slots__ = ("head",)

    def __init__(self, head: Optional[VListNode] = None):
        self.head = head


class VLTNode:
    __slots__ = ("vlist", "addr", "next", "freed")

    def __init__(self, vlist: VersionList, addr: int,
                 nxt: Optional["VLTNode"]):
        self.vlist = vlist
        self.addr = addr
        self.next = nxt
        self.freed = False


def _packable(data) -> bool:
    """Only plain int64-range integers ride in the packed mirror: Python
    and numpy ints, and 0-d integer tensors (values a device heap hands
    back) — anything else would poison the mirror way."""
    if isinstance(data, torch.Tensor):
        if data.dim() != 0 or data.dtype not in (torch.int64, torch.int32):
            return False
    elif type(data) not in (int, np.int64, np.int32):
        return False
    return -(1 << 62) < int(data) < (1 << 62)


class PackedVLT:
    """Gather-friendly device mirror of each bucket's newest versions.

    Tensors indexed by lock-table index: ``seq`` (per-row seqlock),
    ``addr`` ([size, ways] — WHICH addresses each row tracks, or a
    sentinel per way), and the newest-first ``ts``/``data`` version
    slots ([size, ways, depth]).  The second address hashing into a
    bucket claims the second WAY and both stay vectorizable
    (``way_hits[w]`` counts reads each way served); only when every way
    is taken does a further colliding address go unmirrored.

    WRITERS mutate a row only while holding the row's address lock,
    bumping ``seq`` odd before and even after.  READERS hold nothing:
    ``gather`` brackets its row gathers with two ``seq`` gathers and
    ``resolve`` accepts only rows that were stable and even across the
    window.  On
    the device the bracket holds because writers and readers issue on
    the one default stream, which runs their operations in issue order.

    TBD (uncommitted) versions are never mirrored, so callers MUST gate
    acceptance on the address lock being free, gathered BEFORE the row
    (``MultiversePolicy._bulk_versioned_gather``).
    """

    NO_ADDR = -1       # way empty (tracks no versioned address)
    UNPACKABLE = -2    # way poisoned (non-int payload reached a tracked
    #                    address): never resolves -> scalar fallback

    def __init__(self, size: int, depth: int = 4, ways: int = 2,
                 device=None):
        self.size = size
        self.depth = depth
        self.ways = ways
        self.device = resolve_device(device)
        kw = dict(dtype=torch.int64, device=self.device)
        self._seq = torch.zeros(size, **kw)
        self._addr = torch.full((size, ways), self.NO_ADDR, **kw)
        #: host copy of ``_addr``, written together with it by writers
        #: holding the bucket's lock: writers look ways up here, so a
        #: version publish never waits on the card (readers gather the
        #: device copy inside their seqlock bracket)
        self._ways = np.full((size, ways), self.NO_ADDR, np.int64)
        # ts and data side by side, so one row gather fetches both
        self._tsdata = torch.zeros((2, size, ways, depth), **kw)
        self._ts, self._data = self._tsdata[0], self._tsdata[1]
        self._ts.fill_(EMPTY_TS)
        #: reads served per way (way_hits[1:] are the collision wins the
        #: multi-way layout buys)
        self.way_hits = [0] * ways

    def _way_of(self, bucket: int, addr: int) -> Optional[int]:
        w = np.nonzero(self._ways[bucket] == addr)[0]
        return int(w[0]) if w.size else None

    # -- writer side (caller holds the address lock for ``bucket``) ------
    def seed(self, bucket: int, addr: int, head: VListNode) -> None:
        """A version list was inserted for ``addr`` in ``bucket``: claim
        the first free way.  Unrepresentable heads and way overflow
        claim NOTHING — an unmirrored address never resolves,
        which is already the safe fail-closed answer."""
        if head is None or head.tbd or head.timestamp == DELETED_TS \
                or not _packable(head.data):
            return
        w = self._way_of(bucket, self.NO_ADDR)
        if w is None:
            return                     # all ways busy: not mirrored
        self._seq[bucket].add_(1)
        self._ways[bucket, w] = addr
        self._addr[bucket, w] = addr
        self._ts[bucket, w, 0] = head.timestamp
        self._ts[bucket, w, 1:] = EMPTY_TS
        self._data[bucket, w, 0] = int(head.data)
        self._seq[bucket].add_(1)

    def publish(self, bucket: int, addr: int, ts: int, data) -> None:
        """A commit published a NEW newest version for ``addr``."""
        w = self._way_of(bucket, addr)
        if w is None:
            return                     # unmirrored/poisoned: no-op
        self._seq[bucket].add_(1)
        if _packable(data):
            # clone: the shift reads and writes overlapping slots
            self._tsdata[:, bucket, w, 1:] = \
                self._tsdata[:, bucket, w, :-1].clone()
            self._ts[bucket, w, 0] = ts
            self._data[bucket, w, 0] = int(data)
        else:
            # the newest version is unrepresentable; serving older slots
            # would time-travel, so the way must fall back until cleared
            self._ways[bucket, w] = self.UNPACKABLE
            self._addr[bucket, w] = self.UNPACKABLE
        self._seq[bucket].add_(1)

    def publish_bulk(self, buckets: np.ndarray, addrs: np.ndarray,
                     ts: int, datas) -> None:
        """One batched mirror refresh for a whole commit's version set
        (caller holds every address lock).  Per UNIQUE bucket a single
        seqlock bracket — NOT one per entry: two ways of one bucket
        bumped separately would pass through an even mid-update ``seq``
        and a reader could accept a half-refreshed row.  The slot shift
        is one vectorized assignment over all matched (bucket, way)
        pairs; unpackable payloads take the scalar ``publish`` (which
        poisons their way) after the sweep.
        """
        b = np.asarray(buckets, np.int64)
        a = np.asarray(addrs, np.int64)
        packable = np.fromiter((_packable(x) for x in datas), bool, a.size)
        vals = np.fromiter((int(x) if ok else 0
                            for x, ok in zip(datas, packable)),
                           np.int64, a.size)
        dev = self.device
        match = self._ways[b] == a[:, None]            # [M, ways]
        way = np.argmax(match, axis=1)                 # first match
        tracked = match.any(axis=1)
        hit = tracked & packable
        if hit.any():
            # distinct pairs: a way tracks ONE address and addrs are
            # dict-keyed unique
            hb, hw = to_device(b[hit], dev), to_device(way[hit], dev)
            uniq = to_device(np.unique(b[hit]), dev)
            self._seq[uniq] += 1
            self._ts[hb, hw, 1:] = self._ts[hb, hw, :-1]   # gathered copy
            self._data[hb, hw, 1:] = self._data[hb, hw, :-1]
            self._ts[hb, hw, 0] = ts
            self._data[hb, hw, 0] = to_device(vals[hit], dev)
            self._seq[uniq] += 1
        for i in np.nonzero(tracked & ~packable)[0]:
            self.publish(int(b[i]), int(a[i]), ts, datas[int(i)])

    def clear(self, bucket: int) -> None:
        """The bucket was unversioned (paper SS4.4): forget everything."""
        self._seq[bucket].add_(1)
        self._ways[bucket] = self.NO_ADDR
        self._addr[bucket] = self.NO_ADDR
        self._ts[bucket] = EMPTY_TS
        self._seq[bucket].add_(1)

    # -- reader side (lock-free) -----------------------------------------
    def gather(self, idx: torch.Tensor,
               r_clock: int) -> Tuple[torch.Tensor, ...]:
        """Enqueue the seqlock-bracketed row gather for lock indices
        ``idx`` (a device tensor) and one ``version_select`` launch over
        every way of every row.  Returns device tensors ``(seq_before,
        seq_after, rows_addr [N, ways], values [N, ways], found [N,
        ways])`` for ``resolve``; nothing is copied back here, so the
        caller can bring them home in one transfer with its own reads."""
        n, ways, depth = idx.numel(), self.ways, self.depth
        s1 = self._seq[idx]
        rows_addr = self._addr[idx]                    # [N, ways]
        td = self._tsdata[:, idx]                      # [2, N, ways, depth]
        s2 = self._seq[idx]
        vals, found = VS.version_select(td[0].reshape(n * ways, depth),
                                        td[1].reshape(n * ways, depth),
                                        r_clock)
        return s1, s2, rows_addr, vals.view(n, ways), found.view(n, ways)

    def resolve(self, s1, s2, rows_addr, vals, found,
                addrs) -> Tuple[np.ndarray, np.ndarray]:
        """``gather``'s results, on the host, for the rows of ``addrs``:
        ``(values int64[N], ok bool[N])``.  A row counts only if its
        seqlock was even and unchanged across the gather and one of its
        ways tracks the address (the first such way is taken)."""
        stable = (s1 == s2) & ((s1 & 1) == 0)
        match = rows_addr == np.asarray(addrs, np.int64)[:, None]
        way = np.argmax(match, axis=1)                 # first (only) match
        rows = np.arange(way.size)
        ok = stable & match.any(axis=1) & (found[rows, way] != 0)
        for w in range(1, self.ways):
            hits = int((ok & (way == w)).sum())
            if hits:
                self.way_hits[w] += hits
        return vals[rows, way], ok

    # -- state carry-across (api/state.py) --------------------------------
    def arrays(self) -> Tuple[torch.Tensor, ...]:
        """``(seq, addr, ts, data)`` — the mirror's device tensors."""
        return self._seq, self._addr, self._ts, self._data

    def load(self, seq, addr, ts, data) -> None:
        """Overwrite the mirror with host arrays shaped like ``arrays()``
        (no reader or writer may be active)."""
        for dst, src in zip(self.arrays(), (seq, addr, ts, data)):
            src = np.asarray(src, np.int64)
            if src.shape != tuple(dst.shape):
                raise ValueError(f"mirror array is {tuple(dst.shape)}, "
                                 f"got {src.shape}")
            dst.copy_(torch.from_numpy(src.copy()))
        self._ways[:] = np.asarray(addr, np.int64)


class VLT:
    def __init__(self, buckets_bits: int, mirror_depth: int = 4,
                 device=None):
        self.size = 1 << buckets_bits
        self._buckets: List[Optional[VLTNode]] = [None] * self.size
        self.mirror = PackedVLT(self.size, depth=mirror_depth,
                                device=device)
        #: live count of nonempty buckets, guarded by ``_count_lock``
        #: (two inserts under DIFFERENT bucket locks could otherwise lose
        #: an increment, and a count of 0 with a populated bucket would
        #: let the batched Mode-Q write path skip version publication).
        #: Reads are single attribute loads and need no lock.
        self.nonempty_count = 0
        self._count_lock = threading.Lock()

    def get(self, bucket: int, addr: int) -> Optional[VersionList]:
        """tryGetVList: walk the bucket list (caller saw a bloom hit)."""
        node = self._buckets[bucket]
        while node is not None:
            assert not node.freed, "use-after-free: VLT node"
            if node.addr == addr:
                return node.vlist
            node = node.next
        return None

    def insert(self, bucket: int, addr: int, vlist: VersionList) -> None:
        """Prepend (caller holds the address lock)."""
        if self._buckets[bucket] is None:
            with self._count_lock:
                self.nonempty_count += 1
        self._buckets[bucket] = VLTNode(vlist, addr, self._buckets[bucket])
        self.mirror.seed(bucket, addr, vlist.head)

    def take_bucket(self, bucket: int) -> Optional[VLTNode]:
        """Detach the whole bucket (unversioning; caller holds the lock)."""
        head = self._buckets[bucket]
        if head is not None:
            with self._count_lock:
                self.nonempty_count -= 1
        self._buckets[bucket] = None
        self.mirror.clear(bucket)
        return head

    def bucket_newest_ts(self, bucket: int) -> Optional[int]:
        """Most recent (non-TBD) timestamp in the bucket, for the
        unversioning heuristic (paper SS4.4)."""
        newest = None
        node = self._buckets[bucket]
        while node is not None:
            v = node.vlist.head
            while v is not None and (v.tbd or v.timestamp == DELETED_TS):
                v = v.older
            if v is not None and (newest is None or v.timestamp > newest):
                newest = v.timestamp
            node = node.next
        return newest

    def nonempty_buckets(self):
        return [i for i in range(self.size) if self._buckets[i] is not None]
