"""Fused group commit: decide, claim-check, scatter and stamp for a batch
of conflict-disjoint transactions, with an optional version-ring refresh.

Replaces ``repro/kernels/commit_fused.py::commit_fused_flat`` (the Pallas
TPU kernel behind ``ops.commit_fused``) and the ring refresh that rides
the same call there (``ops.commit_fused``'s ``ring``/``ring_ts``/
``ring_slot``).  Ragged per-transaction sets ride in the flat segment
layout of ``pack_segments``: a write batch ``(w_addr, w_val, w_seg)``, a
write-lock batch ``(l_words, l_seg)`` and a read batch ``(r_words,
r_seen, r_seg)`` of packed lock words, plus the members' ``tids`` and
``r_clocks``.  A member survives iff every read entry validates at its
own ``r_clock`` (``mode``: V_LT / V_LE / V_EQ) and every write lock is
claimable; survivors' writes land in the heap, failed members leave no
trace, and each lock entry gets its release word — ``(commit_ver << 18)
| unlocked`` where its member survived, its own word otherwise.  With a
ring, the new heap is also written into ``ring[ring_slot]`` and
``commit_ver`` into ``ring_ts[ring_slot]``, in place.

Two callers: the TL2 group publish (``engine/groupcommit.py``, in place
over the engine heap, handing over the lock words it gathered on the
card) and the MVStore publish (``core/mvstore.py``, one member, out of
place over the int32 block, so readers holding the old row keep a whole
snapshot, with the ring refresh).

On the card this is ``csrc/commit_fused.cu``.  What bounds it there is
the host: the device work is a few microseconds (bytes: 16-24 per read
entry, 24 per lock entry, 16 plus two values per write row, plus the
heap read once and written once per output row — 12 MB, 3.6 us, for the
MVStore publish with its ring refresh), and a call's wall time is what
the host spends issuing it (``chip_smoke.py`` splits it by part).  So
each call is one C call, with its arguments in a header the wrapper
writes, and the wrapper does as little as it can around it.  A group
(``_commit_card``): the host columns are written straight into a pinned
staging block reused across calls (``_lib.StagingPool``; an event
guards the reuse) and reach the card in one ``cudaMemcpyAsync``, values
already in the heap's dtype and ``ok``'s initial bytes with them; the
bounds and segment checks are one pass each over the staged columns;
``ok`` (one byte a member, read as ``torch.bool``) and the release
words share the one device allocation that receives the columns; lock
words the card already holds are passed as device tensors and do not
cross the bus again.  Then a decide launch clears a failed member's
``ok`` byte and, in the same launch, seeds the new block and the ring
row from the old one, reading it once; a publish launch scatters into
both and stamps the ring's timestamp.  A publish with no read or lock
entries and at most 64 rows (the MVStore's, ``_commit_rows``) stages
nothing: every member survives, and its rows ride in the publish
launch's parameters.  The TPU kernel's int32 rebasing, its dummy
transaction slot and its one-past-the-end pad rows are gone: the CUDA
kernels compare int64 words as stored and mask ragged edges and failed
members themselves.

``np_commit_decide`` and ``pack_segments`` are this package's own copies
of the reference's host helpers; ``commit_fused_plain`` is the plain
PyTorch version the wrapper takes for CPU tensors.
"""
from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _lib
from repro_torch.reliability import faultpoints as FP

launches = _lib.LaunchCounter("commit_fused")

# validation predicate selectors — engine/validation.py's V_LT/V_LE/V_EQ
# (the kernels stay engine-import-free, so they are mirrored here and
# pinned equal by the tests)
MODE_LT = 0      # version <  r_clock   (deferred clock: DCTL)
MODE_LE = 1      # version <= r_clock   (commit-bumped clock: TL2)
MODE_EQ = 2      # version == seen      (TinySTM)

# ArrayLockTable's packed-word layout (core/engine/arrayheap.py), mirrored
# for the same reason and pinned equal by the tests
VER_SHIFT = 18
TID_BIAS = 2
TID_MASK = (1 << 16) - 1
UNLOCKED_WORD = ((-1 + TID_BIAS) & TID_MASK) << 2

_ENTRY = {torch.int64: "commit_fused_i64", torch.int32: "commit_fused_i32"}
_ROWS_ENTRY = {torch.int64: "commit_rows_i64", torch.int32: "commit_rows_i32"}
_SMALL_ROWS = 64    # kSmallRows in csrc/commit_fused.cu
_ROWS_HEAD = struct.Struct("<10q")      # RowsCall's scalar words
_tls = threading.local()
_NP = {torch.int64: np.int64, torch.int32: np.int32}
# the C entry point's phases and its CommitCall header (csrc/
# commit_fused.cu): 30 int64 words, staged_bytes the 9th, phases the 27th
_DECIDE, _PUBLISH, _STAMP_TS = 1, 2, 4
_CALL_WORDS, _STAGED_BYTES, _PHASES = 30, 8, 26


def pack_segments(per_txn) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged per-transaction vectors -> one flat batch + segment ids.

    ``per_txn`` is a list of 1-D arrays (one per transaction, any
    lengths including zero).  Returns ``(flat, seg, offsets)``: the
    concatenation, the owning transaction of each element, and the
    int64[T+1] segment offsets (``flat[offsets[t]:offsets[t+1]]`` is
    transaction ``t``'s slice).
    """
    arrs = [np.asarray(a) for a in per_txn]
    lens = np.fromiter((a.shape[0] for a in arrs), np.int64, len(arrs))
    offsets = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    flat = (np.concatenate(arrs) if arrs
            else np.zeros((0,), np.int64))
    seg = np.repeat(np.arange(len(arrs), dtype=np.int64), lens)
    return flat, seg, offsets


def np_commit_decide(l_ver, l_own, l_meta, l_seg,
                     r_ver, r_own, r_meta, r_seen, r_seg,
                     tids, r_clocks, n_txn: int, mode: int) -> np.ndarray:
    """Per-transaction verdict on the host: bool[n_txn], True iff every
    read entry validates (at the member's OWN ``r_clock``/mode) and
    every write lock is claimable (free and unflagged, or already held
    by the member).  Field layout matches ``ArrayLockTable.host_fields``:
    meta bit0 = locked, bit1 = flag."""
    tids = np.asarray(tids, np.int64)
    r_clocks = np.asarray(r_clocks, np.int64)
    ok = np.ones(n_txn, bool)
    r_seg = np.asarray(r_seg, np.int64)
    if r_seg.size:
        ver = np.asarray(r_ver, np.int64)
        meta = np.asarray(r_meta)
        locked = (meta & 1) != 0
        flagged = (meta & 2) != 0
        mine = locked & (np.asarray(r_own) == tids[r_seg])
        rc = r_clocks[r_seg]
        if mode == MODE_LT:
            valid = mine | (~locked & ~flagged & (ver < rc))
        elif mode == MODE_LE:
            valid = (~locked | mine) & (ver <= rc)
        else:
            valid = (~locked | mine) & (ver == np.asarray(r_seen, np.int64))
        ok &= np.bincount(r_seg[~valid], minlength=n_txn) == 0
    l_seg = np.asarray(l_seg, np.int64)
    if l_seg.size:
        meta = np.asarray(l_meta)
        locked = (meta & 1) != 0
        flagged = (meta & 2) != 0
        own = locked & (np.asarray(l_own) == tids[l_seg])
        claimable = ~((locked | flagged) & ~own)
        ok &= np.bincount(l_seg[~claimable], minlength=n_txn) == 0
    return ok


def release_word(commit_ver: int) -> int:
    """The unlocked lock word stamped at ``commit_ver``."""
    return (int(commit_ver) << VER_SHIFT) | UNLOCKED_WORD


def decide_plain(l_words: torch.Tensor, l_seg: torch.Tensor,
                 r_words: torch.Tensor, r_seen: torch.Tensor,
                 r_seg: torch.Tensor, tids: torch.Tensor,
                 r_clocks: torch.Tensor, n_txn: int,
                 mode: int) -> torch.Tensor:
    """Plain PyTorch verdict over packed words: bool[n_txn]."""
    def fields(w):
        return (w >> VER_SHIFT, ((w >> 2) & TID_MASK) - TID_BIAS,
                ((w >> 1) & 1) != 0, (w & 1) != 0)

    bad = torch.zeros(n_txn, dtype=torch.int64, device=tids.device)
    if r_seg.numel():
        ver, own, locked, flagged = fields(r_words)
        mine = locked & (own == tids[r_seg])
        rc = r_clocks[r_seg]
        if mode == MODE_LT:
            valid = mine | (~locked & ~flagged & (ver < rc))
        elif mode == MODE_LE:
            valid = (~locked | mine) & (ver <= rc)
        else:
            valid = (~locked | mine) & (ver == r_seen)
        bad.index_add_(0, r_seg, (~valid).to(torch.int64))
    if l_seg.numel():
        _, own, locked, flagged = fields(l_words)
        claimable = ~((locked | flagged) & ~(locked & (own == tids[l_seg])))
        bad.index_add_(0, l_seg, (~claimable).to(torch.int64))
    return bad == 0


def commit_fused_plain(heap: torch.Tensor, w_addr: torch.Tensor,
                       w_val: torch.Tensor, w_seg: torch.Tensor,
                       l_words: torch.Tensor, l_seg: torch.Tensor,
                       r_words: torch.Tensor, r_seen: torch.Tensor,
                       r_seg: torch.Tensor, tids: torch.Tensor,
                       r_clocks: torch.Tensor, commit_ver: int, n_txn: int,
                       mode: int = MODE_LE, out_of_place: bool = False,
                       ring: Optional[torch.Tensor] = None,
                       ring_ts: Optional[torch.Tensor] = None,
                       ring_slot: Optional[int] = None):
    """Plain PyTorch version: ``(heap', ok bool[T], l_out int64[L])``,
    plus ``(ring, ring_ts)`` refreshed in place when ``ring`` is given.

    ``heap'`` is ``heap`` itself (in place) or a new tensor; survivors'
    ``(addr, val)`` rows are applied, failed members' are not.  The ring
    row is seeded from the old heap and takes the same rows, as on the
    card.  With a fault schedule installed the scatter splits in half
    around the ``mid_scatter`` point, over the SURVIVING rows, as the
    reference's numpy version does.
    """
    ok = decide_plain(l_words, l_seg, r_words, r_seen, r_seg, tids,
                      r_clocks, n_txn, mode)
    rel = torch.full_like(l_words, release_word(commit_ver))
    l_out = torch.where(ok[l_seg], rel, l_words) if l_seg.numel() \
        else l_words.clone()
    out = heap.clone() if out_of_place else heap
    row = None
    if ring is not None:
        row = ring[ring_slot]
        row.copy_(heap)
    targets = (out,) if row is None else (out, row)
    if w_seg.numel():
        sel = ok[w_seg]
        a, v = w_addr[sel], w_val[sel]
        if FP.ACTIVE is not None and a.numel() > 1:
            h = a.numel() // 2
            for t in targets:
                t[a[:h]] = v[:h]
            FP.fire("mid_scatter",
                    int(tids[0]) if tids.numel() else -1)
            for t in targets:
                t[a[h:]] = v[h:]
        else:
            for t in targets:
                t[a] = v
    if ring is None:
        return out, ok, l_out
    ring_ts[ring_slot] = commit_ver
    return out, ok, l_out, ring, ring_ts


_I64 = np.dtype(np.int64)


def _host_col(x, name: str) -> np.ndarray:
    if type(x) is np.ndarray and x.dtype is _I64 and x.ndim == 1:
        return x
    if isinstance(x, torch.Tensor) and x.is_cuda:
        raise TypeError(f"commit_fused: {name} must be a host array")
    return np.asarray(x, np.int64).reshape(-1)


def _words_col(x, n: int, heap: torch.Tensor, name: str):
    """``l_words``/``r_words``: a host int64 array, or an int64 tensor
    already on the heap's device (then returned as it is)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        if x.get_device() != heap.get_device() or \
                x.dtype != torch.int64 or x.dim() != 1 or \
                not x.is_contiguous() or x.numel() != n:
            raise ValueError(f"commit_fused: {name} must be a contiguous "
                             f"int64 [{n}] tensor on {heap.device}")
        return x
    a = _host_col(x, name)
    if a.size != n:
        raise ValueError("commit_fused: batch lengths disagree")
    return a


def _values(w_val) -> np.ndarray:
    if type(w_val) is np.ndarray and w_val.dtype.kind in "iu" and \
            w_val.ndim == 1:
        return w_val
    vals = np.asarray(w_val)
    if vals.dtype.kind not in "iu":
        vals = np.fromiter((int(v) for v in vals.reshape(-1)), np.int64,
                           vals.size)
    return vals.reshape(-1)


def _check_ring(heap, ring, ring_ts, ring_slot, commit_ver) -> int:
    if ring_ts is None or ring_slot is None:
        raise ValueError("commit_fused: ring needs ring_ts and ring_slot")
    if ring_ts.dtype == torch.int32 and \
            not -(1 << 31) <= int(commit_ver) < 1 << 31:
        raise ValueError("commit_fused: commit_ver does not fit the int32 "
                         "ring_ts")
    shape, d = ring.shape, heap.get_device()
    if ring.dtype != heap.dtype or len(shape) != 2 or \
            shape[1] != heap.numel() or not ring.is_contiguous() or \
            ring.get_device() != d or ring_ts.dim() != 1 or \
            ring_ts.shape[0] != shape[0] or \
            ring_ts.dtype not in (torch.int32, torch.int64) or \
            ring_ts.get_device() != d:
        raise ValueError("commit_fused: ring must be a contiguous [R, H] "
                         "tensor of the heap's dtype and ring_ts an int32 "
                         "or int64 [R] tensor, on the heap's device")
    slot = int(ring_slot)
    if not 0 <= slot < shape[0]:
        raise IndexError(slot)
    return slot


def _work(heap, w_addr, w_val, w_seg, l_words, l_seg, r_words, r_seen, r_seg,
          tids, r_clocks, commit_ver, n_txn, *, out_of_place=False,
          ring=None, **_):
    """``(flops, bytes)`` of one publish (``_lib.counted``): no products;
    the bound's bytes, 32 a write (address, value, segment, the heap
    word), 24 a write lock and 16 a read entry (their words and
    segments), 17 a member (tid, clock, verdict); an out-of-place heap
    read and written whole, and a ring row and its timestamp written."""
    nbytes = (32 * len(w_addr) + 24 * len(l_words) + 16 * len(r_words)
              + 17 * n_txn)
    if out_of_place:
        nbytes += 2 * heap.nbytes
    if ring is not None:
        nbytes += heap.nbytes + 4
    return 0, nbytes


@_lib.counted("commit_fused", _work)
def commit_fused(heap: torch.Tensor, w_addr, w_val, w_seg, l_words, l_seg,
                 r_words, r_seen, r_seg, tids, r_clocks, commit_ver: int,
                 n_txn: int, *, mode: int = MODE_LE,
                 out_of_place: bool = False,
                 ring: Optional[torch.Tensor] = None,
                 ring_ts: Optional[torch.Tensor] = None,
                 ring_slot: Optional[int] = None):
    """Publish a group: ``(heap', ok bool[T], l_out int64[L])``, all on
    ``heap``'s device and not read back here (the caller copies ``ok``);
    with ``ring``, ``(heap', ok, l_out, ring, ring_ts)``.

    ``heap`` is a contiguous 1-D int64 or int32 tensor, scattered in
    place, or — ``out_of_place`` — left as it is, with the result in a
    new tensor the kernel seeds from it.  ``l_words``/``r_words`` are
    host arrays or int64 tensors on the heap's device; every other
    argument is a host array (numpy, list): the write batch
    ``w_addr``/``w_val``/``w_seg`` [N], the write-lock batch
    ``l_words``/``l_seg`` [L] and the read batch
    ``r_words``/``r_seen``/``r_seg`` [M] in ``pack_segments`` layout,
    with ``tids``/``r_clocks`` [T] (``n_txn`` = T).  Values are cast to
    the heap's dtype.  ``ring`` [R, H] (the heap's dtype and device),
    ``ring_ts`` [R] (int32 or int64) and ``ring_slot``: the new heap is
    also written into ``ring[ring_slot]`` and ``commit_ver`` into
    ``ring_ts[ring_slot]``, in place.  Every write address must lie in
    ``[0, len(heap))`` and every segment in ``[0, T)``; otherwise
    ``IndexError``/``ValueError`` is raised before anything launches.
    """
    if heap.dtype not in _ENTRY or heap.dim() != 1 \
            or not heap.is_contiguous():
        raise ValueError("commit_fused takes a contiguous 1-D int64/int32 "
                         f"heap, got {heap.dtype} {tuple(heap.shape)}")
    slot = None if ring is None else _check_ring(heap, ring, ring_ts,
                                                 ring_slot, commit_ver)
    wa, ws = _host_col(w_addr, "w_addr"), _host_col(w_seg, "w_seg")
    ls, rs = _host_col(l_seg, "l_seg"), _host_col(r_seg, "r_seg")
    rn = _host_col(r_seen, "r_seen")
    td, rc = _host_col(tids, "tids"), _host_col(r_clocks, "r_clocks")
    vals = _values(w_val)
    n, n_l, n_r = wa.size, ls.size, rs.size
    if ws.size != n or vals.size != n or rn.size != n_r or \
            td.size != n_txn or rc.size != n_txn:
        raise ValueError("commit_fused: batch lengths disagree")
    lw = _words_col(l_words, n_l, heap, "l_words")
    rw = _words_col(r_words, n_r, heap, "r_words")
    if _lib.device_kind(heap) == "cpu":
        for seg in (ws, ls, rs):
            if seg.size and int(seg.view(np.uint64).max()) >= n_txn:
                raise ValueError("commit_fused: segment id outside [0, T)")
        if n and int(wa.view(np.uint64).max()) >= heap.numel():
            _lib.check_addr_bounds(wa, heap.numel())
        if isinstance(lw, torch.Tensor) or isinstance(rw, torch.Tensor):
            raise ValueError("commit_fused: lock words on another device "
                             "than the heap")
        def t(a):
            return torch.from_numpy(a if a.flags.writeable else a.copy())
        return commit_fused_plain(
            heap, t(wa), t(vals.astype(np.int64)).to(heap.dtype), t(ws),
            t(lw), t(ls), t(rw), t(rn), t(rs), t(td), t(rc), commit_ver,
            n_txn, mode, out_of_place, ring, ring_ts, slot)
    if not n_l and not n_r and n <= _SMALL_ROWS and FP.ACTIVE is None:
        return _commit_rows(heap, wa, vals, ws, n_txn, commit_ver,
                            out_of_place, ring, ring_ts, slot)
    return _commit_card(heap, wa, vals, ws, lw, ls, rw, rn, rs, td, rc,
                        commit_ver, n_txn, mode, out_of_place, ring,
                        ring_ts, slot)


class _Layout:
    """Where a card call's columns sit, in int64 words from the start of
    the staged region (the device block's start; on the host, the
    staging block's column region): ``ok``'s bytes, the write
    addresses, the three segment columns side by side (one pass checks
    them all), the seen versions (mode EQ only), tids, clocks, the lock
    words the caller passed as host arrays, and the values in the
    heap's dtype.  The device block holds the release words [L] after
    the staged region."""

    def __init__(self, n, n_l, n_r, n_txn, mode, lw_host, rw_host, isz):
        self.n, self.n_l, self.n_txn, self.isz = n, n_l, n_txn, isz
        self.wa = -(-n_txn // 8)
        self.ws = self.wa + n
        self.ls = self.ws + n
        self.rs = self.ls + n_l
        self.rn = self.rs + n_r
        self.td = self.rn + (n_r if mode == MODE_EQ else 0)
        self.rc = self.td + n_txn
        self.lw = self.rc + n_txn
        self.rw = self.lw + (n_l if lw_host else 0)
        self.v = self.rw + (n_r if rw_host else 0)
        self.staged = self.v + -(-n * isz // 8)      # words copied
        #: the column offsets in ``CommitCall``'s order
        self.offsets = (self.wa, self.ws, self.ls, self.rs, self.rn,
                        self.td, self.rc, self.v)


def _stage(u8, i64, lay: _Layout, wa, ws, ls, rs, rn, td, rc, lw, rw, vals,
           heap: torch.Tensor) -> None:
    """Write a call's host columns into the staging views at ``lay``'s
    offsets, then check them: segments in ``[0, T)`` and write addresses
    in ``[0, len(heap))``, one pass each over the staged copy (as uint64,
    a negative value is out of range too).  Empty columns are skipped."""
    u8[:lay.n_txn] = 1
    if lay.n:
        i64[lay.wa:lay.ws] = wa
        i64[lay.ws:lay.ls] = ws
        np.copyto(u8[8 * lay.v:8 * lay.v + lay.n * lay.isz].view(
            _NP[heap.dtype]), vals, casting="unsafe")
    if lay.rs > lay.ls:
        i64[lay.ls:lay.rs] = ls
    if lay.rn > lay.rs:
        i64[lay.rs:lay.rn] = rs
    if lay.td > lay.rn:
        i64[lay.rn:lay.td] = rn
    i64[lay.td:lay.rc] = td
    i64[lay.rc:lay.lw] = rc
    if lay.rw > lay.lw:
        i64[lay.lw:lay.rw] = lw
    if lay.v > lay.rw:
        i64[lay.rw:lay.v] = rw
    if lay.rn > lay.ws and \
            int(i64[lay.ws:lay.rn].view(np.uint64).max()) >= lay.n_txn:
        raise ValueError("commit_fused: segment id outside [0, T)")
    if lay.n and int(i64[lay.wa:lay.ws].view(np.uint64).max()) \
            >= heap.numel():
        _lib.check_addr_bounds(wa, heap.numel())


_EMPTY: dict = {}   # device index -> an empty int64 tensor (no lock batch)


def _empty_words(dev: torch.device) -> torch.Tensor:
    t = _EMPTY.get(dev.index)
    if t is None:
        t = _EMPTY[dev.index] = torch.empty(0, dtype=torch.int64, device=dev)
    return t


def _commit_rows(heap, wa, vals, ws, n_txn, commit_ver, out_of_place, ring,
                 ring_ts, slot):
    """The card's route for a publish with no read or lock entries and at
    most ``_SMALL_ROWS`` rows (the MVStore's): every member survives, and
    the rows ride in the publish launch's parameters (``RowsCall``), so
    nothing is staged or copied; ``ok`` comes out all ones."""
    n, h = wa.size, heap.numel()
    if n and int(ws.view(np.uint64).max()) >= n_txn:
        raise ValueError("commit_fused: segment id outside [0, T)")
    if n and int(wa.view(np.uint64).max()) >= h:
        _lib.check_addr_bounds(wa, h)
    dev = heap.device
    ok = torch.empty(n_txn, dtype=torch.bool, device=dev)
    out = heap.new_empty(heap.shape) if out_of_place else heap
    ring_row = ring_ts_ptr = ts_bytes = 0
    if ring is not None:
        ring_row = ring.data_ptr() + slot * h * heap.element_size()
        ring_ts_ptr = ring_ts.data_ptr() + slot * ring_ts.element_size()
        ts_bytes = ring_ts.element_size()
    # the call is read by the C entry before it returns: one buffer per
    # thread serves every call
    buf = getattr(_tls, "rows", None)
    if buf is None:
        raw = ctypes.create_string_buffer(8 * (10 + 2 * _SMALL_ROWS))
        buf = _tls.rows = (raw, ctypes.addressof(raw),
                           np.frombuffer(raw, np.int64))
    raw, addr, words = buf
    _ROWS_HEAD.pack_into(raw, 0, heap.data_ptr(), out.data_ptr(), h,
                         ring_row, ring_ts_ptr, ts_bytes, ok.data_ptr(),
                         n_txn, n, int(commit_ver))
    words[10:10 + n] = wa
    np.copyto(words[10 + _SMALL_ROWS:10 + _SMALL_ROWS + n], vals,
              casting="unsafe")
    _lib.launch(_ROWS_ENTRY[heap.dtype], dev, addr)
    launches.add()
    if ring is None:
        return out, ok, _empty_words(dev)
    return out, ok, _empty_words(dev), ring, ring_ts


def _commit_card(heap, wa, vals, ws, lw, ls, rw, rn, rs, td, rc,
                 commit_ver, n_txn, mode, out_of_place, ring, ring_ts, slot):
    """The card's route of ``commit_fused``: stage the columns and the
    call's arguments in a pinned block, check, and make one C call
    (copy, decide, publish) on the one stream."""
    n, n_l, n_r = wa.size, ls.size, rs.size
    dev = heap.device
    lw_host = not isinstance(lw, torch.Tensor)
    rw_host = not isinstance(rw, torch.Tensor)
    isz = heap.element_size()
    lay = _Layout(n, n_l, n_r, n_txn, mode, lw_host, rw_host, isz)
    # ok's bytes, the staged columns, then the release words
    blk = torch.empty(8 * (lay.staged + n_l), dtype=torch.bool, device=dev)
    base = blk.data_ptr()
    out = heap.new_empty(heap.shape) if out_of_place else heap
    ring_row = ring_ts_ptr = ts_bytes = stamp_ts = 0
    if ring is not None:
        ring_row = ring.data_ptr() + slot * heap.numel() * isz
        ring_ts_ptr = ring_ts.data_ptr() + slot * ring_ts.element_size()
        ts_bytes = ring_ts.element_size()
        stamp_ts = _STAMP_TS
    split = FP.ACTIVE is not None and n > 1
    phases = _DECIDE if split else _DECIDE | _PUBLISH | stamp_ts
    pool = _lib.staging(dev)
    st = pool.acquire()
    try:
        head, u8, i64 = st.take(8 * lay.staged)
        _stage(u8, i64, lay, wa, ws, ls, rs, rn, td, rc, lw, rw, vals, heap)
        head[:_CALL_WORDS] = (
            heap.data_ptr(), out.data_ptr(), heap.numel(), ring_row,
            ring_ts_ptr, ts_bytes, st.ptr + _lib.STAGING_HEAD, base,
            8 * lay.staged, st.event,
            base + 8 * lay.lw if lw_host else lw.data_ptr(),
            base + 8 * lay.rw if rw_host else rw.data_ptr(),
            base + 8 * lay.staged, n, n_l, n_r, int(mode), int(commit_ver),
            *lay.offsets, phases, 0, n, n_l)
        _lib.launch(_ENTRY[heap.dtype], dev, st.ptr)
        call = head[:_CALL_WORDS].copy() if split else None
    finally:
        pool.release(st)
    ok = blk[:n_txn]
    if split:
        # the fault split needs the survivors: decide, read the verdict
        # back, scatter the first half of the surviving rows, fire, then
        # the rest (the plain version's split, on the card); these calls
        # copy nothing and take their arguments from a private copy
        surv = np.nonzero(ok.cpu().numpy()[ws])[0]
        call[_STAGED_BYTES] = 0

        def publish(flags, w_lo, w_hi, n_stamp):
            call[_PHASES:] = (flags, w_lo, w_hi, n_stamp)
            _lib.launch(_ENTRY[heap.dtype], dev, call.ctypes.data)
        if surv.size > 1:
            cut = int(surv[surv.size // 2])
            publish(_PUBLISH, 0, cut, n_l)
            FP.fire("mid_scatter", int(td[0]) if td.size else -1)
            publish(_PUBLISH | stamp_ts, cut, n, 0)
        else:
            publish(_PUBLISH | stamp_ts, 0, n, n_l)
    launches.add()
    l_out = blk[8 * lay.staged:].view(torch.int64) if n_l \
        else _empty_words(dev)
    if ring is None:
        return out, ok, l_out
    return out, ok, l_out, ring, ring_ts


__all__ = ["MODE_EQ", "MODE_LE", "MODE_LT", "commit_fused",
           "commit_fused_plain", "decide_plain", "launches",
           "np_commit_decide", "pack_segments", "release_word"]
