"""Fused group commit: decide, claim-check, scatter and stamp for a batch
of conflict-disjoint transactions.

Replaces ``repro/kernels/commit_fused.py::commit_fused_flat`` (the Pallas
TPU kernel behind ``ops.commit_fused``).  Ragged per-transaction sets
ride in the flat segment layout of ``pack_segments``: a write batch
``(w_addr, w_val, w_seg)``, a write-lock batch ``(l_words, l_seg)`` and a
read batch ``(r_words, r_seen, r_seg)`` of packed lock words, plus the
members' ``tids`` and ``r_clocks``.  A member survives iff every read
entry validates at its own ``r_clock`` (``mode``: V_LT / V_LE / V_EQ) and
every write lock is claimable; survivors' writes land in the heap, failed
members leave no trace, and each lock entry gets its release word —
``(commit_ver << 18) | unlocked`` where its member survived, its own word
otherwise.

Two callers: the TL2 group publish (``engine/groupcommit.py``, in place
over the engine heap) and the MVStore publish (``core/mvstore.py``, one
member, out of place over the int32 block, so readers holding the old
row keep a whole snapshot).

On the card this is ``csrc/commit_fused.cu``: a decide launch (every
entry clears its member's ``ok`` with ``atomicAnd``; the same launch
copies the row for an out-of-place publish) and a publish launch, both on
the one stream.  The TPU kernel's int32 rebasing, its dummy transaction
slot and its one-past-the-end pad rows are gone: the CUDA kernel compares
int64 words as stored and masks ragged edges and failed members itself.
What bounds it on the card: bytes (24 per read entry, 24 per lock entry,
16 plus two values per write row, plus twice the row out of place); at
the group trial's shape the two launches dominate, and the MVStore
publish is bound by its row copy.

``np_commit_decide`` and ``pack_segments`` are this package's own copies
of the reference's host helpers; ``commit_fused_plain`` is the plain
PyTorch version the wrapper takes for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

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
                       mode: int = MODE_LE, out_of_place: bool = False):
    """Plain PyTorch version: ``(heap', ok bool[T], l_out int64[L])``.

    ``heap'`` is ``heap`` itself (in place) or a new tensor; survivors'
    ``(addr, val)`` rows are applied, failed members' are not.  With a
    fault schedule installed the scatter splits in half around the
    ``mid_scatter`` point, over the SURVIVING rows, as the reference's
    numpy version does.
    """
    ok = decide_plain(l_words, l_seg, r_words, r_seen, r_seg, tids,
                      r_clocks, n_txn, mode)
    rel = torch.full_like(l_words, release_word(commit_ver))
    l_out = torch.where(ok[l_seg], rel, l_words) if l_seg.numel() \
        else l_words.clone()
    out = heap.clone() if out_of_place else heap
    if w_seg.numel():
        sel = ok[w_seg]
        a, v = w_addr[sel], w_val[sel]
        if FP.ACTIVE is not None and a.numel() > 1:
            h = a.numel() // 2
            out[a[:h]] = v[:h]
            FP.fire("mid_scatter",
                    int(tids[0]) if tids.numel() else -1)
            out[a[h:]] = v[h:]
        else:
            out[a] = v
    return out, ok, l_out


def commit_fused(heap: torch.Tensor, w_addr, w_val, w_seg, l_words, l_seg,
                 r_words, r_seen, r_seg, tids, r_clocks, commit_ver: int,
                 n_txn: int, *, mode: int = MODE_LE,
                 out_of_place: bool = False):
    """Publish a group: ``(heap', ok bool[T], l_out int64[L])``, all on
    ``heap``'s device and not read back here (the caller copies ``ok``).

    ``heap`` is a contiguous 1-D int64 or int32 tensor, scattered in
    place, or — ``out_of_place`` — left as it is, with the result in a
    new tensor the kernel seeds from it.  Every other argument is a host
    array (numpy, list): the write batch ``w_addr``/``w_val``/``w_seg``
    [N], the write-lock batch ``l_words``/``l_seg`` [L] and the read
    batch ``r_words``/``r_seen``/``r_seg`` [M] in ``pack_segments``
    layout, with ``tids``/``r_clocks`` [T] (``n_txn`` = T).  Values are
    cast to the heap's dtype.  Every write address must lie in
    ``[0, len(heap))`` and every segment in ``[0, T)``; otherwise
    ``IndexError``/``ValueError`` is raised before anything launches.
    """
    if heap.dtype not in _ENTRY or heap.dim() != 1 \
            or not heap.is_contiguous():
        raise ValueError("commit_fused takes a contiguous 1-D int64/int32 "
                         f"heap, got {heap.dtype} {tuple(heap.shape)}")
    cols = [np.asarray(x, np.int64).reshape(-1)
            for x in (w_addr, w_seg, l_words, l_seg, r_words, r_seen,
                      r_seg, tids, r_clocks)]
    wa, ws, lw, ls, rw, rn, rs, td, rc = cols
    vals = np.asarray(w_val)
    if vals.dtype.kind not in "iu":
        vals = np.fromiter((int(v) for v in vals.reshape(-1)), np.int64,
                           vals.size)
    vals = vals.astype(np.int64, copy=False).reshape(-1)
    n, n_l, n_r = wa.size, lw.size, rw.size
    if ws.size != n or vals.size != n or ls.size != n_l or \
            rn.size != n_r or rs.size != n_r or td.size != n_txn or \
            rc.size != n_txn:
        raise ValueError("commit_fused: batch lengths disagree")
    for seg in (ws, ls, rs):
        if seg.size and (int(seg.min()) < 0 or int(seg.max()) >= n_txn):
            raise ValueError("commit_fused: segment id outside [0, T)")
    _lib.check_addr_bounds(wa, heap.numel())
    # every host column in ONE host->device copy
    dev = _lib.to_device(np.concatenate(cols + [vals]), heap.device)
    cut = np.cumsum([0] + [c.size for c in cols] + [n])
    wa_t, ws_t, lw_t, ls_t, rw_t, rn_t, rs_t, td_t, rc_t, v_t = (
        dev[cut[k]:cut[k + 1]] for k in range(len(cut) - 1))
    v_t = v_t.to(heap.dtype)
    if _lib.device_kind(heap) == "cpu":
        return commit_fused_plain(heap, wa_t, v_t, ws_t, lw_t, ls_t, rw_t,
                                  rn_t, rs_t, td_t, rc_t, commit_ver, n_txn,
                                  mode, out_of_place)
    out = torch.empty_like(heap) if out_of_place else heap
    ok = torch.empty(n_txn, dtype=torch.int32, device=heap.device)
    l_out = torch.empty(n_l, dtype=torch.int64, device=heap.device)
    entry = _ENTRY[heap.dtype]

    def run(phases, w_lo, w_hi, n_stamp):
        _lib.launch(entry, heap.device, heap.data_ptr(), out.data_ptr(),
                    heap.numel(), int(out_of_place), wa_t.data_ptr(),
                    v_t.data_ptr(), ws_t.data_ptr(), w_lo, w_hi,
                    lw_t.data_ptr(), ls_t.data_ptr(), n_l, n_stamp,
                    rw_t.data_ptr(), rn_t.data_ptr(), rs_t.data_ptr(), n_r,
                    td_t.data_ptr(), rc_t.data_ptr(), n_txn, int(mode),
                    release_word(commit_ver), ok.data_ptr(),
                    l_out.data_ptr(), phases)

    if FP.ACTIVE is not None and n > 1:
        # the fault split needs the survivors: decide, read the verdict
        # back, scatter the first half of the surviving rows, fire, then
        # the rest (the plain version's split, on the card)
        run(1, 0, 0, 0)
        surv = np.nonzero(ok.cpu().numpy()[ws] != 0)[0]
        if surv.size > 1:
            split = int(surv[surv.size // 2])
            run(2, 0, split, n_l)
            FP.fire("mid_scatter", int(td[0]) if td.size else -1)
            run(2, split, n, 0)
        else:
            run(2, 0, n, n_l)
    else:
        run(3, 0, n, n_l)
    launches.add()
    # the kernel leaves a survivor's flag all ones (the memset) and a
    # failed member's 0
    return out, ok != 0, l_out


__all__ = ["MODE_EQ", "MODE_LE", "MODE_LT", "commit_fused",
           "commit_fused_plain", "decide_plain", "launches",
           "np_commit_decide", "pack_segments", "release_word"]
