"""Bulk read-set validation over gathered lock fields.

Replaces ``repro/kernels/validate.py::validate_readset_flat`` (the Pallas
TPU kernel behind ``ops.validate_readset``).  Three predicates cover the
lock-version family (``mode``)::

    0 (V_LT)  own lock passes; else free, unflagged and ver <  r_clock
    1 (V_LE)  unlocked or own, and ver <= r_clock
    2 (V_EQ)  unlocked or own, and ver == seen

``meta`` bit0 = locked, bit1 = flag; ``own`` is the holder tid.  The TPU
kernel took int32 versions rebased to ``r_clock`` and padded ragged read
sets with always-valid entries; the CUDA kernel (``csrc/validate.cu``)
compares the int64 versions and clock as stored and masks the ragged
edge itself, and it folds the AND-reduction in with ``atomicAnd`` on one
flag, so a commit reads back 4 bytes instead of the whole mask.

What bounds it on the card: bytes — 28 per entry; at the rwmix read sets
(1024 entries) the launch dominates.  One thread per entry.

``validate_words`` is a commit's whole bulk revalidation, from the lock
table's packed row and the read set's (lock index, seen version) pairs,
as ONE launch of the second kernel of ``csrc/validate.cu``
(``validate_words_i64``): each thread gathers its entry's word, splits
it into version, owner and meta (the engine's packed layout, as
``commit_fused`` mirrors it) and evaluates the predicate; the verdict
is written into a 0-d bool (``_lib.fresh_ok``), the [N] mask only when
asked for.  Up to
``PARAM_ENTRIES`` entries the pairs ride in the launch's parameters; a
larger read set goes through ``_lib.StagingPool`` in one pinned copy.
It replaces, on the card, a ``gather_read`` launch with its index copy,
the field split's elementwise ops and casts, the seen copy, two
allocations, a memset, this module's first kernel and the flag op.  Its
launches count under ``launches``.  ``validate_words_plain`` is its plain
version: ``validate_plain`` over the plain split of ``words[idx]``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _lib
# the packed lock word (core/engine/arrayheap.py), as the kernels mirror it
from repro_torch.kernels.commit_fused import TID_BIAS, TID_MASK, VER_SHIFT

launches = _lib.LaunchCounter("validate")

V_LT, V_LE, V_EQ = 0, 1, 2
#: up to this many entries ``validate_words`` passes the read set in the
#: launch's parameters (kParamEntries in csrc/validate.cu)
PARAM_ENTRIES = 1024


def validate_plain(ver: torch.Tensor, own: torch.Tensor, meta: torch.Tensor,
                   seen: torch.Tensor, r_clock: int, tid: int,
                   mode: int) -> torch.Tensor:
    """Plain PyTorch version: the [N] int32 validity mask."""
    locked = (meta & 1) != 0
    flagged = (meta & 2) != 0
    mine = locked & (own.to(torch.int64) == tid)
    if mode == V_LT:
        ok = mine | (~locked & ~flagged & (ver < r_clock))
    elif mode == V_LE:
        ok = (~locked | mine) & (ver <= r_clock)
    else:
        ok = (~locked | mine) & (ver == seen)
    return ok.to(torch.int32)


def _as_seen(seen, device: torch.device) -> torch.Tensor:
    if isinstance(seen, torch.Tensor):
        return seen.to(device=device, dtype=torch.int64).contiguous()
    return _lib.to_device(np.asarray(seen, np.int64), device)


def _mask_work(ver, *_, **__):
    """``(flops, bytes)`` of one read-set check (``_lib.counted``): no
    products; the version, owner, meta and seen fields read, the mask
    written (28 B an entry) and the flag."""
    return 0, 28 * ver.numel() + 4


def _words_work(words, entries, *_, **__):
    """``(flops, bytes)`` of one bulk revalidation: each (lock index,
    seen) pair and its lock word read (24 B an entry), the verdict
    written."""
    return 0, 24 * len(entries) + 1


@_lib.counted("validate", _mask_work)
def validate_mask(ver: torch.Tensor, own: torch.Tensor, meta: torch.Tensor,
                  seen, r_clock: int, tid: int,
                  mode: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mask int32[N], all_ok)`` on ``ver``'s device; ``all_ok`` is a
    0-d bool tensor (not read back here, so nothing synchronises)."""
    seen_t = _as_seen(seen, ver.device)
    if _lib.device_kind(ver) == "cpu":
        mask = validate_plain(ver, own, meta, seen_t, r_clock, tid, mode)
        return mask, mask.all()
    for t, dt in ((ver, torch.int64), (own, torch.int32),
                  (meta, torch.int32), (seen_t, torch.int64)):
        if t.dtype != dt or t.device != ver.device or \
                not t.is_contiguous() or t.shape != ver.shape:
            raise ValueError("validate expects contiguous [N] int64 ver/"
                             "seen and int32 own/meta on one device")
    n = ver.numel()
    mask = torch.empty(n, dtype=torch.int32, device=ver.device)
    flag = torch.empty(1, dtype=torch.int32, device=ver.device)
    if not n:
        return mask, torch.ones((), dtype=torch.bool, device=ver.device)
    _lib.launch("validate_readset_i64", ver.device, ver.data_ptr(),
                own.data_ptr(), meta.data_ptr(), seen_t.data_ptr(), n,
                int(r_clock), int(tid), int(mode), mask.data_ptr(),
                flag.data_ptr())
    launches.add()
    return mask, flag[0] != 0


def validate_readset(ver: torch.Tensor, own: torch.Tensor,
                     meta: torch.Tensor, seen, r_clock: int, tid: int,
                     mode: int) -> bool:
    """True iff every read-set entry is still valid (reads back one
    flag from the device)."""
    return bool(validate_mask(ver, own, meta, seen, r_clock, tid,
                              mode)[1])


def split_words_plain(w: torch.Tensor):
    """Packed lock words -> ``(version int64, owner int32, meta int32)``,
    meta bit0 = locked, bit1 = flag (``ArrayLockTable.gather``'s
    fields)."""
    own = ((w >> 2) & TID_MASK) - TID_BIAS
    meta = ((w >> 1) & 1) | ((w & 1) << 1)
    return w >> VER_SHIFT, own.to(torch.int32), meta.to(torch.int32)


def validate_words_plain(words: torch.Tensor, entries: torch.Tensor,
                         r_clock: int, tid: int, mode: int) -> torch.Tensor:
    """Plain PyTorch version of ``validate_words``: the [N] int32 mask of
    ``validate_plain`` over the split of ``words[entries[:, 0]]`` against
    the seen versions ``entries[:, 1]``."""
    ver, own, meta = split_words_plain(words[entries[:, 0]])
    return validate_plain(ver, own, meta, entries[:, 1], r_clock, tid, mode)


@_lib.counted("validate", _words_work)
def validate_words(words: torch.Tensor, entries, r_clock: int, tid: int,
                   mode: int, *, want_mask: bool = False):
    """``(ok, mask)``: whether every read-set entry is still valid, as a
    0-d bool tensor on ``words``' device (not read back here), and the
    [N] int32 mask when ``want_mask`` (else None).

    ``words`` is the lock table's packed row (contiguous 1-D int64);
    ``entries`` the read set as a host ``[N, 2]`` int64 array of (lock
    index, seen version) pairs, each index inside the row, or
    ``IndexError`` is raised before anything is launched.  A CUDA row
    launches ``validate_words_i64`` once; a CPU row takes
    ``validate_words_plain``."""
    _lib.check_row(words)
    e = np.ascontiguousarray(entries, np.int64).reshape(-1, 2)
    n = e.shape[0]
    _lib.check_addr_bounds(e[:, 0], words.numel())
    if not words.is_cuda:
        _lib.device_kind(words)
        mask = validate_words_plain(words, torch.from_numpy(e), r_clock,
                                    tid, mode)
        return mask.all(), (mask if want_mask else None)
    dev = words.device
    mask = torch.empty(n, dtype=torch.int32, device=dev) if want_mask \
        else None
    if not n:
        return torch.ones((), dtype=torch.bool, device=dev), mask
    ok = _lib.fresh_ok(dev)
    args = (n, int(r_clock), int(tid), int(mode),
            mask.data_ptr() if mask is not None else None, ok.data_ptr())
    if n <= PARAM_ENTRIES:
        _lib.launch("validate_words_i64", dev, words.data_ptr(),
                    words.numel(), e.ctypes.data, None, None, None, *args)
    else:
        pool = _lib.staging(dev)
        st = pool.acquire()
        try:
            _, _, i64 = st.take(16 * n)
            i64[:2 * n] = e.reshape(-1)
            on_card = torch.empty((n, 2), dtype=torch.int64, device=dev)
            _lib.launch("validate_words_i64", dev, words.data_ptr(),
                        words.numel(), None, st.ptr + _lib.STAGING_HEAD,
                        on_card.data_ptr(), st.event, *args)
        finally:
            pool.release(st)
    launches.add()
    return ok, mask


__all__ = ["PARAM_ENTRIES", "V_EQ", "V_LE", "V_LT", "launches",
           "split_words_plain", "validate_mask", "validate_plain",
           "validate_readset", "validate_words", "validate_words_plain"]
