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
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("validate")

V_LT, V_LE, V_EQ = 0, 1, 2


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


__all__ = ["V_EQ", "V_LE", "V_LT", "launches", "validate_mask",
           "validate_plain", "validate_readset"]
