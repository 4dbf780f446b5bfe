"""Newest committed version strictly below a snapshot, per mirror row.

Replaces ``repro/kernels/version_select.py::version_select_flat`` (the
Pallas TPU kernel behind ``ops.version_select``).  Each row of ``ts`` /
``data`` ([N, D], newest first) holds an address's newest committed
``(timestamp, data)`` pairs from the packed VLT mirror; per row the
result is the first ``data`` with ``ts < r_clock`` and whether one was
found.  Strict ``<`` mirrors the scalar traverse (the deferred clock
shares timestamps across commits).  A row without a match returns its
slot-0 data with ok = 0 — what the reference's ``argmax`` gave.

The TPU kernel took int32 timestamps rebased to ``r_clock`` (the empty
sentinel saturated) and routed beyond-int32 payloads to numpy; the CUDA
kernel (``csrc/version_select.cu``) compares the int64 timestamps and
clock as stored — the ``EMPTY_TS`` = 2^62 sentinel fails the test by
itself — and returns int64 values at any width.

What bounds it on the card: bytes — 16·D read and 12 written per row;
at depth 4 and the few hundred rows of a versioned chunk the launch
dominates.  One thread per row scanning its D slots newest first.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("version_select")


def version_select_plain(ts: torch.Tensor, data: torch.Tensor,
                         r_clock: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(values int64[N], ok int32[N])``.  The
    first valid slot is found explicitly (smallest valid position), not
    through ``argmax`` over a bool tensor."""
    depth = ts.shape[1]
    valid = ts < r_clock
    pos = torch.arange(depth, device=ts.device).expand_as(ts)
    first = torch.where(valid, pos, depth).min(dim=1).values
    found = first < depth
    first = torch.where(found, first, 0)
    vals = data.gather(1, first[:, None]).squeeze(1)
    return vals, found.to(torch.int32)


def version_select(ts: torch.Tensor, data: torch.Tensor,
                   r_clock: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values int64[N], ok int32[N])`` on the rows' device."""
    if ts.dim() != 2 or ts.shape != data.shape or \
            ts.dtype != torch.int64 or data.dtype != torch.int64 or \
            ts.device != data.device:
        raise ValueError("version_select expects int64 [N, D] ts and data "
                         "on one device")
    if _lib.device_kind(ts) == "cpu":
        return version_select_plain(ts, data, r_clock)
    n, depth = ts.shape
    if depth < 1:
        raise ValueError("version_select needs at least one slot per row")
    ts, data = ts.contiguous(), data.contiguous()
    vals = torch.empty(n, dtype=torch.int64, device=ts.device)
    ok = torch.empty(n, dtype=torch.int32, device=ts.device)
    if n:
        _lib.launch("version_select_i64", ts.device, ts.data_ptr(),
                    data.data_ptr(), n, depth, int(r_clock),
                    vals.data_ptr(), ok.data_ptr())
        launches.add()
    return vals, ok


__all__ = ["launches", "version_select", "version_select_plain"]
