"""Versioned block read: the newest ring slot at or below a clock.

Replaces ``repro/kernels/snapshot_select.py::snapshot_select_flat`` (the
Pallas TPU kernel behind ``ops.snapshot_select``), which the MVStore's
``mv_snapshot`` reaches for every versioned block.  A versioned block keeps a ring
``[R, *shape]`` of its last R committed values and their int32
timestamps ``ts[R]`` (``NO_TS`` = empty slot).  The read picks the slot
with the largest ``ts`` among ``NO_TS < ts <= read_clock`` — the FIRST
such maximum, as ``argmax`` picks — and returns a copy of that row with
``ok`` = whether any slot qualified; with none, it is row 0 and
``ok`` False.

On the card it is ``csrc/snapshot_select.cu``: every block scans ``ts``
itself (the TPU kernel's scalar-prefetch index map becomes plain
arguments) and the grid copies only the chosen row, masking its ragged
tail; block 0 writes ``ok`` straight into the 0-d bool tensor returned.
What bounds it on the card: bytes — one row read and one row written,
8 MB for a 1,000,000-word int32 block, 2.4 us; the host path (checks,
the output's allocation, the launch) costs more than that.
``snapshot_select_plain`` is the plain PyTorch version the wrapper takes
for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("snapshot_select")

NO_TS = -1


def select_slot_plain(ts: torch.Tensor, read_clock: int):
    """``(slot, ok)``: the first slot of greatest ``ts`` among
    ``NO_TS < ts <= read_clock`` (slot 0 if none), as 0-d tensors."""
    valid = (ts != NO_TS) & (ts <= read_clock)
    masked = torch.where(valid, ts, torch.full_like(ts, NO_TS))
    return torch.argmax(masked), valid.any()


def snapshot_select_plain(ring: torch.Tensor, ts: torch.Tensor,
                          read_clock: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Plain PyTorch version: ``(ring[slot] copied, ok)``, the row taken
    by ``index_select`` (no read of ``slot`` back to the host)."""
    slot, ok = select_slot_plain(ts, read_clock)
    return torch.index_select(ring, 0, slot.reshape(1)).reshape(
        ring.shape[1:]), ok


def work(ring: torch.Tensor, ts: torch.Tensor, read_clock: int):
    """``(flops, bytes)`` of one call (``_lib.counted``): no products, and
    the bytes of the kernel's bound: the chosen row read and written,
    the timestamps and the clock read."""
    return 0, 2 * (ring.nbytes // ring.shape[0]) + ts.nbytes + 4


@_lib.counted("snapshot_select", work)
def snapshot_select(ring: torch.Tensor, ts: torch.Tensor,
                    read_clock: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(value [*shape], ok 0-d bool)`` for ``ring`` [R, *shape]
    (contiguous, any dtype) and ``ts`` int32 [R] on the same device.
    Nothing is read back to the host.  A fake CUDA ring (the dry run's)
    gets the outputs made and nothing computed.  (``mv_snapshot`` calls
    this for every versioned block: the card's path reads as few tensor
    properties as it can.)"""
    if not ring.is_cuda:
        _check(ring, ts)
        _lib.device_kind(ring)
        return snapshot_select_plain(ring, ts, read_clock)
    shape = ring.shape
    if not shape or shape[0] < 1 or ts.ndim != 1 or \
            ts.dtype is not torch.int32 or ts.shape[0] != shape[0] or \
            ts.get_device() != ring.get_device():
        _check(ring, ts)
    if not ring.is_contiguous() or not ts.is_contiguous():
        raise ValueError("snapshot_select takes contiguous ring and ts")
    out = ring.new_empty(shape[1:])
    dev = ring.device
    if _lib.is_fake(ring):
        return out, torch.empty((), dtype=torch.bool, device=dev)
    ok = _lib.fresh_ok(dev)
    _lib.launch("snapshot_select_rows", dev, ring.data_ptr(), shape[0],
                out.nbytes, ts.data_ptr(), int(read_clock), out.data_ptr(),
                ok.data_ptr())
    launches.add()
    return out, ok


def _check(ring: torch.Tensor, ts: torch.Tensor) -> None:
    if ring.dim() < 1 or ring.shape[0] < 1 or ts.dtype != torch.int32 or \
            ts.shape != ring.shape[:1] or ts.device != ring.device:
        raise ValueError("snapshot_select takes ring [R, ...] and int32 "
                         "ts [R] on one device")


__all__ = ["NO_TS", "launches", "select_slot_plain", "snapshot_select",
           "snapshot_select_plain", "work"]
