"""Batched gather ``out[i] = row[idx[i]]`` over an int64 or int32 row.

Replaces ``repro/kernels/gather_read.py::gather_read_flat`` (the Pallas
TPU kernel behind ``ops.snapshot_read``).  On the card it is the CUDA
kernel in ``csrc/gather_read.cu``; on a CPU tensor the wrapper takes the
plain PyTorch version below.  One kernel serves every row the word-level
engine keeps on the device: the heap behind ``Txn.read_bulk`` and the
packed lock words of the pre/post gathers and of commit revalidation,
as ``gather_read_i64``; and the MVStore's int32 block and ring rows
(``bulkread.gather_row``), as ``gather_read_i32`` — the block stays
int32 as in the reference, so a gather moves 4-byte words.

What bounds it on the card: bytes — 24 per element (index, row word,
output).  At the main path's 256-word chunks that is 6 KB, nanoseconds
of HBM time, so launch latency is what the chunked scan pays.  Design:
one thread per element reading the row in place (the TPU kernel carried
the whole heap as one VMEM block and padded ragged batches with address
0; here the kernel masks the ragged edge and the host pads nothing).
Addresses are int64 end to end, so there is no int32 range route.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("gather_read")

#: the C entry point for each row dtype
_ENTRY = {torch.int64: "gather_read_i64", torch.int32: "gather_read_i32"}


def gather_plain(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``row[idx]``."""
    return row[idx]


def gather_read_dev(row: torch.Tensor, idx: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather with ``idx`` already an int64 tensor on ``row``'s device
    and already bounds-checked (``gather_read`` does both), into ``out``
    (a contiguous [N] tensor of the row's dtype on the same device) when
    given."""
    n = idx.numel()
    if out is not None and (out.shape != (n,) or out.dtype != row.dtype
                            or not out.is_contiguous()
                            or out.device != row.device):
        raise ValueError("out must be a contiguous [N] tensor of the "
                         "row's dtype on the row's device")
    if _lib.device_kind(row) == "cpu":
        got = gather_plain(row, idx)
        return got if out is None else out.copy_(got)
    if out is None:
        out = torch.empty(n, dtype=row.dtype, device=row.device)
    if n:
        _lib.launch(_ENTRY[row.dtype], row.device, row.data_ptr(),
                    row.numel(), idx.data_ptr(), n, out.data_ptr())
        launches.add()
    return out


def gather_read(row: torch.Tensor, addrs,
                dev_idx: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``row[addrs]`` as a tensor of the row's dtype on its device.

    ``addrs`` are host addresses (numpy, list, range, CPU tensor); every
    one must lie in ``[0, len(row))`` or ``IndexError`` is raised before
    anything is launched.  ``dev_idx``, when given, is the same addresses
    already copied to the device (callers that gather several rows at one
    index set copy it once); ``out`` receives the result.
    """
    _lib.check_row(row, tuple(_ENTRY))
    a = _lib.host_index(addrs)
    _lib.check_addr_bounds(a, row.numel())
    if dev_idx is None:
        dev_idx = _lib.to_device(a, row.device)
    return gather_read_dev(row, dev_idx, out)


__all__ = ["gather_plain", "gather_read", "gather_read_dev", "launches"]
