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

``gather_bracketed`` is a bulk transactional read's three gathers — the
lock words, the heap words, the lock words again (``core/engine/
bulkread.py``) — as ONE launch of the second kernel in the same source,
``gather_bracketed_i64``: each thread reads its pre word, its heap word
and its post word, into one [4, N] int64 output (rows: pre, post, heap,
and the lock indices; a versioned read asks for two more rows, which
``version_select.mirror_select`` fills).  One
launch is as sound as three under the one-stream rule: every device
write of the STM's state is a launch or copy on the default stream, so
no write lands while the kernel runs (``csrc/gather_read.cu`` has the
argument).  On the main path's 256-word chunks the two index sets ride
in the launch's parameters, so a chunk's three launches, three
allocations and host->device index copy become one launch and one
allocation.  ``gather_lockver_plain`` is its plain version: the three
gathers in order.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("gather_read")
#: the bracketed launches alone (each also counts under ``launches``)
bracketed_launches = _lib.LaunchCounter("gather_bracketed")

#: the C entry point for each row dtype
_ENTRY = {torch.int64: "gather_read_i64", torch.int32: "gather_read_i32"}


def gather_plain(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``row[idx]``."""
    return row[idx]


def _gather_work(row: torch.Tensor, idx, *_, **__):
    """``(flops, bytes)`` of one gather (``_lib.counted``): no products;
    each index read, each word read and written (24 B an int64 word)."""
    return 0, len(idx) * (8 + 2 * row.element_size())


def _bracketed_work(words, heap, idxs, addrs, *_, **__):
    """``(flops, bytes)`` of one bracketed gather: no products; the two
    lock-word reads, the heap read and the four output rows (56 B an
    element)."""
    return 0, 56 * len(addrs)


@_lib.counted("gather_read", _gather_work)
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


@_lib.counted("gather_read", _gather_work)
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


#: up to this many elements a bracketed gather's indices ride in the
#: launch's parameters (kParamIdx in csrc/gather_read.cu)
PARAM_IDX = 256


def gather_lockver_plain(words: torch.Tensor, heap: torch.Tensor,
                         idx: torch.Tensor,
                         addrs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gather_bracketed``: the pre-gather, the
    heap gather and the post-gather, in that order, as one [4, N] tensor
    (rows: pre, post, heap, the lock indices)."""
    pre = words[idx]
    vals = heap[addrs]
    post = words[idx]
    return torch.stack((pre, post, vals, idx))


@_lib.counted("gather_bracketed", _bracketed_work)
def gather_bracketed(words: torch.Tensor, heap: torch.Tensor, idxs,
                     addrs, rows: int = 4, with_index: bool = False):
    """``out`` [rows, N] int64 on the rows' device: ``words[idxs]``
    before, ``words[idxs]`` after (rows 0 and 1) and ``heap[addrs]``
    (row 2) of one bracketed read, and the lock indices (row 3); rows
    past 4 are left for the caller (a versioned read's ``mirror_select``
    writes rows 4 and 5).

    ``words`` (packed lock words) and ``heap`` are contiguous 1-D int64
    rows on one device; ``idxs``/``addrs`` are host arrays of one length,
    each index inside its row, or ``IndexError`` is raised before
    anything is launched.  Up to ``PARAM_IDX`` elements the indices ride
    in the launch's parameters; a longer batch copies both index sets to
    the device at once.  ``with_index``: return ``(out, staged)``, where
    ``staged`` is that device copy ([2N] int64: the lock indices, then
    the addresses) or None when the indices rode in the parameters.
    """
    _lib.check_row(words)
    _lib.check_row(heap)
    if words.get_device() != heap.get_device():
        raise ValueError("gather_bracketed: words and heap on two devices")
    if rows < 4:
        raise ValueError("gather_bracketed: the output has >= 4 rows")
    i, a = _lib.host_index(idxs), _lib.host_index(addrs)
    n = a.size
    if i.size != n:
        raise ValueError("gather_bracketed: idxs and addrs differ in "
                         "length")
    n_w, n_h = words.numel(), heap.numel()
    _lib.check_addr_bounds(i, n_w)
    _lib.check_addr_bounds(a, n_h)
    out = torch.empty((rows, n), dtype=torch.int64, device=heap.device)
    both = None
    if not heap.is_cuda:
        _lib.device_kind(heap)
        out[:4] = gather_lockver_plain(words, heap,
                                       torch.from_numpy(i.copy()),
                                       torch.from_numpy(a.copy()))
    elif n:
        dev = heap.device
        if n <= PARAM_IDX and n_w <= 1 << 31 and n_h <= 1 << 31:
            pidx = np.empty(2 * PARAM_IDX, np.int32)
            pidx[:n] = i
            pidx[PARAM_IDX:PARAM_IDX + n] = a
            idx_ptr, host_ptr = 0, pidx.ctypes.data
        else:
            both = _lib.to_device(np.concatenate((i, a)), dev)
            idx_ptr, host_ptr = both.data_ptr(), 0
        _lib.launch("gather_bracketed_i64", dev, words.data_ptr(), n_w,
                    heap.data_ptr(), n_h, idx_ptr, host_ptr, n,
                    out.data_ptr())
        launches.add()
        bracketed_launches.add()
    return (out, both) if with_index else out


__all__ = ["bracketed_launches", "gather_bracketed", "gather_lockver_plain",
           "gather_plain", "gather_read", "gather_read_dev", "launches"]
