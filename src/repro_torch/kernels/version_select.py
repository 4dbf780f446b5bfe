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

``mirror_select`` is what the versioned bulk read runs: the reference's
``PackedVLT.select`` (``repro/core/vlt.py``) — the seqlock-bracketed
gather of the mirror rows, the way match and the selection over the
matched way — as ONE launch of the second kernel in the same source.
Per element (lock index, address) it writes the value and a code (way +
1 where the row was stable, even, matched and held a version below the
clock, else 0) into a [2, N] int64 block, which the caller passes as
rows of its own output so that one copy brings everything home.  Up to
``PARAM_IDX`` elements the indices and addresses ride in the launch's
parameters; a longer chunk reads them from the device copy the bracketed
gather already staged (``dev_idx``).  Its launches count under
``launches`` and under ``mirror_launches``.  ``mirror_select_plain`` is
its plain version: the reference's steps in torch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("version_select")
#: the mirror_select launches alone (each also counts under ``launches``)
mirror_launches = _lib.LaunchCounter("mirror_select")

#: up to this many elements ``mirror_select`` passes its lock indices and
#: addresses in the launch's parameters (kParamIdx in
#: csrc/version_select.cu)
PARAM_IDX = 256


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


def _select_work(ts, data, *_, **__):
    """``(flops, bytes)`` of one selection (``_lib.counted``): no
    products; every slot's timestamp and value read, a value and a flag
    written a row."""
    return 0, ts.nbytes + data.nbytes + 12 * ts.shape[0]


def _mirror_work(seq, way_addr, tsdata, idxs, *_, **__):
    """``(flops, bytes)`` of one mirror resolve: the seqlock words, way
    addresses, timestamps and values a row reads and its two output
    words (116 B an element, the bound's count)."""
    return 0, 116 * len(idxs)


def _mirror_on_work(m, idxs, *_, **__):
    return _mirror_work(None, None, None, idxs)


@_lib.counted("version_select", _select_work)
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


def mirror_select_plain(seq: torch.Tensor, way_addr: torch.Tensor,
                        tsdata: torch.Tensor, idx: torch.Tensor,
                        addrs: torch.Tensor, r_clock: int) -> torch.Tensor:
    """Plain PyTorch version of ``mirror_select``: ``[2, N]`` int64, the
    values and the codes.  The reference's steps: ``seq``, the way
    addresses and the slots gathered, ``seq`` again; the first way equal
    to the address (way 0 where none is; a sentinel never matches); the
    first slot of that way below the clock (slot 0 where none is)."""
    n, ways = idx.numel(), way_addr.shape[1]
    s1 = seq[idx]
    rows = way_addr[idx]                           # [N, ways]
    td = tsdata[:, idx]                            # [2, N, ways, depth]
    s2 = seq[idx]
    match = (rows == addrs[:, None]) & (rows >= 0)
    pos = torch.arange(ways, device=seq.device).expand_as(rows)
    way = torch.where(match, pos, ways).min(dim=1).values
    matched = way < ways
    way = torch.where(matched, way, 0)
    r = torch.arange(n, device=seq.device)
    vals, found = version_select_plain(td[0][r, way], td[1][r, way],
                                       r_clock)
    ok = (s1 == s2) & ((s1 & 1) == 0) & matched & (found != 0)
    return torch.stack((vals, torch.where(ok, way + 1, 0)))


class MirrorTables(NamedTuple):
    """A mirror's tensors, checked once (``mirror_tables``), with what a
    launch needs of them precomputed."""
    seq: torch.Tensor
    way_addr: torch.Tensor
    tsdata: torch.Tensor
    size: int
    ways: int
    depth: int
    vec: int          # the ways and slots may be loaded as 16-byte vectors
    cuda: bool


def mirror_tables(seq: torch.Tensor, way_addr: torch.Tensor,
                  tsdata: torch.Tensor) -> MirrorTables:
    """Check the mirror's tensors — ``seq`` [size], ``way_addr`` [size,
    ways], ``tsdata`` [2, size, ways, depth], contiguous int64 on one
    device — for ``mirror_select``."""
    for t in (seq, way_addr, tsdata):
        if t.dtype != torch.int64 or not t.is_contiguous() or \
                t.device != seq.device:
            raise ValueError("mirror_select expects contiguous int64 "
                             "mirror tensors on one device")
    size, ways = way_addr.shape
    depth = tsdata.shape[-1]
    if seq.shape != (size,) or tsdata.shape != (2, size, ways, depth):
        raise ValueError("mirror_select: mirror tensors of other shapes")
    if _lib.device_kind(seq) == "cpu":
        vec = 0
    else:
        vec = int(depth % 2 == 0 and (way_addr.data_ptr()
                                      | tsdata.data_ptr()) % 16 == 0)
    return MirrorTables(seq, way_addr, tsdata, size, ways, depth, vec,
                        seq.is_cuda)


@_lib.counted("version_select", _mirror_work)
def mirror_select(seq: torch.Tensor, way_addr: torch.Tensor,
                  tsdata: torch.Tensor, idxs, addrs, r_clock: int,
                  dev_idx: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[2, N]`` int64 on the mirror's device: for each (lock index,
    address) the newest committed version of the address strictly below
    ``r_clock`` (row 0) and its code (row 1: way + 1, or 0 where the row
    was torn, matched no way or held no such version).

    ``seq`` [size], ``way_addr`` [size, ways] and ``tsdata`` [2, size,
    ways, depth] are the mirror's contiguous int64 tensors on one device;
    ``idxs``/``addrs`` host arrays of one length, each lock index inside
    the table or ``IndexError`` is raised before anything is launched.
    ``dev_idx``: both index sets already on the card ([2N] int64, the
    lock indices then the addresses); ``out``: a contiguous [2, N] int64
    tensor on the mirror's device to write into."""
    return mirror_select_on(mirror_tables(seq, way_addr, tsdata), idxs,
                            addrs, r_clock, dev_idx, out)


@_lib.counted("version_select", _mirror_on_work)
def mirror_select_on(m: MirrorTables, idxs, addrs, r_clock: int,
                     dev_idx: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mirror_select`` over tables checked by ``mirror_tables`` (a
    ``PackedVLT`` checks its own once)."""
    i, a = _lib.host_index(idxs), _lib.host_index(addrs)
    n = i.size
    if a.size != n:
        raise ValueError("mirror_select: idxs and addrs differ in length")
    _lib.check_addr_bounds(i, m.size)
    dev = m.seq.device
    if out is None:
        out = torch.empty((2, n), dtype=torch.int64, device=dev)
    elif out.shape != (2, n) or out.dtype != torch.int64 or \
            not out.is_contiguous() or out.device != dev:
        raise ValueError("out must be a contiguous [2, N] int64 tensor on "
                         "the mirror's device")
    if not m.cuda:
        out.copy_(mirror_select_plain(m.seq, m.way_addr, m.tsdata,
                                      torch.from_numpy(i.copy()),
                                      torch.from_numpy(a.copy()), r_clock))
        return out
    if not n:
        return out
    idx_ptr = host_idx = host_addr = None
    if dev_idx is None and n <= PARAM_IDX and m.size <= 1 << 31:
        pidx = np.empty(PARAM_IDX, np.int32)
        pidx[:n] = i
        paddr = np.ascontiguousarray(a)
        host_idx, host_addr = pidx.ctypes.data, paddr.ctypes.data
    else:
        if dev_idx is None:
            dev_idx = _lib.to_device(np.concatenate((i, a)), dev)
        elif dev_idx.shape != (2 * n,) or dev_idx.dtype != torch.int64 \
                or dev_idx.device != dev:
            raise ValueError("dev_idx must be the [2N] int64 index sets "
                             "on the mirror's device")
        idx_ptr = dev_idx.data_ptr()
    _lib.launch("mirror_select_i64", dev, m.seq.data_ptr(),
                m.way_addr.data_ptr(), m.tsdata.data_ptr(), m.size, m.ways,
                m.depth, m.vec, idx_ptr, host_idx, host_addr, n,
                int(r_clock), out.data_ptr())
    launches.add()
    mirror_launches.add()
    return out


__all__ = ["MirrorTables", "PARAM_IDX", "launches", "mirror_launches",
           "mirror_select", "mirror_select_on", "mirror_select_plain",
           "mirror_tables", "version_select", "version_select_plain"]
