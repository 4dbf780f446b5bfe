"""In-place batched scatter ``row[idx[i]] = val[i]`` over an int64 row.

Replaces ``repro/kernels/scatter_write.py::scatter_write_flat`` (the
Pallas TPU kernel behind ``ops.write_back`` / ``ops.publish_row``).  The
TPU kernel returned a COPY of the heap with the updates applied — jax
arrays are immutable, so grid step 0 seeded the output block before the
later steps scattered into it.  The port's heap and lock words are
mutable device buffers, so the CUDA kernels (``csrc/scatter_write.cu``)
write IN PLACE: no seed step (which would race the scatter across
parallel CUDA blocks) and no O(heap) copy per commit.

Callers: the heap write-back and undo restore of the commit pipeline,
and the lock-word claims and releases of ``ArrayLockTable``.  Addresses
are unique (write sets are dict-keyed); the release sweep may repeat an
index, always with the same word, so thread order never matters.

Two routes on the card.  Host columns (a list, numpy, a CPU tensor —
what every STM caller holds) go through ONE C call,
``scatter_pairs_i64``: the host packs (index, value) int64 pairs
(``pack_pairs``, the values coerced straight into the buffer by
``as_values``); up to ``PARAM_PAIRS`` pairs ride in the launch's
parameters (one launch, no copy), a longer batch sits in one pinned
staging block that the call copies to the block's device scratch before
its kernel.  ``scatter_fill`` stores one value at every index (the
commit's lock release), indices alone, up to ``2 * PARAM_PAIRS`` in the
parameters.  A values tensor already on the card keeps
``scatter_write_dev``: both columns on the card, one launch.

What bounds it on the card: bytes — 24 per element (index, value,
written word); at the main path's 256..1024-word batches the launch
dominates.  The ragged edge is masked in the kernels, so there is no
one-past-the-end padding for scatter to drop.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("scatter_write")

#: up to this many (index, value) pairs ride in the launch's parameters
#: (kParamPairs in csrc/scatter_write.cu); a fill, twice as many indices
PARAM_PAIRS = 1024

_tls = threading.local()


def scatter_plain(row: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """Plain PyTorch version: ``row[idx] = vals`` in place."""
    row[idx] = vals


def scatter_fill_plain(row: torch.Tensor, idx: torch.Tensor,
                       value: int) -> None:
    """Plain PyTorch version of ``scatter_fill``: ``row[idx] = value``."""
    row[idx] = value


def _scatter_work(row, addrs, *_, **__):
    """``(flops, bytes)`` of one scatter (``_lib.counted``): no
    products; each (index, value) pair read and each word written (24 B
    an int64 word)."""
    return 0, 24 * len(addrs)


def _fill_work(row, addrs, *_, **__):
    """``(flops, bytes)`` of one fill: each index read, each word
    written."""
    return 0, 16 * len(addrs)


@_lib.counted("scatter_write", _scatter_work)
def scatter_write_dev(row: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor) -> None:
    """Scatter with ``idx``/``vals`` already int64 tensors on ``row``'s
    device and ``idx`` already bounds-checked."""
    if _lib.device_kind(row) == "cpu":
        scatter_plain(row, idx, vals)
        return
    n = idx.numel()
    if vals.numel() != n:
        raise ValueError(f"{n} addresses but {vals.numel()} values")
    if n:
        _lib.launch("scatter_write_i64", row.device, row.data_ptr(),
                    row.numel(), idx.data_ptr(), vals.data_ptr(), n)
        launches.add()


def as_values(values, n: int, out: np.ndarray) -> np.ndarray:
    """Write values into ``out`` (an int64 array of ``n`` words, which
    may be a strided view of a pair buffer) and return it: a tensor is
    cast as torch casts it, integer arrays are copied as they are, and
    anything else (lists, object payloads) coerces through ``int`` per
    element like the scalar ``heap[a] = v`` path does."""
    if isinstance(values, torch.Tensor):
        values = values.reshape(-1).to(device="cpu",
                                       dtype=torch.int64).numpy()
    if isinstance(values, np.ndarray):
        if values.size != n:
            raise ValueError(f"{n} addresses but {values.size} values")
        if values.dtype.kind in "iub":
            np.copyto(out, values.reshape(-1), casting="unsafe")
        else:
            out[:] = np.fromiter((int(v) for v in values.reshape(-1)),
                                 np.int64, n)
        return out
    try:
        seq = values if isinstance(values, (list, tuple)) else list(values)
    except TypeError:
        raise ValueError(f"{n} addresses but a scalar value") from None
    if len(seq) != n:
        raise ValueError(f"{n} addresses but {len(seq)} values")
    # fromiter converts each element as int() does, without the type
    # discovery of np.asarray (twice as fast on a list of ints)
    out[:] = np.fromiter(seq, np.int64, n)
    return out


def pack_pairs(buf: np.ndarray, addrs: np.ndarray, values) -> None:
    """The host columns as the C call reads them: ``buf[2i]`` the index,
    ``buf[2i + 1]`` the value, for the ``n = len(addrs)`` pairs (``buf``
    an int64 array of at least ``2n`` words)."""
    n = addrs.size
    buf[0:2 * n:2] = addrs
    as_values(values, n, buf[1:2 * n:2])


def _param_buffer():
    """This thread's parameter buffer and its address (the C call copies
    it into the launch's parameters before it returns)."""
    buf = getattr(_tls, "buf", None)
    if buf is None:
        arr = np.empty(2 * PARAM_PAIRS, np.int64)
        buf = _tls.buf = (arr, arr.ctypes.data)
    return buf


def _scatter_host(row: torch.Tensor, a: np.ndarray, values,
                  fill: bool, value: int = 0) -> None:
    """One ``scatter_pairs_i64`` call from host columns: pairs (or, with
    ``fill``, indices alone) in the launch's parameters, or in one
    staging block copied by the same call."""
    n = a.size
    words = n if fill else 2 * n
    dev = row.device
    args = (n, int(fill), int(value))
    if words <= 2 * PARAM_PAIRS:
        buf, ptr = _param_buffer()
        if fill:
            buf[:n] = a
        else:
            pack_pairs(buf, a, values)
        if n:
            _lib.launch("scatter_pairs_i64", dev, row.data_ptr(),
                        row.numel(), ptr, None, None, None, *args)
    else:
        pool = _lib.staging(dev)
        st = pool.acquire()
        try:
            _, _, i64 = st.take(8 * words)
            if fill:
                i64[:n] = a
            else:
                pack_pairs(i64, a, values)
            _lib.launch("scatter_pairs_i64", dev, row.data_ptr(),
                        row.numel(), None, st.ptr + _lib.STAGING_HEAD,
                        st.scratch(8 * words), st.event, *args)
        finally:
            pool.release(st)
    if n:
        launches.add()


@_lib.counted("scatter_write", _scatter_work)
def scatter_write(row: torch.Tensor, addrs, values) -> None:
    """``row[addrs] = values`` in place.  ``addrs`` are host addresses,
    checked against ``[0, len(row))`` before anything is launched;
    ``values`` may be a tensor (any device), a numpy array or a list.
    On the card, host values take one ``scatter_pairs_i64`` call and a
    values tensor on the card ``scatter_write_dev``."""
    _lib.check_row(row)
    a = _lib.host_index(addrs)
    n = a.size
    _lib.check_addr_bounds(a, row.numel())
    if not row.is_cuda:
        _lib.device_kind(row)
        vals = as_values(values, n, np.empty(n, np.int64))
        scatter_plain(row, torch.from_numpy(np.array(a)),
                      torch.from_numpy(vals))
    elif isinstance(values, torch.Tensor) and values.is_cuda:
        vals = values.reshape(-1).to(device=row.device, dtype=torch.int64)
        if vals.numel() != n:
            raise ValueError(f"{n} addresses but {vals.numel()} values")
        scatter_write_dev(row, _lib.to_device(a, row.device),
                          vals.contiguous())
    else:
        _scatter_host(row, a, values, fill=False)


@_lib.counted("scatter_write", _fill_work)
def scatter_fill(row: torch.Tensor, addrs, value: int) -> None:
    """``row[addrs] = value`` in place: one value at every address (the
    commit's lock release), bounds checked as in ``scatter_write``."""
    _lib.check_row(row)
    a = _lib.host_index(addrs)
    _lib.check_addr_bounds(a, row.numel())
    if not row.is_cuda:
        _lib.device_kind(row)
        scatter_fill_plain(row, torch.from_numpy(np.array(a)), int(value))
    else:
        _scatter_host(row, a, None, fill=True, value=value)


__all__ = ["PARAM_PAIRS", "as_values", "launches", "pack_pairs",
           "scatter_fill", "scatter_fill_plain", "scatter_plain",
           "scatter_write", "scatter_write_dev"]
