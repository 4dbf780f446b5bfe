"""In-place batched scatter ``row[idx[i]] = val[i]`` over an int64 row.

Replaces ``repro/kernels/scatter_write.py::scatter_write_flat`` (the
Pallas TPU kernel behind ``ops.write_back`` / ``ops.publish_row``).  The
TPU kernel returned a COPY of the heap with the updates applied — jax
arrays are immutable, so grid step 0 seeded the output block before the
later steps scattered into it.  The port's heap and lock words are
mutable device buffers, so the CUDA kernel (``csrc/scatter_write.cu``)
writes IN PLACE: no seed step (which would race the scatter across
parallel CUDA blocks) and no O(heap) copy per commit.

Callers: the heap write-back and undo restore of the commit pipeline,
and the lock-word claims and releases of ``ArrayLockTable``.  Addresses
are unique (write sets are dict-keyed); the release sweep may repeat an
index, always with the same word, so thread order never matters.

What bounds it on the card: bytes — 24 per element (index, value,
written word); at the main path's 256..1024-word batches the launch
dominates.  One thread per element; the ragged edge is masked in the
kernel, so there is no one-past-the-end padding for scatter to drop.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("scatter_write")


def scatter_plain(row: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """Plain PyTorch version: ``row[idx] = vals`` in place."""
    row[idx] = vals


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


def as_values(values, n: int, device: torch.device) -> torch.Tensor:
    """Write values as a contiguous int64 tensor on ``device``: a tensor
    is moved/cast, anything else coerces through ``int`` per element
    like the scalar ``heap[a] = v`` path does."""
    if isinstance(values, torch.Tensor):
        v = values.reshape(-1).to(device=device, dtype=torch.int64)
        return v.contiguous()
    arr = np.asarray(values)
    if arr.dtype.kind not in "iu":             # e.g. object payloads
        arr = np.fromiter((int(v) for v in values), np.int64, n)
    return _lib.to_device(arr.reshape(-1), device)


def scatter_write(row: torch.Tensor, addrs, values) -> None:
    """``row[addrs] = values`` in place.  ``addrs`` are host addresses,
    checked against ``[0, len(row))`` before anything is launched;
    ``values`` may be a tensor (any device), a numpy array or a list."""
    _lib.check_row(row)
    a = _lib.host_index(addrs)
    _lib.check_addr_bounds(a, row.numel())
    vals = as_values(values, a.size, row.device)
    if vals.numel() != a.size:
        raise ValueError(f"{a.size} addresses but {vals.numel()} values")
    scatter_write_dev(row, _lib.to_device(a, row.device), vals)


__all__ = ["as_values", "launches", "scatter_plain", "scatter_write",
           "scatter_write_dev"]
