"""Carry STM state across packages: numpy arrays in, numpy arrays out.

The tests compute from the SAME state in the JAX reference and in the
port: they dump the reference's heap, lock words, clock and PackedVLT
mirror as numpy arrays and install them here (``load_numpy_state``), or
read the port's state back for a bit-for-bit comparison
(``dump_numpy_state``).  Keys::

    heap         int64[H]             the allocated heap words
    lock_words   int64[2^bits]        packed lock words
    clock        int                  the global (deferred) clock
    mirror_seq   int64[2^bits]        PackedVLT seqlock per row
    mirror_addr  int64[2^bits, ways]  addresses each way tracks
    mirror_ts    int64[2^bits, ways, depth]
    mirror_data  int64[2^bits, ways, depth]

Only the array state moves: version lists, bloom filters and EBR are
host objects that ``load_numpy_state`` leaves as they are, so a loaded
mirror is consistent with the version lists only if the caller makes it
so.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["dump_numpy_state", "load_numpy_state"]

_MIRROR_KEYS = ("mirror_seq", "mirror_addr", "mirror_ts", "mirror_data")


def _engine(tm):
    return getattr(tm, "raw", tm)


def load_numpy_state(tm, state: Dict) -> None:
    """Install ``state`` (see the module docstring) into a port ``tm`` (a
    ``make_tm`` product or a raw engine).  Shapes must match the port's
    tables; the heap must be an ``ArrayHeap``."""
    eng = _engine(tm)
    heap = np.asarray(state["heap"], np.int64)
    dev = eng.device
    h = eng.heap
    with h._lock:
        buf = torch.zeros(max(heap.size, h._buf.shape[0]),
                          dtype=torch.int64, device=dev)
        buf[:heap.size] = torch.from_numpy(heap.copy()).to(dev)
        h._buf, h._len = buf, heap.size
    words = np.asarray(state["lock_words"], np.int64)
    if words.shape != tuple(eng.locks._words.shape):
        raise ValueError(f"lock table is {tuple(eng.locks._words.shape)}, "
                         f"state has {words.shape}")
    eng.locks._words.copy_(torch.from_numpy(words.copy()))
    eng.clock.store(int(state["clock"]))
    eng.policy.vlt.mirror.load(*(state[k] for k in _MIRROR_KEYS))


def dump_numpy_state(tm) -> Dict:
    """The port's state as host numpy arrays (inverse of
    ``load_numpy_state``)."""
    eng = _engine(tm)
    out = {"heap": eng.heap.live().cpu().numpy().copy(),
           "lock_words": eng.locks._words.cpu().numpy().copy(),
           "clock": eng.clock.load()}
    for src, key in zip(eng.policy.vlt.mirror.arrays(), _MIRROR_KEYS):
        out[key] = src.cpu().numpy().copy()
    return out
