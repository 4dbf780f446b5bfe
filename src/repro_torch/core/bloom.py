"""Per-bucket bloom filters (paper SS3.1.2).

One filter per lock/VLT bucket, stored in a parallel table of identical
size.  Membership answers "is this address versioned?" without walking the
VLT bucket.  Filters only reset in bulk (unversioning a bucket resets its
filter — items cannot be removed, paper SS3.1.3).
"""
from __future__ import annotations

import threading
from typing import List

from repro_torch.core.locks import _GOLDEN, _MASK64


class BloomTable:
    def __init__(self, buckets_bits: int, bits_per_filter: int = 64):
        self.size = 1 << buckets_bits
        self.nbits = bits_per_filter
        self._filters: List[int] = [0] * self.size
        self._lock = threading.Lock()

    def _hashes(self, addr: int):
        h1 = (addr * _GOLDEN) & _MASK64
        h2 = ((addr ^ 0xDEADBEEF) * 0xC2B2AE3D27D4EB4F) & _MASK64
        return (1 << (h1 % self.nbits)) | (1 << (h2 % self.nbits))

    def contains(self, bucket: int, addr: int) -> bool:
        m = self._hashes(addr)
        return (self._filters[bucket] & m) == m

    def add(self, bucket: int, addr: int) -> None:
        m = self._hashes(addr)
        with self._lock:
            self._filters[bucket] |= m

    def try_add(self, bucket: int, addr: int) -> bool:
        """Paper Alg. 4 bloomFltr.tryAdd: returns False when the address was
        (apparently) already present, True when this call inserted it."""
        m = self._hashes(addr)
        with self._lock:
            if (self._filters[bucket] & m) == m:
                return False
            self._filters[bucket] |= m
            return True

    def reset(self, bucket: int) -> None:
        with self._lock:
            self._filters[bucket] = 0

    def fill_ratio(self, bucket: int) -> float:
        return bin(self._filters[bucket]).count("1") / self.nbits
