"""Transaction control-flow exceptions (canonical home).

Historically these lived in ``repro_torch.core.stm``; that module re-exports
them so old imports keep working, but the engine layer — and anything
below ``repro_torch.api`` — should import from here.
"""
from __future__ import annotations


class AbortTx(Exception):
    """Transaction abort (longjmp back to beginTxn)."""


class MaxRetriesExceeded(Exception):
    """A transaction hit the retry cap (baselines quit here; paper SS5)."""
