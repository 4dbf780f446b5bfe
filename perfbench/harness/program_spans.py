"""The program's own spans (``repro_torch.runtime.spans``) of a traced
run, for the per-layer readers that take them.

The tracer profiles just the window and its closing sync, and the span
layer keeps the latest profiled stretch, so ``records()`` read after the
run holds the window's spans.  A program without the span layer, or a
run in which none recorded, gives None."""
from __future__ import annotations

from typing import List, Optional


def window() -> Optional[list]:
    """The spans of the traced window, or None."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans.records() or None


def _under(rec, name: str) -> bool:
    p = rec.parent
    while p is not None:
        if p.name == name:
            return True
        p = p.parent
    return False


def total_ms(recs: List, name: str, under: Optional[str] = None) -> float:
    """Milliseconds in the spans named ``name`` (only those opened inside
    a span named ``under``, when given)."""
    return 1e-6 * sum(r.end_ns - r.start_ns for r in recs
                      if r.name == name
                      and (under is None or _under(r, under)))


def per(name: str, per_name: str, under: Optional[str] = None
        ) -> Optional[float]:
    """Milliseconds in ``name`` spans over the number of ``per_name``
    spans, or None without them."""
    recs = window()
    if recs is None:
        return None
    n = sum(1 for r in recs if r.name == per_name)
    return total_ms(recs, name, under) / n if n else None
