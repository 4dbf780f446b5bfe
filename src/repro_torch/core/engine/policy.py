"""``TMPolicy`` — what distinguishes one TM algorithm from another.

The engine owns the mechanism every backend shares (heap, clock, lock
table, descriptors, abort/alloc bookkeeping, stats aggregation, retry-
exhaustion cleanup); a policy supplies only the algorithm:

    class MyPolicy(PolicyBase):
        name = "mytm"
        def read(self, eng, d, addr): ...
        def write(self, eng, d, addr, value): ...
        def commit_update(self, eng, d): ...

and becomes a full backend via ``TransactionEngine(MyPolicy(), n)`` (or
``register_backend`` — see API.md for the worked example).  In the JAX
package TL2, DCTL, NOrec and TinySTM are such objects
(``repro/core/baselines.py``, not ported yet); Multiverse adds its
versioning machinery in ``core/stm.py`` through the same hooks.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from repro_torch.core.engine import validation as V


@runtime_checkable
class TMPolicy(Protocol):
    """Protocol form of the hook set (see ``PolicyBase`` for defaults)."""

    name: str
    validate_mode: int

    def setup(self, eng) -> None: ...
    def on_begin(self, eng, d) -> None: ...
    def read(self, eng, d, addr: int) -> Any: ...
    def write(self, eng, d, addr: int, value: Any) -> None: ...
    def commit_read_only(self, eng, d) -> None: ...
    def commit_update(self, eng, d) -> None: ...
    def rollback(self, eng, d) -> None: ...
    def on_abort(self, eng, d) -> None: ...
    def on_finish(self, eng, d) -> None: ...
    def validate(self, eng, d) -> bool: ...


class PolicyBase:
    """Default hook implementations: a read-snapshot TM with no writes."""

    name = "policy"
    validate_mode = V.V_LT

    # -- lifecycle -------------------------------------------------------
    def setup(self, eng) -> None:
        """Called once from the engine constructor."""

    def on_operation_start(self, eng, d) -> None:
        """A NEW logical operation begins (not a retry)."""
        d.reset_operation()

    def on_begin(self, eng, d) -> None:
        d.r_clock = eng.clock.load()

    def commit_read_only(self, eng, d) -> None:
        """Read-only commit bookkeeping (nothing to publish)."""

    def commit_update(self, eng, d) -> None:
        raise NotImplementedError

    def rollback(self, eng, d) -> None:
        """Undo this attempt's writes / release its locks."""

    def on_abort(self, eng, d) -> None:
        """Post-rollback bookkeeping (heuristics, attempt counting)."""
        d.attempts += 1

    def on_finish(self, eng, d) -> None:
        """Post-commit bookkeeping (both read-only and update commits)."""
        d.attempts = 0

    def on_retries_exhausted(self, eng, tid: int) -> None:
        """Retry cap hit: flush anything a wedged operation may hold."""

    # -- accesses --------------------------------------------------------
    def read(self, eng, d, addr: int) -> Any:
        raise NotImplementedError

    def read_bulk(self, eng, d, addrs) -> Any:
        """Batched read (``Txn.read_bulk``): default is the scalar loop.

        Lock-version policies override this with the vectorized batch in
        ``engine.bulkread`` (one heap gather bracketed by two lock-word
        gathers); the default keeps every third-party policy correct.
        ``addrs`` arrives as an int64 ndarray (the engine normalizes).
        """
        return [self.read(eng, d, int(a)) for a in addrs]

    def write(self, eng, d, addr: int, value: Any) -> None:
        raise NotImplementedError

    def write_bulk(self, eng, d, addrs, values) -> None:
        """Batched write (``Txn.write_bulk``): default is the scalar loop.

        Buffered policies override with one write-map update;
        encounter-time policies with one ``try_lock_bulk`` claim sweep +
        one undo gather + one heap scatter (``core/baselines.py``,
        ``core/stm.py``).  The default keeps every third-party policy
        correct.  ``addrs`` arrives as an int64 ndarray.
        """
        for a, v in zip(addrs, values):
            self.write(eng, d, int(a), v)

    # -- validation ------------------------------------------------------
    def validate(self, eng, d) -> bool:
        """Is the read set still valid right now?  (``Txn.validate_bulk``)"""
        return V.revalidate(eng.locks, d.read_set, d.r_clock, d.tid,
                            self.validate_mode)

    # -- reporting / teardown -------------------------------------------
    def mode_name(self, eng) -> str:
        return "-"

    def extra_stats(self, eng, out: dict) -> None:
        """Add policy-specific counters to the normalized stats dict."""

    def stop(self, eng) -> None:
        """Tear down background machinery."""
