"""Thin adapter that puts the word-level engine behind the Substrate protocol.

`WordSubstrate` wraps any `TransactionEngine` (in this slice the
Multiverse STM, a policy over `repro_torch.core.engine`).
It owns none of the transactional logic — begin/read/write/commit stay in
the engine — it only normalizes the lifecycle so the shared retry loop
(`repro_torch.api.run`), the `txn()` context manager and `@atomic` work
identically on every TM:

  * `abort` delegates to the engine's idempotent `_abort` (policy-specific
    rollback included), so a voluntary or user-error unwind can never
    leave locks held or writes unrolled;
  * `validate` routes `Txn.validate_bulk` to the engine's batched
    read-set validator (scalar below `BULK_MIN`, vectorized above);
  * `on_retries_exhausted` lets the retry loop force-release anything a
    capped transaction still holds (locks, retire buffers);
  * `stats()` reports the shared schema with the registry backend name;
  * unknown attributes fall through to the raw TM, so instrumentation
    that pokes backend internals (`tm.vlt`, `tm.mode_counter`, ...)
    keeps working on the wrapped object.

Pre-engine TMs (third-party `TMBase` descendants) still work: every
engine-specific call falls back to the old attribute-poking behavior.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.api.substrate import SubstrateBase, Txn
from repro_torch.core.engine import AbortTx
from repro_torch.core.stats_schema import normalize_stats

__all__ = ["WordSubstrate"]


class WordSubstrate(SubstrateBase):
    def __init__(self, raw: Any, name: Optional[str] = None):
        self.raw = raw
        self.name = name or type(raw).__name__.lower()

    # -- lifecycle -------------------------------------------------------
    def begin_operation(self, tid: int) -> None:
        op = getattr(self.raw, "begin_operation", None)
        if op is not None:                # engine path
            op(tid)
            return
        ctx = self.raw.ctx(tid)           # legacy raw-TM fallback
        if hasattr(ctx, "versioned"):
            ctx.versioned = False
            ctx.no_versioning = False
            ctx.initial_versioned_ts = None
        ctx.attempts = 0

    def begin(self, tid: int = 0) -> Txn:
        self.raw.begin(tid)
        ctx = self.raw.ctx(tid)
        ctx.active = True
        return Txn(self, ctx, tid)

    def commit(self, txn: Txn) -> None:
        self.raw._try_commit(txn._ctx)
        txn._ctx.active = False

    def abort(self, txn: Txn) -> None:
        ctx = txn._ctx
        if not getattr(ctx, "active", False):
            return                        # backend already rolled back
        try:
            self.raw._abort(ctx)          # engine: idempotent, no raise
        except AbortTx:
            pass                          # legacy TMs raise from _abort
        ctx.active = False

    # -- accesses --------------------------------------------------------
    def read(self, ctx: Any, addr: int) -> Any:
        return self.raw.tm_read(ctx, addr)

    def read_bulk(self, ctx: Any, addrs) -> Any:
        """`Txn.read_bulk`: engine-routed batch (one heap gather + lock
        gathers + vectorized predicate); legacy raw TMs without
        `tm_read_bulk` fall back to the scalar loop."""
        fn = getattr(self.raw, "tm_read_bulk", None)
        if fn is not None:
            return fn(ctx, addrs)
        return [self.raw.tm_read(ctx, int(a)) for a in addrs]

    def write(self, ctx: Any, addr: int, value: Any) -> None:
        self.raw.tm_write(ctx, addr, value)

    def write_bulk(self, ctx: Any, addrs, values) -> None:
        """`Txn.write_bulk`: engine-routed batch (one lock-claim sweep +
        undo gather + heap scatter for encounter-time policies, one
        write-map update for buffered ones); legacy raw TMs without
        `tm_write_bulk` fall back to the scalar loop."""
        fn = getattr(self.raw, "tm_write_bulk", None)
        if fn is not None:
            fn(ctx, addrs, values)
            return
        for a, v in zip(addrs, values):
            self.raw.tm_write(ctx, int(a), v)

    def txn_alloc(self, ctx: Any, n: int, init: Any = None) -> int:
        return self.raw.tx_alloc(ctx, n, init)

    def read_count(self, ctx: Any) -> int:
        if getattr(ctx, "read_cnt", 0):
            return ctx.read_cnt
        return len(getattr(ctx, "read_set", ())) + \
            len(getattr(ctx, "read_vals", ()))

    # -- validation / exhaustion ------------------------------------------
    def validate(self, ctx: Any) -> bool:
        """`Txn.validate_bulk`: batched read-set check, engine-routed."""
        fn = getattr(self.raw, "validate_ctx", None)
        return bool(fn(ctx)) if fn is not None else True

    def on_retries_exhausted(self, tid: int) -> None:
        fn = getattr(self.raw, "on_retries_exhausted", None)
        if fn is not None:
            fn(tid)

    # -- heap / lifecycle pass-through ------------------------------------
    def alloc(self, n: int, init: Any = None) -> int:
        return self.raw.alloc(n, init)

    def peek(self, addr: int) -> Any:
        return self.raw.peek(addr)

    def stats(self) -> dict:
        return normalize_stats(self.raw.stats(), backend=self.name)

    def stop(self) -> None:
        self.raw.stop()

    def __getattr__(self, item: str) -> Any:
        # instrumentation escape hatch: vlt, mode_counter, announce, ...
        return getattr(self.raw, item)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"WordSubstrate({self.name})"
