"""The one transactional surface (`Substrate` protocol + `Txn` handle).

The paper's claim is that versioned and unversioned transactions share a
single programming model; this module is that model for the port.  Every
backend — the word-level Multiverse STM, the TL2/DCTL/NOrec/TinySTM
baselines, and the Layer-B MVStore — is driven through the same five verbs:

    tm = make_tm("multiverse", n_threads=4)
    a = tm.alloc(2, 100)

    with tm.txn(tid=0) as tx:          # one attempt; AbortTx on conflict
        tx.write(a, tx.read(a) + 1)

    @atomic(tm, tid=0)                 # retry loop built in
    def transfer(tx, src, dst, amt):
        tx.write(src, tx.read(src) - amt)
        tx.write(dst, tx.read(dst) + amt)

    run(tm, lambda tx: tx.read(a), tid=1)   # functional form

Retry/backoff policy lives HERE (in `run`), not in any backend: aborts
raise `AbortTx` (the setjmp/longjmp analogue), `run` rolls the transaction
back if the backend has not already, and retries up to `max_retries`
(0 = unbounded) with optional exponential backoff.
"""
from __future__ import annotations

import functools
import random
import time
from typing import Any, Callable, Optional, Protocol, runtime_checkable

from repro_torch.core.engine import AbortTx, MaxRetriesExceeded

__all__ = [
    "AbortTx", "MaxRetriesExceeded", "Substrate", "SubstrateBase", "Txn",
    "atomic", "run", "as_substrate",
]


class Txn:
    """Uniform transaction handle: what user code sees inside a txn body.

    The same handle type is used on every substrate; it only forwards to
    the owning substrate, which interprets `addr` for its layer (heap word
    index at the word level, block offset at the store level).
    """

    __slots__ = ("_sub", "_ctx", "tid")

    def __init__(self, sub: "SubstrateBase", ctx: Any, tid: int):
        self._sub = sub
        self._ctx = ctx
        self.tid = tid

    def read(self, addr: int) -> Any:
        return self._sub.read(self._ctx, addr)

    def read_bulk(self, addrs) -> Any:
        """Batched transactional read: ``[self.read(a) for a in addrs]``
        semantics, one substrate call.

        ``addrs`` is any address sequence (``range``, list, ndarray).
        On engine-backed word substrates the batch runs as one heap
        gather bracketed by two consistent lock-word gathers (three
        ``gather_read`` launches on the device) plus a vectorized
        predicate.  Elements the fast path cannot prove consistent are
        transparently re-read through the scalar protocol.

        SAFETY is never weakened: every accepted element is provably the
        value at the transaction's snapshot, and unprovable elements get
        the policy's exact scalar semantics.  One LIVENESS caveat: on
        Multiverse's Mode-Q versioned path, batching accepts stable words
        by validation instead of seeding version lists for them (the
        scalar reader-triggered versioning), so a later re-read of a word
        an updater has since overwritten — or another versioned reader of
        it — may abort where the all-scalar protocol would have found a
        version.  Long scans read each word once and are unaffected.
        Returns a sequence: a 1-D int64 tensor on the store's device
        when the whole batch gathered clean from an array heap, a list
        otherwise.
        """
        fn = getattr(self._sub, "read_bulk", None)
        if fn is not None:
            return fn(self._ctx, addrs)
        return [self._sub.read(self._ctx, int(a)) for a in addrs]

    def traverse_bulk(self, roots, expand, *, limit: Optional[int] = None):
        """Ordered frontier-at-a-time traversal: not ported yet."""
        raise NotImplementedError(
            "traverse_bulk is not ported yet (the traverse + structs slice)")

    def chase_bulk(self, cursors, advance) -> int:
        """Vectorized pointer chase: not ported yet."""
        raise NotImplementedError(
            "chase_bulk is not ported yet (the traverse + structs slice)")

    def write(self, addr: int, value: Any) -> None:
        self._sub.write(self._ctx, addr, value)

    def write_bulk(self, addrs, values) -> None:
        """Batched transactional write: ``for a, v: self.write(a, v)``
        semantics, one substrate call.

        ``values`` may be a tensor (on any device), a numpy array or a
        list.  Multiverse in Mode Q validates and claims every lock in
        ONE all-or-nothing ``try_lock_bulk`` sweep, records pre-images in
        one undo gather, and publishes in one in-place heap scatter.
        Semantics are never weakened: batches the sweep cannot claim
        take the policy's exact scalar path word by word.
        """
        fn = getattr(self._sub, "write_bulk", None)
        if fn is not None:
            fn(self._ctx, addrs, values)
            return
        for a, v in zip(addrs, values):
            self._sub.write(self._ctx, int(a), v)

    def alloc(self, n: int, init: Any = None) -> int:
        """Transactional allocation, freed again if this txn aborts."""
        return self._sub.txn_alloc(self._ctx, n, init)

    @property
    def read_count(self) -> int:
        return self._sub.read_count(self._ctx)

    def validate_bulk(self) -> bool:
        """Batched mid-transaction validation: is everything this txn has
        read still consistent right now?

        Routes to the substrate's engine-level validator — the word-level
        engine checks the whole read set in one ``validate`` launch once
        it exceeds ``engine.BULK_MIN`` entries.  Read-only: never aborts
        and never mutates txn state, so long readers can poll it to fail
        fast instead of discovering staleness only at commit.
        """
        fn = getattr(self._sub, "validate", None)
        return bool(fn(self._ctx)) if fn is not None else True


@runtime_checkable
class Substrate(Protocol):
    """What a backend must provide to plug into `run`/`atomic`/`txn`.

    `begin` hands out a `Txn`; `read`/`write`/`txn_alloc` take the context
    the substrate itself put into that handle; `commit`/`abort` finish it.
    `abort` must be IDEMPOTENT: called on an already-rolled-back txn it is
    a no-op (the retry loop cannot know whether the backend unwound state
    before raising `AbortTx`).
    """

    name: str

    def begin(self, tid: int = 0) -> Txn: ...
    def read(self, ctx: Any, addr: int) -> Any: ...
    def write(self, ctx: Any, addr: int, value: Any) -> None: ...
    def txn_alloc(self, ctx: Any, n: int, init: Any = None) -> int: ...
    def commit(self, txn: Txn) -> None: ...
    def abort(self, txn: Txn) -> None: ...
    def alloc(self, n: int, init: Any = None) -> int: ...
    def stats(self) -> dict: ...
    def stop(self) -> None: ...


class _TxnScope:
    """Single-attempt context manager returned by `SubstrateBase.txn`.

    Commits on clean exit; a conflict (`AbortTx`) propagates to the caller
    — pair with `run`/`atomic` when you want automatic retry.  Any other
    exception rolls the attempt back before propagating, so user errors
    can never poison the TM (locks held, writes unrolled).
    """

    __slots__ = ("_sub", "_tid", "_txn")

    def __init__(self, sub: "SubstrateBase", tid: int):
        self._sub = sub
        self._tid = tid
        self._txn: Optional[Txn] = None

    def __enter__(self) -> Txn:
        self._txn = self._sub.begin(self._tid)
        return self._txn

    def __exit__(self, exc_type, exc, tb) -> bool:
        assert self._txn is not None
        if exc_type is None:
            self._sub.commit(self._txn)      # may raise AbortTx
            return False
        # AbortTx from inside the body: the backend already rolled back
        # (abort() is idempotent, so a voluntary user-raised AbortTx is
        # unwound here too); other exceptions must roll back before
        # propagating.  A simulated crash (reliability/faultpoints) is
        # the one exception that must NOT roll back: a real crash never
        # runs this frame, and recovery needs the crash image intact.
        if getattr(exc, "simulated_crash", False):
            return False
        self._sub.abort(self._txn)
        return False


class SubstrateBase:
    """Shared convenience surface every substrate inherits.

    Subclasses implement the `Substrate` protocol verbs; this base adds the
    context-manager / decorator / stats plumbing on top of them.
    """

    name = "substrate"

    # -- protocol hooks subclasses may refine ---------------------------
    def begin_operation(self, tid: int) -> None:
        """Reset per-OPERATION state before a fresh retry loop.

        Per-transaction state (versioned flag, attempt count) persists
        only across RETRIES of one logical operation — the paper resets
        these thread-locals when a NEW transaction starts (Alg. 1 l.10).
        """

    def read_count(self, ctx: Any) -> int:
        return getattr(ctx, "read_cnt", 0)

    def read_bulk(self, ctx: Any, addrs) -> Any:
        """`Txn.read_bulk` hook: default is the scalar loop, so every
        substrate supports the batched surface even before it vectorizes
        (`WordSubstrate`/`MVStoreHandle` override with real batches)."""
        return [self.read(ctx, int(a)) for a in addrs]

    def validate(self, ctx: Any) -> bool:
        """`Txn.validate_bulk` hook: read-only consistency check."""
        return True

    def on_retries_exhausted(self, tid: int) -> None:
        """Retry-cap cleanup hook: `run` calls this before raising
        `MaxRetriesExceeded` so a capped transaction can never leave
        encounter-time locks held or retire buffers unflushed (a wedged
        thread must not block later writers — paper SS5's abort cap)."""

    # -- uniform user surface -------------------------------------------
    def txn(self, tid: int = 0) -> _TxnScope:
        """One transaction attempt as a context manager."""
        self.begin_operation(tid)
        return _TxnScope(self, tid)

    def run(self, fn: Callable[[Txn], Any], tid: int = 0,
            max_retries: int = 0, backoff_s: float = 0.0) -> Any:
        return run(self, fn, tid=tid, max_retries=max_retries,
                   backoff_s=backoff_s)

    def atomic(self, tid: int = 0, max_retries: int = 0,
               backoff_s: float = 0.0):
        return atomic(self, tid=tid, max_retries=max_retries,
                      backoff_s=backoff_s)

    def __enter__(self) -> "SubstrateBase":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False

    def stop(self) -> None:  # pragma: no cover - overridden
        pass


def as_substrate(tm: Any) -> Any:
    """Coerce a raw TM (Multiverse / baseline) into the Substrate surface.

    Already-wrapped substrates — and any third-party object implementing
    the `Substrate` protocol — pass through untouched, so every entry
    point accepts `make_tm(...)` products, protocol implementations, and
    hand-built TM instances alike.
    """
    if isinstance(tm, SubstrateBase) or isinstance(tm, Substrate):
        return tm
    from repro_torch.api.adapters import WordSubstrate
    return WordSubstrate(tm)


_BACKOFF_CAP_S = 0.01


def run(tm: Any, fn: Callable[[Txn], Any], tid: int = 0,
        max_retries: int = 0, backoff_s: float = 0.0) -> Any:
    """Run `fn(tx)` as one atomic operation, retrying on conflict.

    max_retries=0 means unbounded (the paper's workers); a bounded cap
    raises `MaxRetriesExceeded` (the paper's SS5 'maximum allowed aborts').
    `backoff_s` > 0 sleeps an exponentially growing, jittered interval
    between attempts (capped at 10ms) — off by default because the GIL
    already serializes this port's contention.
    """
    sub = as_substrate(tm)
    op_reset = getattr(sub, "begin_operation", None)
    if op_reset is not None:        # optional hook; bare Substrate
        op_reset(tid)               # implementations may omit it
    tries = 0
    while True:
        txn = sub.begin(tid)
        try:
            result = fn(txn)
            sub.commit(txn)
            return result
        except AbortTx:
            sub.abort(txn)               # no-op if the backend rolled back
            tries += 1
            if max_retries and tries >= max_retries:
                cleanup = getattr(sub, "on_retries_exhausted", None)
                if cleanup is not None:
                    cleanup(tid)         # release locks, flush retires
                raise MaxRetriesExceeded(
                    f"{sub.name}: txn exceeded {max_retries} retries")
            if backoff_s:
                delay = min(_BACKOFF_CAP_S, backoff_s * (1 << min(tries, 10)))
                time.sleep(delay * random.random())
        except BaseException as e:
            # user-code exception mid-attempt: roll back so the TM is not
            # poisoned (locks held / writes unrolled), then propagate —
            # unless it's a simulated crash (reliability/faultpoints),
            # whose whole point is that no cleanup frame ever runs and
            # recovery must reconstruct consistency from the wreckage
            if not getattr(e, "simulated_crash", False):
                sub.abort(txn)
            raise


def atomic(tm: Any, tid: int = 0, max_retries: int = 0,
           backoff_s: float = 0.0):
    """Decorator form: the function body becomes a transaction.

    The decorated function gains keyword-only `tid=` / `max_retries=`
    overrides at call time (so one decorated body can serve many worker
    threads):

        @atomic(tm, tid=0)
        def transfer(tx, src, dst, amt): ...
        transfer(a, b, 5)          # runs as thread 0
        transfer(a, b, 5, tid=3)   # same body, thread 3
    """
    sub = as_substrate(tm)

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, tid=tid, max_retries=max_retries,
                    backoff_s=backoff_s, **kwargs):
            return run(sub, lambda tx: fn(tx, *args, **kwargs), tid=tid,
                       max_retries=max_retries, backoff_s=backoff_s)
        wrapper.__substrate__ = sub
        return wrapper
    return deco
