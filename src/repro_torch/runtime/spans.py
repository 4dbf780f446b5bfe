"""Spans: named host intervals inside the program, on the profiler's clock.

    from repro_torch.runtime import spans

    with spans.span("serve.decode", rids=[3, 7]):
        ...

    @spans.spanned("mvstore.commit")     # the whole call, no attrs
    def mv_commit(...): ...

A span records only while a torch profiler records, or inside ``with
spans.recording():``.  Otherwise ``span`` costs one check and returns a
shared no-op context: no lock, no allocation.  While a profiler records,
a span also opens a ``torch.profiler.record_function`` of its name, so
an exported trace (``export_chrome_trace``) shows the program's spans
beside the card's work; it never does so with the profiler off.

Each record (``Span``) holds its ``name``, ``start_ns`` and ``end_ns``
from ``time.time_ns()`` (the clock of the profiler's host events, so a
span lies over the device trace as it is), ``parent`` (the innermost
span open on the same thread when it opened, or None), ``thread``
(``threading.get_ident()``) and ``attrs``.  A span opened on another
thread, such as the autograd engine's, has no parent there: match it to
its caller by time.

Records live in memory, in one session: the latest ``recording()`` block
or the latest profiled stretch.  A new session drops the old one.  A
profiled stretch begins at the first span that finds a profiler
recording after a span found none or a ``recording()`` block began; the
profiler gives no other sign of a new run, so two profiled runs with no
span opened between them read as one stretch.  ``records()`` returns
the latest session's closed spans, in the order they closed; past
``CAP`` records a session counts what it drops (``dropped()``).

Counters.  ``count(name, fn)`` adds the tensor ``fn()`` into the
session's counter ``name`` in place, on the tensor's device, with no
host sync; like a span it records only while a profiler records or
inside ``recording()``, and otherwise does not call ``fn``.
``counters()`` returns the latest session's, to be read (brought home)
once, after the stretch.

The spans the program opens, ``<layer>.<part>``:

    train.step        Trainer.train_step, around the step function
    steps.forward     the loss (zoo.loss_fn) of a train step
    steps.backward    torch.autograd.grad of a train step
    ssd.backward      SSDScanFn.backward (on the autograd engine's thread)
    mvstore.commit    a commit: mv_commit, or the fused commit of a step
    mvstore.resolve   mv_snapshot
    serve.prefill     ModelSlotExecutor.prefill; attrs: rid
    serve.decode      ModelSlotExecutor.decode; attrs: rids
    serve.readback    a copy home that waits for the card, inside either
    mamba.decode      mamba_apply's decode form (one token a slot)
    moe.route         a dropless MoE layer's routing (moe_dropless)
    moe.experts       its grouped expert products and combine

The counters:

    moe.expert_rows   rows each held expert computed ([experts held],
                      int64), summed over the dropless MoE layers' calls
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

#: records one session keeps; past it a session counts drops
CAP = 1_000_000


class Span:
    """One closed (or still open) span."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "attrs")

    def __init__(self, name: str, parent: Optional["Span"],
                 attrs: Dict[str, Any]):
        self.name = name
        self.parent = parent
        self.thread = threading.get_ident()
        self.attrs = attrs
        self.start_ns = self.end_ns = 0


class _Session:
    __slots__ = ("records", "dropped", "counters", "lock")

    def __init__(self):
        self.records: List[Span] = []
        self.dropped = 0
        self.counters: Dict[str, torch.Tensor] = {}
        self.lock = threading.Lock()   # spans close on several threads

    def count(self, name: str, value: torch.Tensor) -> None:
        with self.lock:
            acc = self.counters.get(name)
            if acc is None:
                self.counters[name] = value.detach().clone()
            else:
                acc.add_(value)

    def add(self, rec: Span) -> None:
        with self.lock:
            if len(self.records) < CAP:
                self.records.append(rec)
            else:
                self.dropped += 1


_latest = _Session()         # what records() reads
_recording: Optional[_Session] = None   # an open recording() block's
_profiled: Optional[_Session] = None    # the profiled stretch's
_switch = threading.Lock()   # taken only where a session begins or ends
_stacks = threading.local()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """A span being recorded into ``session``."""

    __slots__ = ("rec", "session", "annotation", "stack")

    def __init__(self, name: str, attrs: Dict[str, Any], session: _Session,
                 profiled: bool):
        self.stack = _stack()
        self.rec = Span(name, self.stack[-1] if self.stack else None, attrs)
        self.session = session
        self.annotation = (torch.profiler.record_function(name)
                           if profiled else None)

    def __enter__(self):
        self.stack.append(self.rec)
        # stamped before the annotation opens: its first call in a process
        # spends ~1 ms after the profiler's own stamp
        self.rec.start_ns = time.time_ns()
        if self.annotation is not None:
            self.annotation.__enter__()
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.time_ns()
        self.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.session.add(self.rec)
        return False


def _stack() -> List[Span]:
    try:
        return _stacks.spans
    except AttributeError:
        _stacks.spans = []
        return _stacks.spans


def _begin_profiled() -> _Session:
    global _profiled, _latest
    with _switch:
        if _profiled is None:
            _profiled = _latest = _Session()
        return _profiled


def _end_profiled() -> None:
    global _profiled
    with _switch:
        _profiled = None


def _session(profiled: bool) -> Optional[_Session]:
    """The session a span or count records into, or None."""
    if _recording is None and not profiled:
        if _profiled is not None:
            _end_profiled()
        return None
    session = _recording
    if session is None:
        session = _profiled if _profiled is not None else _begin_profiled()
    return session


def span(name: str, **attrs):
    """``with span(name, **attrs):`` records the block while a profiler
    records or inside ``recording()``; otherwise a shared no-op."""
    # the profiler's own flag, set from its start to its stop (the C
    # check reads false under a profile of all threads)
    profiled = _profiler._is_profiler_enabled
    session = _session(profiled)
    if session is None:
        return _NULL
    return _Open(name, attrs, session, profiled)


def count(name: str, value: Callable[[], torch.Tensor]) -> None:
    """Add ``value()`` into the counter ``name`` (on its device, no host
    sync) while spans record; otherwise nothing (``value`` is not
    called, so an idle counter costs no device work)."""
    session = _session(_profiler._is_profiler_enabled)
    if session is not None:
        session.count(name, value())


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record every span opened inside the block, with no profiler (a new
    session; ``records()`` reads it until the next one begins)."""
    global _recording, _latest, _profiled
    with _switch:
        prev = _recording
        _recording = _latest = _Session()
        _profiled = None
    try:
        yield
    finally:
        with _switch:
            _recording = prev


def records() -> List[Span]:
    """The latest session's closed spans, in the order they closed."""
    return list(_latest.records)


def counters() -> Dict[str, torch.Tensor]:
    """The latest session's counters, as tensors on their devices."""
    return dict(_latest.counters)


def dropped() -> int:
    """Spans the latest session dropped past ``CAP``."""
    return _latest.dropped
