"""Backend registry: `make_tm(name, n_threads=..., **kw)`.

One constructor for every substrate:

    make_tm("multiverse", n_threads=8, array_heap=True)      # on the card
    make_tm("multiverse", n_threads=2, device="cpu")         # tests

Every factory returns a `SubstrateBase` (the word-level TM wrapped in
`WordSubstrate`), so the product always speaks
`txn()/run()/atomic()/stats()/stop()` with the normalized stats schema.
Only ``multiverse`` is ported so far; the JAX package's other backend
names raise "not ported yet".

`device` says where the heap, lock words and version mirror live;
``None`` means the card, and without CUDA that raises (no silent CPU
fallback).  `forced_mode` pins the mode machinery for the Fig. 8
ablations: "U" jumps the mode counter to Mode U and pins a sticky bit so
the background thread stays there; "Q" disables the Q->QtoU CAS
heuristics (K2/K3 -> inf).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.api.adapters import WordSubstrate
from repro_torch.api.substrate import SubstrateBase

__all__ = ["make_tm", "register_backend", "backend_names"]

_BACKENDS: Dict[str, Callable[..., SubstrateBase]] = {}

#: backends of the JAX package that this port does not provide yet
NOT_PORTED = ("tl2", "dctl", "norec", "tinystm", "mvstore", "shardstore")


def register_backend(name: str, factory: Callable[..., SubstrateBase],
                     overwrite: bool = False) -> None:
    """Register `factory(n_threads, params, forced_mode, **kw)` under
    `name` (case-insensitive)."""
    key = name.lower()
    if key in _BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _BACKENDS[key] = factory


def backend_names() -> tuple:
    return tuple(sorted(_BACKENDS))


def make_tm(name: str, n_threads: int = 1, *,
            params: Any = None, forced_mode: Optional[str] = None,
            **kw) -> SubstrateBase:
    try:
        factory = _BACKENDS[name.lower()]
    except KeyError:
        if name.lower() in NOT_PORTED:
            raise ValueError(
                f"backend {name!r} is not ported yet; ported: "
                f"{backend_names()}") from None
        raise ValueError(
            f"unknown backend {name!r}; registered: {backend_names()}"
        ) from None
    return factory(n_threads, params=params, forced_mode=forced_mode, **kw)


def _make_multiverse(n_threads: int, params=None, forced_mode=None,
                     start_bg: bool = True, array_heap: bool = False,
                     device=None, **kw) -> SubstrateBase:
    from repro_torch.configs.paper_stm import MultiverseParams
    from repro_torch.core.engine import ArrayHeap, resolve_device
    from repro_torch.core.stm import Multiverse

    dev = resolve_device(device)
    if params is None:
        params = MultiverseParams(**kw)
    elif kw:
        params = dataclasses.replace(params, **kw)
    if forced_mode == "Q":
        # disable the Q->QtoU CAS heuristics: the TM can never leave Q
        params = dataclasses.replace(params, k2=1 << 30, k3=1 << 30)
    heap = ArrayHeap(device=dev) if array_heap else None
    tm = Multiverse(n_threads, params, start_bg=start_bg, heap=heap,
                    device=dev)
    if forced_mode == "U":
        # jump the counter to Mode U and pin a synthetic sticky bit so
        # the background thread stays there (Fig. 8 forced-U variant)
        tm.mode_counter.store(2)
        tm.first_obs_mode_u_ts.store(tm.clock.load())
        tm.announce[0].sticky_mode_u = True
    return WordSubstrate(tm, name="multiverse")


register_backend("multiverse", _make_multiverse)
