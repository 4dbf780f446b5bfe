"""Backend registry: `make_tm(name, n_threads=..., **kw)`.

One constructor for every substrate:

    make_tm("multiverse", n_threads=8, array_heap=True)      # on the card
    make_tm("tl2", n_threads=8, array_heap=True)
    make_tm("dctl", n_threads=8, irrevocable_after=50)
    make_tm("mvstore", n_threads=4, ring_slots=16)
    make_tm("shardstore", n_threads=4, n_shards=2, span=8192)
    make_tm("multiverse", n_threads=2, device="cpu")         # tests

Every factory returns a `SubstrateBase` — the word-level TMs
(``multiverse``, ``tl2``, ``dctl``, ``norec``, ``tinystm``) wrapped in
`WordSubstrate`, the store-level MVStore as an `MVStoreHandle`, the
sharded store as a `ShardStoreHandle` — so the product always speaks
`txn()/run()/atomic()/stats()/stop()` with the normalized stats schema.

`device` says where the heap, lock words, version mirror and store
blocks live; ``None`` means the card, and without CUDA that raises (no
silent CPU fallback).  `array_heap=True` puts a word backend's heap in
the engine's int64 device tensor (the default object heap stores any
Python value on the host); the MVStore block is always an int32 device
tensor, so ``mvstore`` and ``shardstore`` accept the flag and need
nothing from it.
`forced_mode` pins the mode machinery for the Fig. 8 ablations on the
backends that have one (multiverse, mvstore, shardstore): "U" jumps the mode counter
to Mode U and pins a sticky bit so the background thread stays there;
"Q" disables the Q->QtoU CAS heuristics (K2/K3 -> inf).  The mode-less
baselines ignore it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.api.adapters import WordSubstrate
from repro_torch.api.substrate import SubstrateBase

__all__ = ["make_tm", "register_backend", "backend_names"]

_BACKENDS: Dict[str, Callable[..., SubstrateBase]] = {}


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


def _make_baseline(name: str):
    def factory(n_threads: int, params=None, forced_mode=None,
                array_heap: bool = False, device=None,
                **kw) -> SubstrateBase:
        from repro_torch.core.baselines import BASELINES
        from repro_torch.core.engine import ArrayHeap, resolve_device

        dev = resolve_device(device)
        # baselines share the Multiverse lock-table sizing for fairness
        if params is not None and "lock_bits" not in kw:
            kw["lock_bits"] = params.lock_table_bits
        heap = ArrayHeap(device=dev) if array_heap else None
        return WordSubstrate(BASELINES[name](n_threads, heap=heap,
                                             device=dev, **kw), name=name)
    return factory


def _make_mvstore(n_threads: int, params=None, forced_mode=None,
                  array_heap: bool = False, **kw) -> SubstrateBase:
    from repro_torch.api.mvhandle import MVStoreHandle
    from repro_torch.configs.paper_stm import MultiverseParams

    if "ring_slots" in kw:
        from repro_torch.configs.base import MVStoreConfig
        kw.setdefault("cfg", MVStoreConfig(ring_slots=kw.pop("ring_slots")))
    if forced_mode == "Q":
        params = dataclasses.replace(params or MultiverseParams(),
                                     k2=1 << 30, k3=1 << 30)
    h = MVStoreHandle(n_threads, params=params, **kw)
    if forced_mode == "U":
        # pin the controller in Mode U via a dedicated sticky reader
        # handle no worker tid ever commits through (so sticky_cleared
        # can never clear it) — the store-level forced-U ablation
        ctl = h.controller
        ctl.mode_counter = 2                      # Q -> QtoU -> U
        ctl.stats["mode_transitions"] += 2
        ctl.first_obs_mode_u_ts = 0
        ctl.reader().ann.sticky_mode_u = True
    return h


register_backend("multiverse", _make_multiverse)
for _name in ("tl2", "dctl", "norec", "tinystm"):
    register_backend(_name, _make_baseline(_name))
def _make_shardstore(n_threads: int, params=None, forced_mode=None,
                     array_heap: bool = False, **kw) -> SubstrateBase:
    """The sharded MVStore (`core/shardstore.ShardStoreHandle`).

    `n_shards` / `span` pick the partitioning; `forced_mode` mirrors the
    mvstore factory (the shards share ONE controller, so the pin applies
    store-wide)."""
    from repro_torch.configs.paper_stm import MultiverseParams
    from repro_torch.core.shardstore import ShardStoreHandle

    if "ring_slots" in kw:
        from repro_torch.configs.base import MVStoreConfig
        kw.setdefault("cfg", MVStoreConfig(ring_slots=kw.pop("ring_slots")))
    if forced_mode == "Q":
        params = dataclasses.replace(params or MultiverseParams(),
                                     k2=1 << 30, k3=1 << 30)
    h = ShardStoreHandle(n_threads, params=params, **kw)
    if forced_mode == "U":
        ctl = h.controller
        ctl.mode_counter = 2                      # Q -> QtoU -> U
        ctl.stats["mode_transitions"] += 2
        ctl.first_obs_mode_u_ts = 0
        ctl.reader().ann.sticky_mode_u = True
    return h


register_backend("mvstore", _make_mvstore)
register_backend("shardstore", _make_shardstore)
