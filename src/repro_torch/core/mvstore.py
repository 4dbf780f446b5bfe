"""MVStore: the paper's dynamic multiversioning at parameter-store level.

Layer-B adaptation: parameter blocks are the transactional addresses,
the optimizer commit is the update transaction, snapshot readers (eval /
checkpoint / serve-from-trainer) are the long-running read-only
transactions, and the global clock is a step counter.

Version lists become bounded rings of R slots per versioned block, on
the block's device (overflow surfaces as reader abort/retry, exactly like
a paper conflict).  Which blocks are versioned changes only at step
boundaries, through the host-side controller (``mvcontroller.py``).

Commit semantics per mode (paper Table 1):
  - local Mode Q, unversioned block: the new value replaces the live one.
  - local Mode Q, versioned block:   the same + ring append.
  - local Mode U (and QtoU/UtoQ):    every written block must be versioned
    -> ring append for all blocks.

Snapshot reads resolve each block to the newest version with
ts <= read_clock (versioned blocks), or to the live value with a
block-clock check stamp <= read_clock (unversioned blocks, the Mode-Q
reader path that aborts when the writer advanced the clock).

State layout in the port.  ``MVStoreState`` holds dicts of device
tensors: ``live`` is the caller's (possibly nested) dict of blocks, and
``ring``/``ring_ts``/``block_clocks`` are keyed by each block's path,
spelled as the JAX package's ``jax.tree_util.keystr`` spells it
(``"['heap']"``; dict keys in sorted order), so states of the two
packages compare key for key.  ``clock`` and the block stamps are host
ints; ring timestamps are int32 tensors [R] and blocks keep their dtype
(the word store's block is int32).

What is in place and what is not: ``mv_commit`` is functional like the
reference; ``mv_commit_fused`` (the store's sparse publish) builds the
new live block OUT OF PLACE through the ``commit_fused`` kernel, so a
reader holding the old block keeps a whole snapshot, and the same call
refreshes the ring slot ``clock' % R`` and its timestamp IN PLACE, as
the reference's call does (donated there) — R x the block per commit
would be the price of an immutable ring.  A caller with concurrent ring
readers fences that slot itself (``api/mvhandle.py``'s seqlock on the
host copy of the timestamps).

Sharded blocks.  A block may be a DTensor (``launch/steps``' sharded
steps): its ring is laid out as ``(None,) + the block's spec``, its
timestamps replicated, and the kernels run on each rank's shard
(``sharding.local_call``): ``snapshot_select`` picks the slot on every
rank alike (the timestamps are whole everywhere) and copies the local
row; ``commit_fused`` writes, on each rank, the addresses that fall in
its piece of the block.
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, List, NamedTuple, Optional, \
    Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import MVStoreConfig
from repro_torch.kernels import commit_fused as CF
from repro_torch.kernels import snapshot_select as SS
from repro_torch.launch.sharding import is_dtensor, local_call, local_range
from repro_torch.reliability import faultpoints as FP

NO_TS = -1          # empty ring slot


class MVStoreState(NamedTuple):
    """live: the blocks' current values ('addresses').  ring/ring_ts exist
    only for versioned blocks (dict keyed by block path -> [R, ...] /
    int32 [R]).  ``block_clocks`` is the per-block level of the two-level
    clock scheme: the LAST-WRITER stamp of every block (path -> int, in
    the units of ``clock``).  ``None`` means every check falls back to
    the global clock."""
    live: Any
    ring: dict
    ring_ts: dict
    clock: int
    block_clocks: Any = None


VersionedSet = Union[str, FrozenSet[str]]  # 'all' | 'none' | explicit paths


def _flatten(params, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs of a nested dict of tensors, in the order
    and spelling of ``jax.tree_util.tree_flatten_with_path`` +
    ``keystr``: sorted keys, ``"['a']['b']"``."""
    if isinstance(params, dict):
        out = []
        for k in sorted(params):
            out.extend(_flatten(params[k], f"{prefix}[{k!r}]"))
        return out
    return [(prefix, params)]


def _unflatten(params, leaves: Dict[str, Any], prefix: str = ""):
    """``params``' nesting with each leaf replaced by ``leaves[path]``."""
    if isinstance(params, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]")
                for k, v in params.items()}
    return leaves[prefix]


def ring_placements(pl):
    """A ring's placements from its block's (the slot dim is whole)."""
    if pl is None:
        return None
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                 for p in pl)


def replicated(pl):
    """Replicated placements on the mesh of placements ``pl``."""
    if pl is None:
        return None
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(pl)


def block_paths(params) -> list:
    return [p for p, _ in _flatten(params)]


def _is_versioned(path: str, versioned: VersionedSet) -> bool:
    if versioned == "all":
        return True
    if versioned == "none" or not versioned:
        return False
    return path in versioned


def resolve_versioned(params, versioned: VersionedSet) -> FrozenSet[str]:
    """The paths of ``params``' blocks that ``versioned`` names."""
    return frozenset(p for p in block_paths(params)
                     if _is_versioned(p, versioned))


def _seed_ring(leaf: torch.Tensor, slots: int, ts0: int):
    """A fresh ring holding ``leaf`` in slot 0 at ``ts0``."""
    buf = torch.zeros((slots,) + tuple(leaf.shape), dtype=leaf.dtype,
                      device=leaf.device)
    buf[0] = leaf
    ts = torch.full((slots,), NO_TS, dtype=torch.int32, device=leaf.device)
    ts[0] = ts0
    return buf, ts


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def mv_init(params, cfg: MVStoreConfig,
            versioned: VersionedSet = "none") -> MVStoreState:
    """Build store state.  Versioned blocks get an R-slot ring seeded with
    the current value at clock 0 (paper SS3.1.1: the initial version
    takes the last consistent value and the earliest safe ts)."""
    ring, ring_ts, block_clocks = {}, {}, {}
    for path, leaf in _flatten(params):
        block_clocks[path] = 0
        if _is_versioned(path, versioned):
            ring[path], ring_ts[path] = _seed_ring(leaf, cfg.ring_slots, 0)
    return MVStoreState(live=params, ring=ring, ring_ts=ring_ts, clock=0,
                        block_clocks=block_clocks)


# ---------------------------------------------------------------------------
# commit (the update-transaction write path)
# ---------------------------------------------------------------------------


def _check_versioned(local_mode: str, paths, ring) -> None:
    if local_mode in ("U", "QtoU", "UtoQ"):
        # every written block must already be in the versioned set: the
        # controller guarantees this before handing out a Mode-U step
        missing = [p for p in paths if p not in ring]
        if missing:
            raise ValueError(
                f"Mode {local_mode} commit with unversioned blocks "
                f"{missing[:3]}... — controller must version first")


def mv_commit(state: MVStoreState, new_params, *, local_mode: str,
              cfg: MVStoreConfig) -> MVStoreState:
    """Publish a whole-store step.  Rings rotate: the new value lands in
    slot ``clock' % R`` of a COPY of each ring (this path is functional,
    like the reference)."""
    if FP.ACTIVE is not None:
        FP.fire("pre_scatter")
    new_clock = state.clock + 1
    paths = block_paths(new_params)
    _check_versioned(local_mode, paths, state.ring)
    ring, ring_ts = state.ring, state.ring_ts
    if ring:
        slot = new_clock % cfg.ring_slots
        new_ring, new_ts = {}, {}
        for path, leaf in _flatten(new_params):
            if path in ring:
                new_ring[path] = ring[path].clone()
                new_ring[path][slot] = leaf.to(ring[path].dtype)
                new_ts[path] = ring_ts[path].clone()
                new_ts[path][slot] = new_clock
        ring, ring_ts = new_ring, new_ts
    block_clocks = dict(state.block_clocks or {})
    for path in paths:
        block_clocks[path] = new_clock
    return MVStoreState(live=new_params, ring=ring, ring_ts=ring_ts,
                        clock=new_clock, block_clocks=block_clocks)


def mv_commit_fused(state: MVStoreState, key: str, addrs, values, *,
                    local_mode: str, cfg: MVStoreConfig) -> MVStoreState:
    """Sparse single-block publish: ``mv_commit`` where the new value is
    the live block ``state.live[key]`` with ``values`` scattered at
    ``addrs``.

    The new block comes out of ONE ``commit_fused`` call, OUT OF PLACE
    (the kernel seeds the new tensor from the old one and scatters into
    it), so the old block stays whole for readers still holding it.  A
    versioned block's ring slot ``clock' % R`` and its timestamp are
    refreshed IN PLACE by the same call, as in the reference (module
    docstring).  Addresses outside the block raise ``IndexError`` before
    anything is written.
    """
    if FP.ACTIVE is not None:
        FP.fire("pre_scatter")
    new_clock = state.clock + 1
    live = state.live[key]
    path = f"[{key!r}]"
    _check_versioned(local_mode, (path,), state.ring)
    a = np.asarray(addrs, np.int64).reshape(-1)
    if a.size:
        lo, hi = int(a.min()), int(a.max())
        if lo < 0 or hi >= int(live.shape[0]):
            raise IndexError(lo if lo < 0 else hi)
    z = np.zeros((0,), np.int64)
    one = np.zeros(1, np.int64)
    ring = state.ring.get(path)
    pl = tuple(live.placements) if is_dtensor(live) else None
    if pl is not None:              # this rank's addresses, made local
        lo, n = local_range(live)
        sel = (a >= lo) & (a < lo + n)
        a, values = a[sel] - lo, np.asarray(values).reshape(-1)[sel]

    def publish(block, ring, ring_ts):
        kw = {}
        if ring is not None:
            kw = dict(ring=ring, ring_ts=ring_ts,
                      ring_slot=new_clock % cfg.ring_slots)
        return CF.commit_fused(
            block, a, values, np.zeros(a.size, np.int64), z, z, z, z, z,
            one, one, new_clock, 1, out_of_place=True, **kw)[0]

    new_block = local_call(
        publish, (live, ring, state.ring_ts.get(path)),
        (pl, ring_placements(pl), replicated(pl)), pl, tuple(live.shape))
    if FP.ACTIVE is not None:
        FP.fire("mid_scatter")
    new_live = dict(state.live)
    new_live[key] = new_block
    # a sparse publish touches ONE block: only its stamp advances
    block_clocks = dict(state.block_clocks or {})
    block_clocks[path] = new_clock
    return MVStoreState(live=new_live, ring=state.ring,
                        ring_ts=state.ring_ts, clock=new_clock,
                        block_clocks=block_clocks)


# ---------------------------------------------------------------------------
# snapshot read (the versioned read-only transaction)
# ---------------------------------------------------------------------------


def _select_version(buf, ts, read_clock):
    """Newest slot with NO_TS < ts <= read_clock: ``(value, ok)``, through
    the ``snapshot_select`` kernel on the card (its plain version for a
    CPU ring); a sharded ring's on every rank's shard."""
    if not is_dtensor(buf):
        return SS.snapshot_select(buf, ts, read_clock)
    from torch.distributed.tensor import Shard
    rpl = tuple(buf.placements)
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in rpl)
    rep = replicated(pl)
    return local_call(lambda b, t: SS.snapshot_select(b, t, read_clock),
                      (buf, ts), (rpl, rep), [pl, rep],
                      [tuple(buf.shape[1:]), ()])


def mv_snapshot(state: MVStoreState, read_clock, *,
                assume_versioned: bool = False,
                impl: str = "xla") -> Tuple[Any, torch.Tensor]:
    """Resolve a consistent view at ``read_clock``.

    ``assume_versioned``: the local-Mode-U reader path — unversioned
    blocks are read live *without* validation.  Mode-Q readers validate
    unversioned blocks against their block clock and get ok=False when
    the writer has advanced.  Returns ``(params_view, ok)`` with ``ok`` a
    0-d bool tensor on the blocks' device.  ``impl`` keeps the reference's
    signature and picks nothing: a versioned block always goes through
    ``snapshot_select``.
    """
    flat = _flatten(state.live)
    dev = flat[0][1].device if flat else torch.device("cpu")
    ok = torch.ones((), dtype=torch.bool, device=dev)
    leaves = {}
    for path, leaf in flat:
        if path in state.ring:
            val, vok = _select_version(state.ring[path],
                                       state.ring_ts[path], int(read_clock))
            ok = ok & vok
            leaves[path] = val.to(leaf.dtype)
        else:
            if not assume_versioned:
                # per-block validation: only a write to THIS block since
                # read_clock invalidates the view (two-level clock rule)
                ok = ok & (block_clock(state, path) <= read_clock)
            leaves[path] = leaf
    return _unflatten(state.live, leaves), ok


# ---------------------------------------------------------------------------
# per-block clock queries (host-side conflict detection)
# ---------------------------------------------------------------------------


def block_clock(state: MVStoreState, path: str) -> int:
    """Last-writer stamp of ``path``; without per-block stamps, the
    global clock."""
    bc = state.block_clocks
    if bc is None or path not in bc:
        return int(state.clock)
    return int(bc[path])


def blocks_conflict(state: MVStoreState, paths, read_clock: int) -> bool:
    """True iff any block in ``paths`` was committed after ``read_clock``
    (disjoint-block updaters never conflict)."""
    return any(block_clock(state, p) > read_clock for p in paths)


# ---------------------------------------------------------------------------
# host-side maintenance (controller helpers)
# ---------------------------------------------------------------------------


def version_blocks(state: MVStoreState, paths, cfg: MVStoreConfig,
                   first_obs_mode_u_ts: Optional[int] = None
                   ) -> MVStoreState:
    """Version additional blocks (reader-triggered in Mode Q; writer-forced
    in Mode U).  The initial version takes the live value; its timestamp
    is firstObsModeUTs when valid, else the current clock (paper SS4.2)."""
    ring = dict(state.ring)
    ring_ts = dict(state.ring_ts)
    ts0 = (first_obs_mode_u_ts if first_obs_mode_u_ts is not None
           else state.clock)
    for path, leaf in _flatten(state.live):
        if path in paths and path not in ring:
            ring[path], ring_ts[path] = _seed_ring(leaf, cfg.ring_slots,
                                                   int(ts0))
    return state._replace(ring=ring, ring_ts=ring_ts)


def unversion_blocks(state: MVStoreState, paths) -> MVStoreState:
    """Drop rings (the background thread's unversioning)."""
    ring = {k: v for k, v in state.ring.items() if k not in paths}
    ring_ts = {k: v for k, v in state.ring_ts.items() if k not in paths}
    return state._replace(ring=ring, ring_ts=ring_ts)


def versioned_paths(state: MVStoreState) -> FrozenSet[str]:
    return frozenset(state.ring)


def ring_bytes(state: MVStoreState) -> int:
    return int(sum(v.numel() * v.element_size()
                   for v in state.ring.values()))
