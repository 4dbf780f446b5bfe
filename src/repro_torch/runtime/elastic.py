"""Elastic scaling: re-mesh a running job when the healthy device count
changes (a card lost or added).

The policy keeps the 'model' (TP/EP) axis fixed — it is baked into layout
decisions — and rescales the data axis, so the global batch stays
constant while per-device microbatching adapts.  ``rescale_plan`` computes
the new mesh shape + microbatching (plain arithmetic);
``make_rescaled_mesh`` lays it over ``launch/mesh.Mesh``;
``reshard_state`` moves a live train state onto a mesh of ranks as
DTensors (the reference's ``jax.device_put``: DTensor's redistribution
issues the collectives).  The counter-based data pipeline repartitions
exactly (``data/pipeline.py``), so no sample is lost or duplicated
across a rescale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh, make_mesh

__all__ = ["RescalePlan", "make_rescaled_mesh", "rescale_plan",
           "reshard_state"]


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    microbatches: int
    note: str = ""


def rescale_plan(*, n_devices: int, model_parallel: int,
                 global_batch: int, old_microbatches: int) -> RescalePlan:
    """Largest data axis that divides the fleet while keeping TP fixed."""
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by TP={model_parallel}")
    data = n_devices // model_parallel
    while data > 1 and global_batch % data != 0:
        data -= 1            # drop stragglers below a divisible count
    used = data * model_parallel
    micro = max(1, min(global_batch // data, old_microbatches))
    note = "" if used == n_devices else (
        f"parking {n_devices - used} chips (batch divisibility)")
    return RescalePlan((data, model_parallel), ("data", "model"), micro,
                       note)


def make_rescaled_mesh(plan: RescalePlan,
                       devices: Optional[Sequence] = None) -> Mesh:
    """The plan's mesh over the first ``prod(mesh_shape)`` of ``devices``
    (default: every card; raises without CUDA, as every entry point
    does)."""
    n = 1
    for s in plan.mesh_shape:
        n *= s
    if devices is None:
        from repro_torch.launch.mesh import _cards
        devices = _cards()
    devs = list(devices)
    if len(devs) < n:
        raise ValueError(f"plan {plan.mesh_shape} needs {n} devices, got "
                         f"{len(devs)}")
    return make_mesh(plan.mesh_shape, plan.axis_names, devs[:n])


def reshard_state(state, new_mesh, rules=None, spec_tree=None):
    """``state`` (nested dicts, tuples and named tuples of tensors; other
    leaves, such as the MVStore's host clocks, kept) moved onto
    ``new_mesh`` (a rank ``Mesh`` or a ``DeviceMesh``) as DTensors.

    ``spec_tree`` (partition specs, a tree matching ``state``) gives each
    leaf its layout; without it each DTensor leaf keeps its placements
    and a plain tensor is replicated.  ``rules`` is the reference's
    argument and is not read.  Every leaf gets storage of its own: a
    DTensor is redistributed (its values kept, its layout changed by
    DTensor's collectives), a plain tensor cut to this rank's shard and
    copied, so a step that updates the moved state in place (the fused
    commit) never writes the tensors it came from."""
    from torch.distributed.tensor import DTensor, Replicate, \
        distribute_tensor

    from repro_torch.launch.sharding import device_mesh, placements

    dm = device_mesh(new_mesh)

    def move(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        if spec is not None:
            pl = placements(spec, dm)
        elif isinstance(x, DTensor):
            pl = tuple(x.placements)
        else:
            pl = (Replicate(),) * dm.ndim
        if isinstance(x, DTensor):
            if x.device_mesh == dm:
                out = x.redistribute(dm, pl)
                if out.to_local().untyped_storage().data_ptr() == \
                        x.to_local().untyped_storage().data_ptr():
                    out = out.clone()           # a layout it already had
                return out
            x = x.full_tensor()
        return distribute_tensor(x.detach().clone(), dm, pl,
                                 src_data_rank=None)

    def walk(x, s):
        if isinstance(x, dict):
            return {k: walk(v, None if s is None else s[k])
                    for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v, None if s is None else s[i])
                             for i, v in enumerate(x)))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v, None if s is None else s[i])
                           for i, v in enumerate(x))
        return move(x, s)

    return walk(state, spec_tree)
