"""Elastic scaling: re-mesh a running job when the healthy device count
changes (a card lost or added).

The policy keeps the 'model' (TP/EP) axis fixed — it is baked into layout
decisions — and rescales the data axis, so the global batch stays
constant while per-device microbatching adapts.  ``rescale_plan`` computes
the new mesh shape + microbatching (plain arithmetic);
``make_rescaled_mesh`` lays it over ``launch/mesh.Mesh``.  The
counter-based data pipeline repartitions exactly (``data/pipeline.py``),
so no sample is lost or duplicated across a rescale.  Moving a live
train state onto the new mesh (the JAX package's ``reshard_state``)
needs the port's sharding rules and waits for them (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.launch.mesh import Mesh, make_mesh

__all__ = ["RescalePlan", "rescale_plan", "make_rescaled_mesh"]


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
