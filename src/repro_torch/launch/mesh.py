"""Device meshes for the port: a named grid of ``torch.device``s.

The JAX package's meshes are ``jax.make_mesh`` objects; here a ``Mesh``
is only what its one consumer reads, the device grid and its axis names
(``launch/sharding.shard_device_slices`` places the sharded store's
shards on ``mesh.devices``).  The production pods' meshes
(``make_production_mesh``, 16x16 and 2x16x16) wait for the fake-rank
dry run (ROADMAP.md Queue 1).  Building a mesh touches no device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device

__all__ = ["Mesh", "make_host_mesh", "make_mesh"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``s, one axis
    per name in ``axis_names``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]


def _cards() -> list:
    resolve_device(None)             # raises without CUDA
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """Arbitrary mesh over ``devices`` (default: every card), row-major;
    the grid must hold exactly as many devices as there are."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    devs = _cards() if devices is None else [torch.device(d)
                                             for d in devices]
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} "
                         f"devices, got {len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(devices=grid.reshape(shape), axis_names=axes)


def make_host_mesh(device=None) -> Mesh:
    """Every card of this host as a 1-D ``("data",)`` mesh; with
    ``device="cpu"`` the CPU alone.  ``None`` means the cards and raises
    without CUDA, as every entry point does."""
    dev = resolve_device(device)
    devs = _cards() if dev.type == "cuda" else [dev]
    return make_mesh((len(devs),), ("data",), devs)
