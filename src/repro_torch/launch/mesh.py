"""Device meshes for the port: a named grid of devices or ranks.

The JAX package's meshes are ``jax.make_mesh`` objects.  Here a ``Mesh``
is what the rules read — the grid (``devices``, whose shape is the
mesh's) and its ``axis_names`` (``launch/sharding.default_rules``) — and,
for a mesh of process ranks, the ``DeviceMesh`` that DTensors are laid
out on (``device_mesh``).  ``make_mesh``/``make_host_mesh`` grid this
host's devices (``shard_device_slices`` places the sharded store's
shards on them) and carry no DeviceMesh.

``make_rank_mesh`` lays a grid over the ranks of the process group that
is up (a real one: one card a rank).  ``make_production_mesh`` builds
the reference's pods, 16x16 ``("data", "model")`` and 2x16x16 ``("pod",
"data", "model")``, over a FAKE process group of 512 ranks
(``fake_world``: torch's ``"fake"`` backend, whose collectives move
nothing), this process being rank 0 — the pod mesh is ranks 0-255, so
one process serves both.  It is the dry run's stand-in for the
reference's 512 fake CPU devices: ``launch/dryrun.py`` traces a step on
it under a ``FakeTensorMode``, and no card is touched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device

__all__ = ["FAKE_WORLD", "Mesh", "fake_world", "make_host_mesh",
           "make_mesh", "make_production_mesh", "make_rank_mesh"]

#: ranks of the fake process group the production meshes live in
FAKE_WORLD = 512


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy array, one axis per name in ``axis_names``, of
    ``torch.device``s (a host mesh) or of process ranks (a rank mesh,
    which also carries its ``DeviceMesh``)."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    device_mesh: Optional[object] = None


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


def make_rank_mesh(shape: Sequence[int], axes: Sequence[str],
                   device_type: str = "cuda") -> Mesh:
    """A mesh over ranks ``0 .. prod(shape) - 1`` of the process group
    that is up (``torch.distributed.init_process_group``), row-major,
    with its ``DeviceMesh`` of ``device_type`` ("cuda", or "cpu" for a
    gloo or fake group's CPU tensors)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    dm = DeviceMesh(device_type, torch.from_numpy(ranks),
                    mesh_dim_names=axes)
    return Mesh(devices=ranks, axis_names=axes, device_mesh=dm)


def fake_world(world_size: int = FAKE_WORLD) -> None:
    """Bring up torch's fake process group (``"fake"`` backend, a
    ``FakeStore``) at ``world_size`` ranks, this process rank 0, unless a
    process group is up already (then it must be at least that large).
    A process group lives as long as the process: tests run this in a
    process of their own."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is up; "
                f"the fake world needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """Single pod: 16x16 (data, model).  Multi-pod: 2x16x16 (pod, data,
    model) — the 'pod' axis is DP by default.  Over the fake world
    (``fake_world``, brought up here if need be); ``device_type`` is the
    devices the DTensors claim to be on ("cuda": the card's, traced
    under a ``FakeTensorMode``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    fake_world()
    return make_rank_mesh(shape, axes, device_type)
