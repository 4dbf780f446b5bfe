"""Abstract parameters: one ``ParamMeta`` per weight, the single source of
its shape, logical axes, init rule and dtype.

The port's counterpart of the reference's ``launch/sharding.py`` for one
device: ``ParamMeta``, ``stack_meta`` and ``materialize``.  A model one
card holds whole needs no mesh, so the rule tables, ``shard_act`` and the
abstract (sharded) parameter trees are not here; ``axes`` is kept so
a meta tree reads the same in both packages.  The one function here that
reads a mesh is ``shard_device_slices``, the sharded store's placement.  Trees are nested dicts;
``leaves_with_path`` walks them in ``jax.tree_util`` order (sorted keys)
and spells each path as ``keystr`` does (``"['layers']['sub0']"``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A dtype named as the configs name it (``"bfloat16"``), or a torch
    dtype passed through."""
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


@dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axes, len == len(shape)
    init: str = "normal"                 # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` on every leaf of a nested dict (dict order kept); given more
    trees of the same structure, on their leaves side by side."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order (sorted keys)."""
    return [x for _, x in leaves_with_path(tree)]


def leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in ``jax.tree_util.tree_flatten_with_path`` order
    (sorted keys), paths spelled as ``keystr`` spells them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


#: the largest float32 draw ``materialize`` makes at once; a larger leaf
#: is drawn in slices of this size (moonshot-v1-16b-a3b's stacked expert
#: leaves are 35 GB as float32, 18 GB once cast)
DRAW_CAP_BYTES = 1 << 30


def materialize(meta_tree, generator: torch.Generator,
                device=None, dtype_override: Optional[str] = None):
    """A tree of ``ParamMeta`` as initialized tensors on ``device`` (the
    generator's device by default), drawn from ``generator`` leaf by leaf
    in path order: normal leaves are N(0, 1) in float32 scaled by
    ``scale / sqrt(fan_in)`` (fan_in = the second-last dim, else the
    last), then cast — the reference's rule; the values differ from the
    reference's, whose generator is JAX's.  A leaf is drawn into its
    final dtype in consecutive slices of its flattened leading axes, none
    above ``DRAW_CAP_BYTES`` as float32, so the transient stays bounded
    whatever the leaf's size."""
    device = torch.device(device if device is not None
                          else generator.device)
    step = max(1, DRAW_CAP_BYTES // 4)
    out = {}
    for path, m in leaves_with_path(meta_tree):
        dt = torch_dtype(dtype_override or m.dtype)
        if m.init == "zeros":
            a = torch.zeros(m.shape, dtype=dt, device=device)
        elif m.init == "ones":
            a = torch.ones(m.shape, dtype=dt, device=device)
        else:
            fan_in = m.shape[-2] if len(m.shape) >= 2 else m.shape[-1]
            std = m.scale / max(fan_in, 1) ** 0.5
            a = torch.empty(m.shape, dtype=dt, device=device)
            flat = a.view(-1)
            for lo in range(0, flat.numel(), step):
                n = min(step, flat.numel() - lo)
                flat[lo:lo + n] = torch.randn(
                    n, generator=generator, dtype=torch.float32,
                    device=device).mul_(std)
        out[path] = a
    return _rebuild(meta_tree, out)


def _rebuild(tree, leaves: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    return leaves[prefix]


def stack_meta(meta_tree, n: int, axis_name: Optional[str] = None):
    """Prepend a stacking dim (layers) to every ParamMeta in a tree."""
    return tree_map(lambda m: dataclasses.replace(
        m, shape=(n,) + m.shape, axes=(axis_name,) + m.axes), meta_tree)


def shard_device_slices(mesh, n_shards: int) -> list:
    """One device slice per store shard (``core/shardstore.py``).

    The sharded store partitions its heap at the ADDRESS level (spans
    round-robin over shards), so its unit of placement is a whole
    shard, not a tensor axis: shard ``s``'s handle is built on slice
    ``s``.  Slices round-robin over the mesh's devices in row-major
    order — with fewer shards than devices each shard owns a distinct
    device; with more, shards wrap (clock independence is preserved
    either way, placement is only locality)."""
    devs = list(np.asarray(mesh.devices).flat)
    return [devs[s % len(devs)] for s in range(n_shards)]
