"""Logical-axis sharding: one rule table maps model-code axis names to
mesh axes, and the abstract parameters (``ParamMeta``) every tree is
built from.

Model code never names a mesh axis: it marks weights (``ParamMeta.axes``)
and activations (``shard_act``) with *logical* axes ('batch', 'tp',
'fsdp', 'experts', 'vocab', 'kv_flat', 'seq_shard', ...), and ``Rules``
maps each to mesh axes, as the reference's ``launch/sharding.py`` does.
The dry run, the steps and ``runtime/elastic.reshard_state`` change a
layout by swapping rule tables, never by touching model code.

The torch counterpart of a ``NamedSharding`` is a DTensor: a spec (one
entry per tensor dim: None, a mesh axis or a tuple of them) becomes one
``Shard``/``Replicate`` placement per mesh dim (``placements``), on the
mesh's ``DeviceMesh`` (``launch/mesh.Mesh``).  Without rules, or on a
tensor that is not a DTensor, every function here leaves a tensor as it
is, so an unsharded step runs exactly as it did.  Where a hand-written
kernel is called on DTensors, ``local_call`` runs it through
``torch.distributed.tensor.experimental.local_map`` (the reference's
``shard_map``): the kernel sees each rank's local shards.

DTensor splits a dim as ``torch.chunk`` does, where JAX pads: rank 0
holds the largest piece, ``ceil(n / ways)``.  A mesh dim of size 1 gets
``Replicate`` whatever the spec says (the same layout, and no
collective to reach it).

Trees are nested dicts; ``leaves_with_path`` walks them in
``jax.tree_util`` order (sorted keys) and spells each path as ``keystr``
does (``"['layers']['sub0']"``).  ``shard_device_slices`` is the sharded
store's placement.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from dataclasses import dataclass
from typing import (Any, Callable, Iterator, NamedTuple, Optional, Sequence,
                    Tuple)

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


# ---------------------------------------------------------------------------
# Rule table
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rules:
    """Mapping from logical axis names to mesh axis names (or None)."""

    table: Tuple[Tuple[str, Any], ...] = ()

    def get(self, logical: Optional[str]):
        if logical is None:
            return None
        for k, v in self.table:
            if k == logical:
                return v
        return None

    def with_(self, **kw) -> "Rules":
        tbl = dict(self.table)
        tbl.update(kw)
        return Rules(tuple(tbl.items()))

    def spec(self, axes: Sequence[Optional[str]]) -> tuple:
        """The partition spec of ``axes``: one mesh axis, tuple of them or
        None per tensor dim — a ``PartitionSpec``'s entries, a tuple of
        one axis written as that axis, as ``PartitionSpec`` writes it."""
        out = []
        for a in axes:
            v = self.get(a)
            out.append(v[0] if isinstance(v, tuple) and len(v) == 1 else v)
        return tuple(out)


def default_rules(mesh, *, fsdp: bool = True,
                  shard_seq: bool = False) -> Rules:
    """DP(+pod) / FSDP over 'data', Megatron TP + EP over 'model'.

    ``shard_seq`` activates sequence sharding over 'data' for cells whose
    global batch is smaller than the data axis (long-context decode).
    """
    axes = mesh.axis_names
    batch: Any = tuple(a for a in ("pod", "data") if a in axes) or None
    data = "data" if "data" in axes else None
    model = "model" if "model" in axes else None
    table = {
        "batch": batch,
        "fsdp": data if fsdp else None,        # param/optimizer ZeRO-3 dim
        "tp": model,                           # Megatron column/row dim
        "experts": model,                      # expert parallelism
        "vocab": model,                        # embedding/LM-head vocab dim
        "kv_flat": model,                      # flattened kv*dh cache dim
        "seq_shard": data if shard_seq else None,  # SP for long decode
        "ring": None,                          # MVStore version-ring dim
        "heap_shard": data,                    # sharded-store shard dim
    }
    return Rules(tuple(table.items()))


# Current (rules, mesh), set by the steps around a step's run.
_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=(None, None))


@contextlib.contextmanager
def use_rules(rules: Optional[Rules], mesh=None):
    """Make ``(rules, mesh)`` current.  With rules, a plain tensor that
    meets a DTensor in an operation counts as replicated on its mesh
    (DTensor's ``implicit_replication``), as an unsharded array meets a
    sharded one under ``jit``."""
    tok = _RULES.set((rules, mesh))
    try:
        if rules is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _RULES.reset(tok)


def checkpoint_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute runs
    under the rules its forward ran under (the backward, and with it the
    recompute, may run on an autograd thread, which a context variable
    does not reach)."""
    return contextlib.nullcontext(), use_rules(*_RULES.get())


def current_rules() -> Optional[Rules]:
    return _RULES.get()[0]


def current_mesh():
    return _RULES.get()[1]


def device_mesh(mesh):
    """The ``DeviceMesh`` of a ``launch/mesh.Mesh`` (or a ``DeviceMesh``
    passed through)."""
    dm = getattr(mesh, "device_mesh", None)
    if dm is None and hasattr(mesh, "mesh_dim_names"):
        return mesh
    if dm is None:
        raise ValueError("this mesh has no DeviceMesh: build it with "
                         "launch.mesh.make_rank_mesh or "
                         "make_production_mesh")
    return dm


def _mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    if hasattr(mesh, "mesh_dim_names"):          # a DeviceMesh
        return tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    return tuple(mesh.axis_names), tuple(np.shape(mesh.devices))


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a partition spec on ``mesh`` (a ``Mesh`` or
    a ``DeviceMesh``): ``Shard(d)`` on every mesh dim that tensor dim
    ``d``'s entry names (a tuple such as ``("pod", "data")`` shards one
    dim over both, pod before data, as the mesh orders them), and
    ``Replicate`` on the rest and on every mesh dim of size 1."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = _mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(ax)
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_act(x, axes: Sequence[Optional[str]]):
    """Lay an activation out as its logical axes say: ``x`` redistributed
    to the rules' placements.  ``x`` as it is without rules or when it
    is not a DTensor."""
    rules = _RULES.get()[0]
    if rules is None or not is_dtensor(x):
        return x
    target = placements(rules.spec(axes), x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def local_call(fn: Callable, args: Sequence, in_axes: Sequence, out_axes,
               out_shapes):
    """``fn(*args)`` on each rank's local shards when an argument is a
    DTensor — the reference's ``shard_map``, as
    ``torch.distributed.tensor.experimental.local_map`` does it, but with
    the outputs' global shapes given (``out_shapes``), so that an uneven
    split (rank 0 holding ``ceil(n / ways)``) comes back at its true
    size.

    ``in_axes`` holds one logical-axes tuple per argument: a DTensor
    argument is redistributed to the current rules' placements of it
    first, a plain tensor given axes counts as replicated and is cut to
    them, and any other argument (or one given ``None``) goes in as it
    is.  ``out_axes`` and ``out_shapes`` hold one tuple each for one
    output, or a list of them for a tuple of outputs.  An axes entry
    that holds ``Placement``s is taken as it is (``Partial`` for a local
    sum).  The local call is
    differentiable through ``to_local``/``from_local``: an input
    replicated over a mesh dim that shards another input gets its
    gradient back as ``Partial`` there (each rank's call saw its own
    piece of the work, so the pieces sum).  With no DTensor argument it
    is ``fn(*args)``; with no rules current, logical axes map to no mesh
    axis (every piece whole)."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    rules = _RULES.get()[0] or Rules()
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    from torch.distributed.tensor import (DTensor, Partial, Placement,
                                          Replicate, Shard)

    dm = dts[0].device_mesh

    def pl(axes):
        if axes and all(isinstance(a, Placement) for a in axes):
            return tuple(axes)
        return placements(rules.spec(axes), dm)

    args = [DTensor.from_local(x, dm, (Replicate(),) * dm.ndim,
                               run_check=False)
            if a is not None and isinstance(x, torch.Tensor)
            and not is_dtensor(x) else x for x, a in zip(args, in_axes)]
    wants = [pl(a) if is_dtensor(x) else None
             for x, a in zip(args, in_axes)]
    varying = {i for w in wants if w for i, p in enumerate(w)
               if isinstance(p, Shard)}
    local = []
    for x, want in zip(args, wants):
        if want is not None:
            if tuple(x.placements) != want:
                x = x.redistribute(dm, want)
            grad_pl = tuple(Partial() if i in varying and
                            isinstance(p, Replicate) else p
                            for i, p in enumerate(want))
            x = x.to_local(grad_placements=grad_pl)
            if isinstance(x, AsyncCollectiveTensor):
                x = x.wait()
        local.append(x)
    out = fn(*local)

    def wrap(t, axes, shape):
        if not isinstance(t, torch.Tensor):
            return t
        shape = torch.Size(shape)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t, dm, pl(axes), run_check=False,
                                  shape=shape, stride=stride)

    if isinstance(out_axes, list):
        return tuple(wrap(t, a, s) for t, a, s in zip(out, out_axes,
                                                      out_shapes))
    return wrap(out, out_axes, out_shapes)


def split_heads(t, n: int, d: int):
    """``t`` [..., n*d] as [..., n, d].  A DTensor whose flat last dim is
    split over more ways than it has heads (qwen2.5-3b's 2 kv heads over
    16) is cut inside a head: it is gathered whole on those mesh dims
    first, and that gather is what the layout costs."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = t.dim() - 1
        pl = list(t.placements)
        ways = 1
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == last:
                ways *= t.device_mesh.shape[i]
        if n % ways:
            t = t.redistribute(t.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == last else p
                for p in pl])
    return t.reshape(tuple(t.shape[:-1]) + (n, d))


def local_range(t, dim: int = 0) -> Tuple[int, int]:
    """``(offset, size)`` of this rank's piece of dim ``dim`` of DTensor
    ``t`` (``torch.chunk``'s split, mesh dim by mesh dim)."""
    from torch.distributed.tensor import Shard
    dm = t.device_mesh
    dim = dim % t.dim()
    coord = dm.get_coordinate() or [0] * dm.ndim
    off, size = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // dm.shape[i])
            off += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return off, size


def mesh_coordinate(dm, axis) -> int:
    """This rank's index along ``axis`` (a mesh axis name, a tuple of
    them taken major to minor, or None for 0) of DeviceMesh ``dm``."""
    if axis is None:
        return 0
    names = tuple(dm.mesh_dim_names)
    coord = dm.get_coordinate() or [0] * len(names)
    out = 0
    for ax in (axis if isinstance(axis, tuple) else (axis,)):
        i = names.index(ax)
        out = out * dm.shape[i] + coord[i]
    return out


def mesh_ways(dm, axis) -> int:
    """How many ways ``axis`` (a name, a tuple of names or None) splits a
    dim on DeviceMesh ``dm``."""
    if axis is None:
        return 1
    names = tuple(dm.mesh_dim_names)
    n = 1
    for ax in (axis if isinstance(axis, tuple) else (axis,)):
        n *= dm.shape[names.index(ax)]
    return n


# ---------------------------------------------------------------------------
# Abstract parameters: shape + sharding, no values (the dry run's).
# ---------------------------------------------------------------------------


class TensorSpec(NamedTuple):
    """A tensor's global shape, dtype and partition spec, no values: the
    counterpart of a ``jax.ShapeDtypeStruct`` with a sharding
    (``abstract`` makes the DTensor)."""
    shape: Tuple[int, ...]
    dtype: Any
    spec: tuple


def abstract(tree, mesh, device=None):
    """Every ``TensorSpec`` in ``tree`` (nested dicts, tuples and named
    tuples) as an ``abstract_tensor`` on ``mesh``; other leaves as they
    are."""
    if isinstance(tree, TensorSpec):
        return abstract_tensor(tree.shape, tree.dtype, tree.spec, mesh,
                               device)
    if isinstance(tree, dict):
        return {k: abstract(v, mesh, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(abstract(v, mesh, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(abstract(v, mesh, device) for v in tree)
    return tree


def param_specs(meta_tree, rules: Rules):
    """Partition-spec tree matching a ParamMeta tree."""
    return tree_map(lambda m: rules.spec(m.axes), meta_tree)


def abstract_tensor(shape, dtype, spec, mesh, device=None):
    """An uninitialized DTensor of global ``shape`` laid out by ``spec``
    on ``mesh``: each rank's local piece made with ``torch.empty`` on
    ``device`` (the mesh's device type by default; ``"meta"`` for no
    storage), so under a ``FakeTensorMode`` nothing is allocated."""
    from torch.distributed.tensor import DTensor

    dm = device_mesh(mesh)
    pl = placements(spec, dm)
    local = local_shape(shape, pl, dm)
    t = torch.empty(local, dtype=torch_dtype(dtype),
                    device=device or dm.device_type)
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(t, dm, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def local_shape(shape, pls, dm) -> Tuple[int, ...]:
    """This rank's piece of global ``shape`` under placements ``pls``:
    each sharded dim split as ``torch.chunk`` splits it, mesh dim by mesh
    dim (``ceil(n / ways)`` on rank 0)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    coord = dm.get_coordinate() or [0] * dm.ndim
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            n, w = out[p.dim], dm.shape[i]
            chunk = -(-n // w)
            out[p.dim] = max(0, min(chunk, n - coord[i] * chunk))
    return tuple(out)


def abstract_params(meta_tree, rules: Rules, mesh,
                    dtype_override: Optional[str] = None, device=None):
    """DTensors (no values) for a ParamMeta tree, each laid out by its
    spec — the dry run's parameters (``abstract_tensor``)."""
    return tree_map(lambda m: abstract_tensor(
        m.shape, dtype_override or m.dtype, rules.spec(m.axes), mesh,
        device), meta_tree)


__all__ = [
    "DRAW_CAP_BYTES", "ParamMeta", "Rules", "TensorSpec", "abstract",
    "abstract_params", "abstract_tensor", "checkpoint_contexts",
    "current_mesh", "current_rules", "default_rules", "device_mesh",
    "is_dtensor", "leaves_with_path", "local_call", "local_range",
    "local_shape", "materialize", "mesh_coordinate", "mesh_ways",
    "param_specs", "placements", "shard_act", "shard_device_slices",
    "split_heads", "stack_meta", "torch_dtype", "tree_leaves", "tree_map",
    "use_rules",
]
