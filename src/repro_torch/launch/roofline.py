"""Roofline terms of one step on the H100, from a counted eager step.

Hardware model (one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit):
  peak bf16 (tensor cores)      989 TFLOP/s
  peak f32 (off the cores)       67 TFLOP/s
  HBM3 bandwidth               3.35 TB/s
  NVLink 4                      900 GB/s a GPU, both directions of its
                                18 links together: 450 GB/s each way

The reference reads per-device flops and bytes from XLA's
``cost_analysis()`` of a compiled step and parses its HLO for the
collectives.  The port runs eagerly, so ``count()`` is the counterpart:
a ``TorchDispatchMode`` that tallies, for every operation dispatched on
the counted device while it is active, the flops ``FlopCounterMode``
would (its formulas, its decompositions), the bytes the operation reads
and writes, and each ``c10d`` collective with its result bytes and
group size.  The hand-written kernels are ``ctypes`` calls that no
dispatch mode sees: each kernel wrapper adds its own formula instead
(``kernels/_lib.counted``), on both routes, with dispatch counting
suspended inside it, so the CPU (plain versions) and the card (the
kernels) count the same numbers for the same step.

Per rank.  Under a sharded step the operands are DTensors: ``count()``
declines every operation that holds one (``NotImplemented``), so DTensor
dispatches it, and what is counted is what DTensor runs on this rank —
its local operations, at their local shapes, and the functional
collectives (``_c10d_functional``) its redistributions issue.  So a
count is this rank's, as the reference's cost analysis is per device.
The global-shape operations DTensor runs under a fake mode only to
learn an output's shape are not counted (``_hide_shape_propagation``).
``count(memory=True)`` also tracks the bytes of the storages alive
(each once, however many views) and keeps their peak: under a
``FakeTensorMode`` the dry run's per-rank peak.

Collective wire bytes use the reference's ring factors (all-reduce
moves 2(n-1)/n of the tensor, all-gather (n-1)/n of the full result,
reduce-scatter n-1 times its 1/n result, all-to-all (n-1)/n, a
point-to-point send 1x).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import weakref
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _lib

#: peak FLOP/s of one H100 SXM by operand dtype (data sheet, dense)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12         # B/s, one H100 SXM's HBM3
#: B/s one way over NVLink 4: 900 GB/s a GPU is both directions of its
#: 18 links (NVIDIA H100 data sheet); a ring step sends one way
NVLINK_BW = 450e9

#: ``c10d`` operation -> the reference's collective kind.  A point-to-
#: point transfer counts once, at its ``send`` (the receiver's ``recv_``
#: is the same bytes on the same link).
_C10D_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    # functional collectives (DTensor's): ``_c10d_functional`` ops
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_WIRE_FACTOR = {
    # multiplier applied to the op's RESULT bytes to estimate per-device
    # wire traffic, assuming ring algorithms over a group of size n
    "all-reduce": lambda n: 2.0 * (n - 1) / max(n, 1),
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: float(n - 1),   # result is 1/n of operand
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}
#: products whose result shape ``attention_score_bytes`` matches
_PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
             torch.ops.aten.baddbmm}
#: tensor-metadata queries, never counted (``FlopCounterMode`` skips them)
_METADATA = {torch.ops.prim.device.default, torch.ops.prim.layout.default}
#: operations that move no bytes though their schema marks no alias:
#: allocations (the result is not written) and ``_unsafe_view`` (a view
#: of a fresh tensor)
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
               torch.ops.aten._unsafe_view}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Record:
    """What one ``count()`` saw on its device.

    ``flops``/``bytes``: the totals, operations and kernels together;
    ``by_op``: operation (or ``kernel:<name>``) -> [calls, flops, bytes];
    ``products``: (rows, cols) of a matrix product's result -> its bytes
    (``attention_score_bytes`` reads it); ``collectives``: one dict per
    ``c10d`` collective (kind, result bytes, group size, type)."""

    def __init__(self, device: str):
        self.device = device
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, List[int]] = defaultdict(lambda: [0, 0, 0])
        self.products: Dict[tuple, int] = defaultdict(int)
        self.collectives: List[dict] = []
        #: bytes of the storages alive now and at most (``memory=True``)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._lock = threading.Lock()

    def add(self, name: str, flops: int, nbytes: int) -> None:
        with self._lock:
            self.flops += flops
            self.bytes += nbytes
            row = self.by_op[name]
            row[0] += 1
            row[1] += flops
            row[2] += nbytes

    @property
    def kernels(self) -> Dict[str, List[int]]:
        """kernel -> [calls, flops, bytes] added by the kernel wrappers."""
        return {k[len("kernel:"):]: v for k, v in self.by_op.items()
                if k.startswith("kernel:")}

    def cost(self) -> Dict[str, float]:
        """The totals under ``cost_analysis()``'s keys (``roofline_terms``
        takes either)."""
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes)}

    def summary(self) -> dict:
        return {"device": self.device, "flops": self.flops,
                "bytes": self.bytes, "kernels": self.kernels,
                "collectives": len(self.collectives),
                "peak_bytes": self.peak_bytes}


class _CountMode(TorchDispatchMode):
    """The dispatch mode behind ``count()``; the kernel wrappers find it
    on the thread's mode stack (``kernels/_lib.counted``)."""

    def __init__(self, record: Record, memory: bool = False):
        super().__init__()
        self.record = record
        self._tls = threading.local()
        self.memory = memory
        self._live: Dict[int, int] = {}      # storage -> bytes

    @property
    def suspended(self) -> bool:
        return getattr(self._tls, "depth", 0) > 0

    @contextlib.contextmanager
    def suspend(self) -> Iterator[None]:
        self._tls.depth = getattr(self._tls, "depth", 0) + 1
        try:
            yield
        finally:
            self._tls.depth -= 1

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        self.record.add(f"kernel:{name}", int(flops), int(nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.suspended or func in _METADATA:
            return func(*args, **kwargs)
        if _DTENSOR and any(issubclass(t, _DTENSOR[0]) for t in types):
            return NotImplemented     # DTensor runs it: count its locals
        ns = func.namespace
        if ns == "c10d" or ns == "_c10d_functional":
            out = func(*args, **kwargs)
            self._collective(func, args, out)
            if self.memory:
                self._track(args, out)
            return out
        # as FlopCounterMode: an operation that decomposes is counted by
        # its parts
        with self:
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        if self.memory:
            self._track((args, kwargs), out)
        return out

    def _track(self, args, out) -> None:
        """Register the storages of the tensors an operation read or made
        that are not yet known, each with a finalizer that takes its
        bytes off when its last reference (a view, a tensor autograd
        saved) is gone; keep the peak."""
        rec = self.record
        for t in tree_flatten((args, out))[0]:
            if not isinstance(t, torch.Tensor) or \
                    t.device.type != rec.device:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            with rec._lock:
                self._live[key] = n
                rec.live_bytes += n
                if rec.live_bytes > rec.peak_bytes:
                    rec.peak_bytes = rec.live_bytes
            weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        with self.record._lock:
            if self._live.pop(key, None) is not None:
                self.record.live_bytes -= n

    def _count(self, func, args, kwargs, out) -> None:
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        dev = self.record.device
        on_dev = False
        for t in ins + outs:
            kind = t.device.type
            if kind == dev:
                on_dev = True
            elif not (kind == "cpu" and t.dim() == 0):
                return       # a copy between devices, or another device's op
        if not on_dev:
            return
        packet = func._overloadpacket
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0
        nbytes = 0 if packet in _NO_TRAFFIC or _is_view(func) else \
            sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.record.add(str(packet), flops, nbytes)
        if packet in _PRODUCTS and len(outs) == 1 and outs[0].dim() >= 2:
            with self.record._lock:
                self.record.products[tuple(outs[0].shape[-2:])] += \
                    _nbytes(outs[0])

    def _collective(self, func, args, out) -> None:
        name = func._overloadpacket.__name__
        kind = _C10D_KIND.get(name)
        if kind is None:
            return
        group = None
        if func.namespace == "_c10d_functional":
            # (input, [reduce op,] group size, group name): the result is
            # the output
            res = [t for t in tree_flatten(out)[0]
                   if isinstance(t, torch.Tensor)]
            group = _functional_group_size(name, args)
        else:
            # the first argument holds the results (the in-place tensors,
            # the gathered or scattered outputs, the tensors sent)
            res = [t for t in tree_flatten(args[0])[0]
                   if isinstance(t, torch.Tensor)]
            for a in args:
                if isinstance(a, torch.ScriptObject):
                    group = torch.distributed.ProcessGroup.unbox(a).size()
                    break
        with self.record._lock:
            self.record.collectives.append({
                "kind": kind, "op": name,
                "result_bytes": sum(_nbytes(t) for t in res),
                "group": group,
                "type": ", ".join(f"{str(t.dtype)[6:]}{list(t.shape)}"
                                  for t in res)})


def _functional_group_size(name: str, args) -> Optional[int]:
    """The group size of a functional collective: an argument of the
    gather/scatter ops, the named group's size for the others."""
    for a in args[1:]:
        if isinstance(a, int) and not isinstance(a, bool):
            return a
    for a in args[1:]:
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                return _resolve_process_group(a).size()
            except (ImportError, RuntimeError, ValueError):
                return None
    return None


#: [DTensor], set once ``torch.distributed.tensor`` has been imported
_DTENSOR: list = []


def _hide_shape_propagation() -> None:
    """DTensor learns an output's global shape by running the operation
    on fake global-shape tensors (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``); wrap that once so that every
    open ``count()`` is suspended inside it — those operations are not
    this rank's work, nor its memory."""
    import sys
    if _DTENSOR or "torch.distributed.tensor" not in sys.modules:
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    fn = ShardingPropagator._propagate_tensor_meta_non_cached

    @functools.wraps(fn)
    def hidden(self, op_schema):
        with contextlib.ExitStack() as stack:
            for mode in list(_lib.COUNTERS):
                stack.enter_context(mode.suspend())
            return fn(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = hidden
    _DTENSOR.append(DTensor)


_VIEWS: Dict[object, bool] = {}


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias it does not write (a view: no
    bytes move)."""
    v = _VIEWS.get(func)
    if v is None:
        v = _VIEWS[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return v


@contextlib.contextmanager
def count(device: Optional[str] = None,
          memory: bool = False) -> Iterator[Record]:
    """Count what runs on ``device`` ("cuda" unless the caller names
    another, e.g. ``count(device="cpu")`` for a step on the CPU) while
    the context is open, in this thread and in the autograd threads its
    backward runs on; yields the ``Record``.

    An operation counts when its tensors lie on ``device`` (0-d CPU
    tensors, PyTorch's wrapped scalars, may ride along); a copy between
    devices does not.  Bytes are every operand read plus every result
    written (a view moves none).  Operations on DTensors are counted as
    this rank runs them (module docstring).  With ``memory``, the
    record's ``peak_bytes`` is the largest sum of live storages on
    ``device`` this count saw (those made before it count from their
    first use).  Counting adds host time to every operation: keep it
    out of timed windows."""
    _hide_shape_propagation()
    rec = Record(torch.device(device or "cuda").type)
    mode = _CountMode(rec, memory)
    _lib.COUNTERS.append(mode)
    try:
        with mode:
            yield rec
    finally:
        _lib.COUNTERS.remove(mode)


def collective_bytes(record: Record, default_group: int = 1,
                     top_k: int = 8) -> Dict:
    """Per-kind result bytes and wire bytes of the collectives a
    ``count()`` saw, plus the top-K largest (type + group), in the
    reference's output format.  A collective whose group size was not
    recorded takes ``default_group``."""
    ops: Dict[str, Dict[str, float]] = {}
    total_wire = 0.0
    total_res = 0
    top = []
    for c in record.collectives:
        kind, nbytes = c["kind"], c["result_bytes"]
        n = c["group"] or default_group
        wire = nbytes * _WIRE_FACTOR[kind](n)
        d = ops.setdefault(kind, {"count": 0, "result_bytes": 0,
                                  "wire_bytes": 0.0})
        d["count"] += 1
        d["result_bytes"] += nbytes
        d["wire_bytes"] += wire
        total_wire += wire
        total_res += nbytes
        top.append((wire, kind, c["type"][:120], n))
    top.sort(reverse=True)
    return {"total_result_bytes": total_res,
            "total_wire_bytes": total_wire, "ops": ops,
            "top": [{"wire_bytes": w, "kind": k, "type": t, "group": n}
                    for w, k, t, n in top[:top_k]]}


def hbm_bytes_model(record: Record) -> Dict:
    """HBM bytes of a counted step: ``count()``'s eager bytes as they
    stand.  The reference models TPU-grade fusion on the HLO's dataflow
    edges (``tpu_bytes_model``); torch runs unfused, one kernel an
    operation, so every result reaches HBM and every operand is read
    from it, and the hand-written kernels add the bytes their bounds
    count."""
    return {"hbm_bytes": float(record.bytes)}


def attention_score_bytes(record: Record, block_q: int = 1024,
                          block_k: int = 1024) -> float:
    """HBM bytes of the score-shaped ``[..., block_q, block_k]`` (or
    transposed) products a counted step materialized: the plain
    attention route's scores and, in its backward, ``dP`` (the
    reference's shape rule).  Each is written once and read once by its
    consumer, so twice its bytes.  ``flash_attention`` keeps its scores
    on chip and adds none."""
    shapes = {(block_q, block_k), (block_k, block_q)}
    return 2.0 * sum(b for s, b in record.products.items() if s in shapes)


def roofline_terms(cfg, shape, *, cost: Dict, collectives: Dict,
                   n_chips: int, dtype: str = "bfloat16") -> Dict:
    """The three terms (seconds) + MODEL_FLOPS ratio for one cell, at the
    H100's peak for ``dtype``; ``cost`` as ``Record.cost()`` (or
    ``cost_analysis()``) gives it, per device."""
    from repro_torch.models.model_zoo import model_flops

    peak = PEAK_FLOPS[dtype]
    flops_dev = float(cost.get("flops") or 0.0)
    bytes_dev = float(cost.get("bytes accessed") or 0.0)
    wire_dev = float(collectives.get("total_wire_bytes") or 0.0)
    t_compute = flops_dev / peak
    t_memory = bytes_dev / HBM_BW
    # collective_bytes / (chips * link_bw), with collective_bytes global
    # = per-device wire * chips -> per-device wire / link_bw
    t_coll = wire_dev / NVLINK_BW
    mf = model_flops(cfg, shape)
    hlo_global = flops_dev * n_chips
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    total = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_flops_ratio": (mf / hlo_global) if hlo_global else 0.0,
        "roofline_fraction": (
            (mf / (n_chips * peak)) / total if total else 0.0),
    }


__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS", "Record",
           "attention_score_bytes", "collective_bytes", "count",
           "hbm_bytes_model", "roofline_terms"]
