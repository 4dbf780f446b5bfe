"""Snapshot-consistent asynchronous checkpointing via the MVStore.

This is the paper's long-running read as a first-class feature: a
checkpoint is a versioned read-only transaction.  The writer (trainer)
never pauses — the checkpointer resolves a consistent parameter view at
its read clock (``mv_snapshot``), copies it to the host and serializes
it in a background thread.  In Mode Q a hot trainer aborts the
unversioned read (clock advanced) and the checkpointer's retries
eventually flip the store to Mode U via the K-heuristics, exactly like
any other reader.

On-disk layout, the JAX package's:  <dir>/step_<n>/manifest.json +
<leaf-index>.npy files, leaves in ``jax.tree_util`` order and spelled as
``keystr`` spells them (``"['opt'].mu['embed']"``), bfloat16 leaves
stored as float32 ``.npy`` under their logical dtype.  A checkpoint
written by either package restores in the other.  Restore rebuilds the
TrainState (params + moments + step counter) and the data pipeline
resumes from the recorded step (bitwise-deterministic stream).
"""
from __future__ import annotations

import enum
import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mvstore
from repro_torch.reliability import faultpoints as FP


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in ``jax.tree_util.tree_flatten_with_path`` order
    with ``keystr`` spelling: dict keys sorted (``['k']``), NamedTuple
    fields in order (``.name``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    return [(prefix, tree)]


def _rebuild(tree, leaves: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves,
                                     f"{prefix}.{f}")
                            for f in tree._fields))
    return leaves[prefix]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def save_checkpoint(directory: str, step: int, state, *,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous write of a (already consistent) state tree whose
    leaves are tensors (any device) or numpy arrays."""
    d = os.path.join(directory, f"step_{step:08d}")
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (path, leaf) in enumerate(_flatten(state)):
        if isinstance(leaf, torch.Tensor):
            logical_dtype = str(leaf.dtype).replace("torch.", "")
            t = leaf.detach().cpu()
            arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        else:
            arr = np.asarray(leaf)
            logical_dtype = str(arr.dtype)
        if arr.dtype.kind == "V" or logical_dtype == "bfloat16":
            arr = arr.astype(np.float32)   # np.save can't hold bf16
        fn = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"path": path, "file": fn, "shape": list(arr.shape),
             "dtype": logical_dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if FP.ACTIVE is not None:
        # a crash here leaves only the .tmp directory — restore_checkpoint
        # skips it and recovery replays from the previous manifest
        FP.fire("pre_manifest_publish")
    os.replace(tmp, d)          # atomic publish (restart-crash safe)
    return d


def restore_checkpoint(directory: str, template) -> Tuple[int, Any, Dict]:
    """Latest checkpoint under ``directory`` restored into ``template``'s
    structure, each leaf with the template leaf's dtype and device.
    Returns (step, state, extra)."""
    steps = sorted(p for p in os.listdir(directory)
                   if p.startswith("step_") and not p.endswith(".tmp"))
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, steps[-1])
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    leaves = {}
    for path, leaf in _flatten(template):
        arr = np.load(os.path.join(d, by_path[path]["file"]))
        leaves[path] = (torch.from_numpy(arr).to(device=leaf.device,
                                                 dtype=leaf.dtype)
                        if isinstance(leaf, torch.Tensor) else arr)
    return manifest["step"], _rebuild(template, leaves), \
        manifest.get("extra", {})


class SubmitOutcome(enum.Enum):
    """Typed result of ``CheckpointManager.submit``.

    Truthiness keeps the bool contract (only SAVED is truthy), but
    callers can tell a snapshot-read conflict (ABORTED — retry next step,
    the reader's K-heuristics saw the abort) from a DROPPED snapshot
    (QUEUE_FULL — the serializer is behind; the read succeeded but
    nothing will reach disk)."""

    SAVED = "saved"
    QUEUE_FULL = "queue_full"
    ABORTED = "aborted"

    def __bool__(self) -> bool:
        return self is SubmitOutcome.SAVED


class CheckpointManager:
    """Async checkpointer: a snapshot-reader thread that serializes
    consistent views while training proceeds."""

    def __init__(self, directory: str, *, keep: int = 3,
                 reader=None):
        self.directory = directory
        self.keep = keep
        self.reader = reader          # optional mvcontroller.ReaderHandle
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._inflight = 0
        self._cv = threading.Condition()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self.saved = []
        self.errors = []
        self.dropped = 0

    def submit(self, step: int, mv_state: mvstore.MVStoreState, opt_state,
               *, extra=None) -> SubmitOutcome:
        """Take a consistent snapshot NOW (versioned read at the current
        clock), copy it to the host and enqueue serialization.

        ABORTED: the snapshot read conflicted (the caller may retry next
        step — the reader retry loop).  QUEUE_FULL: the snapshot was read
        consistently but DROPPED because the serializer is behind; the
        drop is counted in ``stats()`` and the reader records an abort,
        not a commit."""
        read_clock = int(mv_state.clock)
        if self.reader is not None:
            self.reader.begin(read_clock)
        view, ok = mvstore.mv_snapshot(mv_state, read_clock)
        n_reads = len(_flatten(view))
        if not bool(ok):
            if self.reader is not None:
                self.reader.on_abort(n_reads)
            return SubmitOutcome.ABORTED
        # on the host before the trainer overwrites the moments in place
        host_view = _rebuild(view, {p: _to_host(t)
                                    for p, t in _flatten(view)})
        host_opt = _rebuild(opt_state, {p: _to_host(t)
                                        for p, t in _flatten(opt_state)})
        with self._cv:
            try:
                self._q.put_nowait((step, host_view, host_opt, extra))
            except queue.Full:
                self.dropped += 1
                if self.reader is not None:
                    # the read was consistent but nothing durable came of
                    # it — an abort, as far as the heuristics go
                    self.reader.on_abort(n_reads)
                return SubmitOutcome.QUEUE_FULL
            self._inflight += 1
        # on_commit only after the snapshot is durably enqueued
        if self.reader is not None:
            self.reader.on_commit(n_reads, read_clock)
        return SubmitOutcome.SAVED

    def stats(self) -> Dict[str, Any]:
        return {"saved": len(self.saved), "dropped": self.dropped,
                "errors": len(self.errors), "inflight": self._inflight}

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, view, opt, extra = item
            try:
                save_checkpoint(self.directory, step,
                                {"params": view, "opt": opt}, extra=extra)
                self.saved.append(step)
                self._gc()
            except Exception as e:  # noqa: BLE001 — the worker must live
                self.errors.append(repr(e))
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _gc(self):
        steps = sorted(p for p in os.listdir(self.directory)
                       if p.startswith("step_")
                       and not p.endswith(".tmp"))
        for old in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, old),
                          ignore_errors=True)

    def wait_idle(self, timeout: float = 30.0):
        with self._cv:
            self._cv.wait_for(lambda: self._inflight == 0, timeout=timeout)

    def close(self):
        self.wait_idle()
        self._q.put(None)
        self._worker.join(timeout=5)
