"""End-to-end training driver.

Wires together: config registry -> MVStore (+ controller) -> step
variants (one per local mode, the step as the store's update
transaction) -> data pipeline -> fault-tolerant supervisor with
snapshot-consistent checkpoints.  Runs on the card unless told
otherwise; the CPU runs the reduced config:

    python -m repro_torch.launch.train --arch qwen2.5-3b --mv-mode U \\
        --seq 512 --batch 4 --steps 20
    python -m repro_torch.launch.train --smoke --device cpu --steps 40

The MVStore mode cycle is live, as in the reference: snapshot readers
(the checkpointer) announce aborts, the controller flips Q -> QtoU -> U
when they starve and back when they drain, and the trainer picks the
step variant of its local mode at every step boundary.  Where the port
differs: torch runs eagerly, so a "variant" is a step function made for
a local mode, not a compiled program, and nothing is donated.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs import (ARCH_IDS, MVStoreConfig, ParallelConfig,
                                 ShapeConfig, get_config, smoke_config)
from repro_torch.core import mvcontroller, mvstore
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw
from repro_torch.runtime import spans
from repro_torch.runtime.fault_tolerance import FaultPlan, TrainSupervisor


class Trainer:
    """Owns the MVStore state and the step variants, on ``device`` (the
    card unless the caller names another; no card raises).  ``params``
    (a numpy tree, e.g. the JAX package's parameters through
    ``np.asarray`` per leaf) replaces the random initialisation from
    ``seed``."""

    def __init__(self, cfg, shape, *, pcfg=None, mvcfg=None, opt_cfg=None,
                 seed: int = 0, controller=None, params=None, device=None):
        self.cfg = cfg
        self.shape = shape
        self.device = resolve_device(device)
        self.pcfg = pcfg or ParallelConfig(
            attn_block_q=min(1024, shape.seq_len),
            attn_block_k=min(1024, shape.seq_len))
        self.mvcfg = mvcfg or MVStoreConfig()
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(warmup_steps=10)
        self.controller = controller or mvcontroller.MVController(
            mvcfg=self.mvcfg, start_bg=True)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = zoo.init_params(cfg, gen)
        else:
            params = zoo.params_from_numpy(params, self.device)
        versioned = "all" if self.mvcfg.mode in ("U", "QtoU", "UtoQ") \
            else "none"
        mv = mvstore.mv_init(params, self.mvcfg, versioned=versioned)
        opt = adamw.init(params, self.opt_cfg)
        self.state = steps_mod.TrainState(mv=mv, opt=opt)
        self._variants: Dict[str, Callable] = {}
        self.step_times = []

    # -- step variants (the local mode fixed when a step is made) --------
    def _variant(self, local_mode: str) -> Callable:
        if local_mode not in self._variants:
            mvcfg = self.mvcfg.replace(mode=local_mode)
            self._variants[local_mode] = steps_mod.make_train_step(
                self.cfg, self.pcfg, mvcfg, self.opt_cfg)
        return self._variants[local_mode]

    def train_step(self, state, batch):
        """One step at the controller's local mode; ``batch`` is a dict
        of numpy arrays (``batch_at``).  The step is enqueued, not
        waited for: ``step_times`` records the host's time to issue it,
        as the reference records its asynchronous dispatch."""
        state = state._replace(mv=self.controller.trainer_tick(state.mv))
        fn = self._variant(self.controller.current_local_mode())
        batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in batch.items()}
        t0 = time.time()
        with spans.span("train.step"):
            state, metrics = fn(state, batch)
        self.step_times.append(time.time() - t0)
        return state, metrics

    def batch_at(self, step: int):
        it = make_batch_iterator(self.cfg, self.shape, start_step=step)
        return next(it)

    def snapshot_reader(self):
        return self.controller.reader()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a seeded model into the MVStore.")
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mv-mode", default="Q", choices=["Q", "U"])
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("train_cli", args.seq, args.batch, "train")
    trainer = Trainer(cfg, shape, mvcfg=MVStoreConfig(mode=args.mv_mode),
                      device=args.device)
    sup = TrainSupervisor(ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          reader=trainer.snapshot_reader())
    fault = FaultPlan(fail_at_steps=(args.inject_failure_at,)) \
        if args.inject_failure_at >= 0 else None

    losses = []

    def on_step(step, state, metrics):
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 10 == 0 or step == 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"mode {trainer.controller.current_local_mode()} "
                  f"rings {len(state.mv.ring)}", flush=True)

    try:
        step, state = sup.run(state=trainer.state,
                              train_step=trainer.train_step,
                              batch_at=trainer.batch_at,
                              n_steps=args.steps, fault_plan=fault,
                              on_step=on_step)
    finally:
        trainer.controller.stop()
        sup.manager.close()
    print(f"done on {trainer.device}: {step} steps, "
          f"restarts={sup.restarts}, first loss {losses[0]:.4f} "
          f"last {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
