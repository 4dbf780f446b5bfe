"""Step functions: train / prefill / decode, with MVStore commit semantics.

The train step is the store's update transaction: it differentiates the
loss at the live parameters and publishes the optimizer's result as the
next version, through one of three commits (``make_train_step``).  Every
serving step resolves the model parameters from the MVStore at a read
clock (``mv_snapshot``: versioned blocks through the ``snapshot_select``
kernel on the card, unversioned ones validated against their block
clock) and runs the model on that view.  Plain functions: the port runs
eagerly, so there is nothing to trace or compile, and the local mode is
read from ``mvcfg`` when the step is made.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, MVStoreConfig, \
    ParallelConfig
from repro_torch.core import mvstore
from repro_torch.core.mvstore import MVStoreState
from repro_torch.kernels import fused_adamw as FA
from repro_torch.launch.sharding import tree_leaves
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    mv: MVStoreState
    opt: adamw.AdamWState


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    mvcfg: MVStoreConfig, opt_cfg: adamw.AdamWConfig):
    """Returns ``train_step(state, batch) -> (state', metrics)``; ``batch``
    holds ``tokens`` and ``labels`` tensors on the parameters' device.

    Gradients come from ``torch.autograd.grad`` taken on detached views
    of the live blocks, so the store's tensors never carry autograd
    state; with ``pcfg.microbatches`` M > 1 they are accumulated in f32
    over M slices of the batch and divided by M, as the reference's scan.
    The commit is one of three, as in the reference:
      - fused (``mvcfg.fused_commit`` with rings): ``_fused_commit``, one
        ``fused_adamw`` launch per leaf;
      - ``adamw.apply`` then ``mvstore.mv_commit`` (the store enabled);
      - ``adamw.apply`` and the new live tree at clock + 1, every block
        stamped (no MVStore).
    ``metrics`` holds the loss (a 0-d tensor) and the new clock."""

    def loss_and_grads(leaves, paths, params, batch):
        view = mvstore._unflatten(params, dict(zip(paths, leaves)))
        loss = zoo.loss_fn(view, batch, cfg, pcfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state: TrainState, batch):
        params = state.mv.live
        flat = mvstore._flatten(params)
        paths = [p for p, _ in flat]
        leaves = [t.detach().requires_grad_() for _, t in flat]
        M = pcfg.microbatches
        if M == 1:
            loss, grads = loss_and_grads(leaves, paths, params, batch)
        else:
            acc = [torch.zeros(t.shape, dtype=torch.float32,
                               device=t.device) for t in leaves]
            losses = []
            for i in range(M):
                mb = {k: x.reshape((M, x.shape[0] // M) + x.shape[1:])[i]
                      for k, x in batch.items()}
                li, g = loss_and_grads(leaves, paths, params, mb)
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                losses.append(li)
            grads = [a.div_(M) for a in acc]
            loss = torch.mean(torch.stack(losses))
        grads = mvstore._unflatten(params, dict(zip(paths, grads)))
        if mvcfg.enabled and mvcfg.fused_commit and state.mv.ring:
            new_mv, new_opt = _fused_commit(state.mv, grads, state.opt,
                                            opt_cfg, mvcfg)
        else:
            new_params, new_opt = adamw.apply(grads, state.opt, params,
                                              opt_cfg)
            if mvcfg.enabled:
                new_mv = mvstore.mv_commit(state.mv, new_params,
                                           local_mode=mvcfg.mode, cfg=mvcfg)
            else:
                nc = state.mv.clock + 1
                bc = state.mv.block_clocks
                if bc is not None:   # whole-store step stamps every block
                    bc = {p: nc for p in bc}
                new_mv = state.mv._replace(live=new_params, clock=nc,
                                           block_clocks=bc)
        return TrainState(new_mv, new_opt), {"loss": loss,
                                             "clock": new_mv.clock}

    return train_step


def _fused_commit(mv: MVStoreState, grads, opt: adamw.AdamWState,
                  opt_cfg: adamw.AdamWConfig, mvcfg: MVStoreConfig):
    """AdamW and the versioned ring write of every leaf in one
    ``fused_adamw`` launch each; the semantics of ``adamw.apply`` then
    ``mv_commit``.  Returns ``(mv', opt')``.

    ``lr``, ``scale``, ``b1c`` and ``b2c`` go to the kernels as one f32
    [4] tensor computed on the device, so the step never reads the
    gradient norm back.  What is in place (module docstring of
    ``kernels/fused_adamw``): the moments; the ring slot ``clock' % R``,
    whose timestamp is set to ``NO_TS`` before the launch and stamped
    ``clock'`` after it, so a ``snapshot_select`` enqueued between the
    two on the one stream finds another slot or none (``ok=False``),
    never the old timestamp over new data.  ``p'`` is a new tensor: the
    old live block stays whole for a reader that holds it."""
    new_clock = mv.clock + 1
    slot = new_clock % mvcfg.ring_slots
    count = opt.count + 1
    scalars = torch.stack(adamw.step_scalars(grads, count, opt_cfg)).float()
    new_p = {}
    for (path, p), g, m, v in zip(mvstore._flatten(mv.live),
                                  tree_leaves(grads),
                                  tree_leaves(opt.mu),
                                  tree_leaves(opt.nu)):
        ring = mv.ring.get(path)
        if ring is not None:
            mv.ring_ts[path][slot] = mvstore.NO_TS
        new_p[path] = FA.fused_adamw(
            p, g, m, v, ring, slot, scalars, b1=opt_cfg.b1, b2=opt_cfg.b2,
            eps=opt_cfg.eps,
            wd=opt_cfg.weight_decay if p.dim() >= 2 else 0.0)
        if ring is not None:
            mv.ring_ts[path][slot] = new_clock
    bc = mv.block_clocks
    if bc is not None:                  # fused step stamps every block too
        bc = {p: new_clock for p in bc}
    new_mv = MVStoreState(mvstore._unflatten(mv.live, new_p), mv.ring,
                          mv.ring_ts, new_clock, bc)
    return new_mv, adamw.AdamWState(opt.mu, opt.nu, count)


# ---------------------------------------------------------------------------
# serve (prefill / decode) — versioned reads
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig,
                      mvcfg: MVStoreConfig):
    """prefill_step(mv_state, batch, read_clock) ->
    (logits, cache, cache_len, ok)."""
    def prefill_step(mv_state: MVStoreState, batch, read_clock):
        params, ok = _read_params(mv_state, read_clock, mvcfg)
        logits, cache, cache_len = zoo.prefill_fn(params, batch, cfg, pcfg)
        return logits, cache, cache_len, ok

    return prefill_step


def make_decode_step(cfg: ModelConfig, pcfg: ParallelConfig,
                     mvcfg: MVStoreConfig):
    """decode_step(mv_state, cache, cache_len, token, read_clock) ->
    (logits, cache, cache_len, ok); the cache is updated in place."""
    def decode_step(mv_state: MVStoreState, cache, cache_len, token,
                    read_clock):
        params, ok = _read_params(mv_state, read_clock, mvcfg)
        logits, cache, cache_len = zoo.decode_fn(
            params, cache, cache_len, token, cfg, pcfg)
        return logits, cache, cache_len, ok

    return decode_step


def _read_params(mv_state: MVStoreState, read_clock, mvcfg: MVStoreConfig):
    if not mvcfg.enabled:
        leaf = next(iter(mvstore._flatten(mv_state.live)))[1]
        return mv_state.live, torch.ones((), dtype=torch.bool,
                                         device=leaf.device)
    return mvstore.mv_snapshot(
        mv_state, read_clock,
        assume_versioned=mvcfg.mode in ("U", "UtoQ"))
