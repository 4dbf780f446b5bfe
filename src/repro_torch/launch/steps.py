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

Sharded steps.  Given ``rules`` and a ``mesh`` (as the reference's
signatures take them), a step runs under ``sharding.use_rules`` on a
state of DTensors (``reshard_state``, or the dry run's
``train_state_specs`` made ``abstract``): the models' ``shard_act``
sites lay activations out, gradients and accumulators are kept in their
parameters' placements (``constrain``), and the kernels run on local
shards (``sharding.local_call``: ``fused_adamw`` here, ``commit_fused``
and ``snapshot_select`` in ``core/mvstore``).  Without rules a step runs
exactly as before.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, MVStoreConfig, \
    ParallelConfig, ShapeConfig
from repro_torch.core import mvstore
from repro_torch.core.mvstore import MVStoreState
from repro_torch.kernels import fused_adamw as FA
from repro_torch.launch.sharding import (Rules, TensorSpec, is_dtensor,
                                         leaves_with_path, local_call,
                                         param_specs, placements,
                                         torch_dtype, tree_leaves, use_rules)
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    mv: MVStoreState
    opt: adamw.AdamWState


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    mvcfg: MVStoreConfig, opt_cfg: adamw.AdamWConfig,
                    rules: Optional[Rules] = None, mesh=None):
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
    On every branch the moments are updated in place and the parameters
    published out of place (``adamw.apply`` does so, as the fused kernel
    does): torch donates nothing, and a step that kept the old moments
    beside the new could not fit qwen2.5-3b's Mode-Q step on one card
    while its caller holds the old state.
    ``metrics`` holds the loss (a 0-d tensor) and the new clock.

    With ``rules`` and ``mesh`` the step is sharded (module docstring):
    each gradient is laid out as its parameter (the reference's
    ``constrain``), and microbatch i is the i-th slice of every rank's
    batch rows."""
    specs = (dict(leaves_with_path(param_specs(zoo.model_meta(cfg),
                                                rules)))
             if rules is not None and mesh is not None else None)

    def constrain(path, g):
        """``g`` in its parameter's placements: DTensor would otherwise
        leave a gradient partial or replicated."""
        if specs is None or not is_dtensor(g):
            return g
        want = placements(specs[path], g.device_mesh)
        return g if tuple(g.placements) == want else \
            g.redistribute(g.device_mesh, want)

    def loss_and_grads(leaves, paths, params, batch):
        view = mvstore._unflatten(params, dict(zip(paths, leaves)))
        loss = zoo.loss_fn(view, batch, cfg, pcfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [constrain(p, g) for p, g in zip(paths, grads)]

    def microbatch(x, M, i):
        rows = x.shape[0] // M
        return local_call(
            lambda t: t.reshape((M, t.shape[0] // M) + t.shape[1:])[i],
            (x,), (("batch",) + (None,) * (x.dim() - 1),),
            ("batch",) + (None,) * (x.dim() - 1),
            (rows,) + tuple(x.shape[1:]))

    def train_step(state: TrainState, batch):
        with use_rules(rules, mesh):
            return run(state, batch)

    def run(state: TrainState, batch):
        params = state.mv.live
        flat = mvstore._flatten(params)
        paths = [p for p, _ in flat]
        leaves = [t.detach().requires_grad_() for _, t in flat]
        M = pcfg.microbatches
        if M == 1:
            loss, grads = loss_and_grads(leaves, paths, params, batch)
        else:
            acc = [torch.zeros_like(t, dtype=torch.float32)
                   for t in leaves]
            losses = []
            for i in range(M):
                mb = {k: microbatch(x, M, i) for k, x in batch.items()}
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
        wd = opt_cfg.weight_decay if p.dim() >= 2 else 0.0

        def step(p, g, m, v, ring, scalars, wd=wd):
            return FA.fused_adamw(p, g, m, v, ring, slot, scalars,
                                  b1=opt_cfg.b1, b2=opt_cfg.b2,
                                  eps=opt_cfg.eps, wd=wd)

        # sharded: each rank steps its shard of the leaf (and of its ring)
        pl = tuple(p.placements) if is_dtensor(p) else None
        new_p[path] = local_call(
            step, (p, g, m, v, ring, scalars),
            (pl, pl, pl, pl, mvstore.ring_placements(pl),
             mvstore.replicated(pl)), pl, tuple(p.shape))
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
                      mvcfg: MVStoreConfig, rules: Optional[Rules] = None,
                      mesh=None):
    """prefill_step(mv_state, batch, read_clock) ->
    (logits, cache, cache_len, ok); sharded under ``rules``/``mesh``."""
    def prefill_step(mv_state: MVStoreState, batch, read_clock):
        with use_rules(rules, mesh):
            params, ok = _read_params(mv_state, read_clock, mvcfg)
            logits, cache, cache_len = zoo.prefill_fn(params, batch, cfg,
                                                      pcfg)
            return logits, cache, cache_len, ok

    return prefill_step


def make_decode_step(cfg: ModelConfig, pcfg: ParallelConfig,
                     mvcfg: MVStoreConfig, rules: Optional[Rules] = None,
                     mesh=None):
    """decode_step(mv_state, cache, cache_len, token, read_clock) ->
    (logits, cache, cache_len, ok); the cache is updated in place;
    sharded under ``rules``/``mesh``."""
    def decode_step(mv_state: MVStoreState, cache, cache_len, token,
                    read_clock):
        with use_rules(rules, mesh):
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


# ---------------------------------------------------------------------------
# abstract states (the dry run)
# ---------------------------------------------------------------------------


def train_state_specs(cfg: ModelConfig, mvcfg: MVStoreConfig, rules: Rules,
                      mesh, opt_cfg: adamw.AdamWConfig) -> TrainState:
    """``TensorSpec``s of a ``TrainState`` under ``rules`` (``sharding.
    abstract`` makes them DTensors on ``mesh``): parameters and moments
    by their logical axes; in Mode U (and QtoU/UtoQ) a ring per leaf laid
    out as ``(None,) + leaf spec`` and its timestamps replicated; the
    clock and the block stamps host ints, the step count a replicated
    0-d int32."""
    leaves = list(leaves_with_path(zoo.model_meta(cfg)))
    mdt = opt_cfg.moment_dtype

    def tree(fn):
        return mvstore._unflatten(zoo.model_meta(cfg),
                                  {p: fn(m) for p, m in leaves})

    live = tree(lambda m: TensorSpec(m.shape, torch_dtype(m.dtype),
                                     rules.spec(m.axes)))
    mu = tree(lambda m: TensorSpec(m.shape, torch_dtype(mdt),
                                   rules.spec(m.axes)))
    nu = tree(lambda m: TensorSpec(m.shape, torch_dtype(mdt),
                                   rules.spec(m.axes)))
    ring, ring_ts = {}, {}
    if mvcfg.enabled and mvcfg.mode in ("U", "QtoU", "UtoQ"):
        for path, m in leaves:
            ring[path] = TensorSpec((mvcfg.ring_slots,) + tuple(m.shape),
                                    torch_dtype(m.dtype),
                                    (None,) + rules.spec(m.axes))
            ring_ts[path] = TensorSpec((mvcfg.ring_slots,), torch.int32,
                                       (None,))
    mv = MVStoreState(live=live, ring=ring, ring_ts=ring_ts, clock=0,
                      block_clocks={p: 0 for p, _ in leaves})
    opt = adamw.AdamWState(mu=mu, nu=nu,
                           count=TensorSpec((), torch.int32, ()))
    return TrainState(mv=mv, opt=opt)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, rules: Rules,
                mesh=None):
    """``TensorSpec``s of a cell's decode cache (bf16, as the reference's;
    a Mamba state f32), laid out by ``model_zoo.cache_axes``."""
    struct = zoo.init_cache(cfg, shape.global_batch, shape.seq_len,
                            torch.bfloat16, device="meta")

    def walk(s, a):
        if isinstance(s, dict):
            return {k: walk(s[k], a[k]) for k in s}
        return TensorSpec(tuple(s.shape), s.dtype, rules.spec(a))

    return walk(struct, zoo.cache_axes(cfg))
