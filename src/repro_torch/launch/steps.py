"""Step functions of the server: prefill / decode, each a versioned read.

Every step resolves the model parameters from the MVStore at a read
clock (``mv_snapshot``: versioned blocks through the ``snapshot_select``
kernel on the card, unversioned ones validated against their block
clock) and runs the model on that view.  Plain functions: the port runs
eagerly, so there is nothing to trace or compile.  The train step and
its fused commit come with training.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, MVStoreConfig, \
    ParallelConfig
from repro_torch.core import mvstore
from repro_torch.core.mvstore import MVStoreState
from repro_torch.models import model_zoo as zoo


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
