"""Decoder-only LM: stacked layer groups, prefill and decode.

Layers are stacked in *groups* of one interleave period, as in the
reference (period 1 for a uniform arch: group g is layer g; 8 for
jamba's 1:7 attention:mamba interleave with MoE every second layer), so
a parameter tree and a cache tree read the same in both packages: every
leaf under ``layers`` leads with the group axis.  The reference scans the
groups (``lax.scan``); here a Python loop walks them.  Training
(``lm_loss``) recomputes each group in its backward unless ``pcfg.remat``
is ``"none"`` (the reference's ``jax.checkpoint`` of the group body),
through ``torch.utils.checkpoint``; ``"group:k"`` also checkpoints each
run of k consecutive groups around that, keeping one residual per run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.sharding import (ParamMeta, checkpoint_contexts,
                                         local_call, shard_act, stack_meta,
                                         torch_dtype, tree_map)
from repro_torch.models import blocks
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.common import (matmul, rmsnorm, rmsnorm_meta,
                                       softmax_xent)

VOCAB_PAD_MULTIPLE = 256


def layer_period(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 1
    p = 1
    if cfg.attn_layer_period:
        p = cfg.attn_layer_period
    if cfg.moe.num_experts:
        p = math.lcm(p, cfg.moe.every_n_layers)
    return p


def layer_kinds(cfg: ModelConfig):
    """[(mixer, ffn)] for each sub-layer of one period."""
    kinds = []
    for i in range(layer_period(cfg)):
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
        if cfg.is_moe_layer(i):
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "dense"
        else:
            ffn = "none"
        kinds.append((mixer, ffn))
    return kinds


def n_groups(cfg: ModelConfig) -> int:
    p = layer_period(cfg)
    assert cfg.n_layers % p == 0, (cfg.n_layers, p)
    return cfg.n_layers // p


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def lm_meta(cfg: ModelConfig) -> dict:
    vpad = cfg.padded_vocab(VOCAB_PAD_MULTIPLE)
    group = {f"sub{j}": blocks.sublayer_meta(cfg, kind)
             for j, kind in enumerate(layer_kinds(cfg))}
    meta = {
        "embed": ParamMeta((vpad, cfg.d_model), ("fsdp", "tp"),
                           init="embed", dtype=cfg.dtype),
        "layers": stack_meta(group, n_groups(cfg)),
        "final_norm": rmsnorm_meta(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        meta["lm_head"] = ParamMeta((cfg.d_model, vpad), ("fsdp", "vocab"),
                                    dtype=cfg.dtype)
    return meta


def embed_lookup(table, tokens, pcfg: ParallelConfig):
    """Rows of ``table`` [V, d] at ``tokens``.  A sharded table (fsdp x
    tp) is all-gathered over its fsdp axis (the width stays tp-sharded)
    and each rank takes its batch's rows locally, as the reference's
    ``shard_map`` body does; the backward reduce-scatters the rows'
    gradient back."""
    if pcfg.gather_mode == "onehot":
        h = F.one_hot(tokens.long(), table.shape[0]).to(table.dtype) \
            @ table
    else:
        h = local_call(lambda tbl, tok: tbl[tok.long()], (table, tokens),
                       ((None, "tp"), ("batch", None)),
                       ("batch", None, "tp"),
                       tuple(tokens.shape) + (table.shape[1],))
    return shard_act(h, ("batch", None, None))


def embed_tokens(params, tokens, cfg: ModelConfig, pcfg: ParallelConfig):
    """The tokens' embeddings, times ``cfg.embedding_multiplier`` where
    it is not 1."""
    h = embed_lookup(params["embed"], tokens, pcfg)
    if cfg.embedding_multiplier != 1.0:
        h = h * cfg.embedding_multiplier
    return h


def lm_logits(params, h, cfg: ModelConfig):
    if cfg.tie_embeddings:
        logits = matmul(h, params["embed"].T)
    else:
        logits = matmul(h, params["lm_head"])
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return shard_act(logits, ("batch", None, "vocab"))


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[g], tree)


def _groups(tree, n: int) -> list:
    """Every group's slice of a stacked tree: ONE ``torch.unbind`` per
    leaf (views, no copy).  Under autograd its backward stacks the n
    group gradients once; n ``t[g]`` selects would each make a zero
    tensor the size of the whole stacked leaf in the backward."""
    if isinstance(tree, dict):
        per_key = {k: _groups(v, n) for k, v in tree.items()}
        return [{k: per_key[k][g] for k in tree} for g in range(n)]
    return list(torch.unbind(tree, 0))


# ---------------------------------------------------------------------------
# Sequence forward (prefill)
# ---------------------------------------------------------------------------


def lm_forward(params, tokens, cfg: ModelConfig, pcfg: ParallelConfig, *,
               prefix_embeds=None, want_cache: bool = False):
    """tokens: [B, S_text]; ``prefix_embeds`` [B, F, d] (a vision
    frontend's patch embeddings) go ahead of the token embeddings, the
    positions running over the whole sequence.  Returns (hidden [B,
    S_total, d], cache, aux); the cache's leaves lead with the group
    axis: attention's k/v [groups, B, S_total, kv*dh], a Mamba layer's
    state (``init_cache``).  With ``pcfg.remat`` other than ``"none"`` and
    no cache wanted, a forward that autograd records keeps only each
    group's input and recomputes the group in the backward; with
    ``"group:k"`` it keeps only each run of k groups' input, the run
    recomputed (each group again checkpointed) in the backward."""
    kinds = layer_kinds(cfg)
    G = n_groups(cfg)
    remat_on = pcfg.remat != "none" and not want_cache \
        and torch.is_grad_enabled()
    k = 1
    if remat_on and pcfg.remat.startswith("group:"):
        k = int(pcfg.remat.split(":")[1])
        if G % k:
            raise ValueError(f"remat {pcfg.remat!r}: {G} groups do not "
                             f"split into runs of {k}")
    h = embed_tokens(params, tokens, cfg, pcfg)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
        h = shard_act(h, ("batch", None, None))
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]

    def group_body(h, aux, gp):
        gc = {}
        for j, kind in enumerate(kinds):
            h, c, a = blocks.sublayer_apply(
                gp[f"sub{j}"], h, kind, cfg, pcfg, positions=positions,
                want_cache=want_cache)
            aux = aux + a
            gc[f"sub{j}"] = c
        return h, aux, gc

    def run(h, aux, gps):
        for gp in gps:
            h, aux, _ = checkpoint(group_body, h, aux, gp,
                                   use_reentrant=False,
                                   preserve_rng_state=False,
                                   context_fn=checkpoint_contexts)
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    groups = _groups(params["layers"], G)
    if remat_on:
        for i in range(0, G, k):
            if k > 1:
                h, aux = checkpoint(run, h, aux, groups[i:i + k],
                                    use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=checkpoint_contexts)
            else:
                h, aux = run(h, aux, groups[i:i + 1])
    else:
        for gp in groups:
            h, aux, gc = group_body(h, aux, gp)
            caches.append(gc)
    cache = None
    if want_cache:
        cache = {sub: {n: torch.stack([c[sub][n] for c in caches])
                       for n in leaves}
                 for sub, leaves in caches[0].items()}
    h = rmsnorm(h, params["final_norm"], cfg.rms_eps)
    return h, cache, aux


def lm_loss(params, batch, cfg: ModelConfig, pcfg: ParallelConfig):
    """batch: tokens [B, S_text], labels [B, S_text], optional
    patch_embeds [B, F, d] (whose positions get no loss).  Returns the
    scalar loss, the MoE layers' aux loss included."""
    prefix = batch.get("patch_embeds")
    h, _, aux = lm_forward(params, batch["tokens"], cfg, pcfg,
                           prefix_embeds=prefix)
    if prefix is not None:
        h = h[:, prefix.shape[1]:]
    logits = lm_logits(params, h, cfg)
    return softmax_xent(logits, batch["labels"], cfg.vocab_size) + aux


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None):
    """Zeroed decode cache (leaves lead with groups): k/v ``[g, batch,
    max_len, kv*dh]`` in ``dtype`` for an attention sub-layer; for a
    Mamba one ``ssm [g, batch, H, N, P]`` f32 and ``conv_x``, ``conv_B``,
    ``conv_C`` ``[g, batch, K-1, C]`` in ``dtype``."""
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    g = n_groups(cfg)
    cache = {}
    for j, (mixer, _) in enumerate(layer_kinds(cfg)):
        if mixer == "attn":
            leaves = {n: torch.zeros((batch, max_len, kv * dh),
                                     dtype=torch_dtype(dtype), device=device)
                      for n in ("k", "v")}
        else:
            leaves = mamba_mod.mamba_init_state(
                batch, cfg.d_model, cfg.mamba, dtype, device)._asdict()
        cache[f"sub{j}"] = {n: t.new_zeros((g,) + t.shape)
                            for n, t in leaves.items()}
    return cache


def cache_logical_axes(cfg: ModelConfig):
    """Logical axes tree matching ``init_cache``'s (the dry run's specs)."""
    group = {}
    for j, (mixer, _) in enumerate(layer_kinds(cfg)):
        if mixer == "attn":
            group[f"sub{j}"] = {
                "k": (None, "batch", "seq_shard", "kv_flat"),
                "v": (None, "batch", "seq_shard", "kv_flat"),
            }
        else:
            group[f"sub{j}"] = {
                "ssm": (None, "batch", "tp", None, None),
                "conv_x": (None, "batch", None, "tp"),
                "conv_B": (None, "batch", None, None),
                "conv_C": (None, "batch", None, None),
            }
    return group


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def lm_prefill(params, tokens, cfg: ModelConfig, pcfg: ParallelConfig, *,
               prefix_embeds=None):
    """Returns (last-position logits [B, V], cache, cache_len [B]); the
    cache and its length cover ``prefix_embeds``' positions too."""
    h, cache, _ = lm_forward(params, tokens, cfg, pcfg,
                             prefix_embeds=prefix_embeds, want_cache=True)
    logits = lm_logits(params, h[:, -1:], cfg)[:, 0]
    B, S = h.shape[0], h.shape[1]
    return logits, cache, torch.full((B,), S, dtype=torch.int32,
                                     device=h.device)


def lm_decode_step(params, cache, cache_len, token, cfg: ModelConfig,
                   pcfg: ParallelConfig):
    """One decode step.  token: [B] int32; cache_len: [B] valid positions.

    The cache is updated IN PLACE (the reference threads it through the
    scan carry, which XLA aliases in place too).  A MoE layer routes the
    batch as one group.  Returns (logits [B, V], cache, cache_len + 1).
    """
    kinds = layer_kinds(cfg)
    h = embed_tokens(params, token[:, None], cfg, pcfg)
    for g in range(n_groups(cfg)):
        gp = _group(params["layers"], g)
        gc = _group(cache, g)
        for j, kind in enumerate(kinds):
            h, _, _ = blocks.sublayer_apply(
                gp[f"sub{j}"], h, kind, cfg, pcfg, positions=None,
                cache=gc[f"sub{j}"], cache_len=cache_len, moe_groups=1)
    h = rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = lm_logits(params, h, cfg)[:, 0]
    return logits, cache, cache_len + 1
