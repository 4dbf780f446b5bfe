"""Top-k mixture-of-experts: a softmax router, sort-based dispatch into
capacity-bounded expert buffers, SwiGLU experts and a weighted combine.

The reference's ``models/moe.py`` on one device (its sharding
annotations dropped).  Dispatch is sort-based, not a one-hot einsum: the
[tokens, experts, capacity] dispatch tensor of the einsum form is
O(N*E*C), so routing is computed with integer sort / scatter / gather
ops (O(N*k)) and the only large tensors are the dispatched token
buffers.  Tokens are routed within *groups* (default: one group per
sequence, as in GShard); decode passes ``groups=1``, the whole batch one
group.

Routing is discrete, so the port follows the reference op for op where
a choice could differ: the top k by a stable descending sort (ties go to
the lower expert index, as ``lax.top_k`` breaks them), the slots by a
stable sort of the chosen experts, the same capacity rounding, a dropped
slot sent to the sentinel (slot ``E*C``, token ``N``, both reading a
zero pad row), and the combine in the activations' dtype.  The router's
product is float32; on the card it must not run on TF32
(``torch.backends.cuda.matmul.allow_tf32``, off by default), or one
flipped choice changes a token's whole output.  The expert products are
batched matmuls (``torch.einsum``); the reference computes them outside
any Pallas kernel too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.launch.sharding import (ParamMeta, Rules, current_rules,
                                         is_dtensor, local_call, mesh_ways,
                                         placements, shard_act)
from repro_torch.models.ffn import ffn_apply


def moe_meta(d_model: int, cfg: MoEConfig, dtype: str) -> dict:
    e, f = cfg.num_experts, cfg.d_ff_expert
    p = {
        "w_router": ParamMeta((d_model, e), (None, None), dtype="float32"),
        "w_gate": ParamMeta((e, d_model, f), ("experts", "fsdp", None),
                            dtype=dtype),
        "w_up": ParamMeta((e, d_model, f), ("experts", "fsdp", None),
                          dtype=dtype),
        "w_down": ParamMeta((e, f, d_model), ("experts", None, "fsdp"),
                            dtype=dtype),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": ParamMeta((d_model, fs), ("fsdp", "tp"), dtype=dtype),
            "w_up": ParamMeta((d_model, fs), ("fsdp", "tp"), dtype=dtype),
            "w_down": ParamMeta((fs, d_model), ("tp", "fsdp"), dtype=dtype),
        }
    return p


def _capacity(tokens_per_group: int, cfg: MoEConfig,
              capacity_factor: float) -> int:
    cap = int(tokens_per_group * cfg.experts_per_token * capacity_factor
              / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def select(x_groups, w_router, k: int):
    """The router: softmax over the experts of the float32 product, and
    the top ``k`` of each token by a stable descending sort.  x_groups
    [G, N, d] -> (probs [G, N, E] f32, top probs [G, N, k], chosen
    experts [G, N, k] int64)."""
    logits = x_groups.float() @ w_router
    probs = torch.softmax(logits, dim=-1)
    top, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, top[..., :k], sel[..., :k]


def route(x_groups, w_router, cfg: MoEConfig, capacity_factor: float):
    """Compute dispatch/combine indices.

    x_groups: [G, N, d] -> (slot_token [G, E*C] int32 with sentinel N,
    slot_of [G, N, k] int32 with sentinel E*C, weights [G, N, k] f32,
    aux_loss scalar).
    """
    G, N, _ = x_groups.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(N, cfg, capacity_factor)
    dev = x_groups.device

    probs, weights, sel = select(x_groups, w_router, K)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): mean prob * mean assignment per expert
    me = probs.mean(dim=1)                                    # [G, E]
    flat_e = sel.reshape(G, N * K)                            # [G, NK]
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    ce = counts.float() / (N * K)
    aux = E * torch.mean(torch.sum(me * ce, dim=-1))

    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    starts = torch.cumsum(counts, dim=-1) - counts            # [G, E]
    pos = (torch.arange(N * K, device=dev)[None, :]
           - torch.gather(starts, 1, sorted_e))               # [G, NK]
    keep = pos < C
    slot_sorted = torch.where(keep, sorted_e * C + pos,
                              torch.full_like(pos, E * C))    # [G, NK]
    token_sorted = torch.div(order, K, rounding_mode="floor")

    # slot -> token map (sentinel token id N reads the zero pad row); a
    # dropped entry writes the extra column E*C, cut off after
    slot_token = torch.full((G, E * C + 1), N, dtype=torch.int64,
                            device=dev)
    slot_token.scatter_(1, slot_sorted,
                        torch.where(keep, token_sorted,
                                    torch.full_like(token_sorted, N)))
    # token -> its K slots, in original (token, k) order
    slot_of = torch.empty((G, N * K), dtype=torch.int64, device=dev)
    slot_of.scatter_(1, order, slot_sorted)
    return (slot_token[:, :E * C].to(torch.int32),
            slot_of.reshape(G, N, K).to(torch.int32), weights, aux)


def _route(x_groups, w_router, cfg: MoEConfig, capacity_factor: float):
    """``route`` — of sharded groups, on each rank's groups
    (``sharding.local_call``; routing never crosses a group).  The aux
    loss, a mean over groups, comes back as a partial sum: each rank's
    mean weighted by its share of the groups (a ``Partial("avg")`` would
    give the right value, but DTensor hands its gradient back unscaled,
    once a rank).  Groups that do not split evenly over the batch axes
    (decode's one group) are routed whole on every rank."""
    if not is_dtensor(x_groups):
        return route(x_groups, w_router, cfg, capacity_factor)
    rules = current_rules() or Rules()
    from torch.distributed.tensor import Partial, Shard
    G, N = x_groups.shape[0], x_groups.shape[1]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(N, cfg, capacity_factor)
    split = G % mesh_ways(x_groups.device_mesh, rules.get("batch")) == 0
    g = "batch" if split else None
    pl = placements(rules.spec((g, None, None)), x_groups.device_mesh)
    aux_pl = tuple(Partial() if isinstance(p, Shard) else p for p in pl)

    def local_route(x, w):
        slot_token, slot_of, weights, aux = route(x, w, cfg,
                                                  capacity_factor)
        if x.shape[0] != G:
            aux = aux * (x.shape[0] / G)
        return slot_token, slot_of, weights, aux

    return local_call(
        local_route, (x_groups, w_router), ((g, None, None), (None, None)),
        [(g, None), (g, None, None), (g, None, None), aux_pl],
        [(G, E * C), (G, N, K), (G, N, K), ()])


def _experts(x, w):
    """The expert products ``gecd,edf->gecf``: of DTensors, on each
    rank's groups and experts (``sharding.local_call``), the weights
    gathered over their FSDP dim first — so no expert product is
    computed twice on ranks that split the groups or the experts."""
    def prod(x, w):
        return torch.einsum("gecd,edf->gecf", x, w)

    if not is_dtensor(x):
        return prod(x, w)
    rules = current_rules() or Rules()
    G = x.shape[0]
    g = "batch" if G % mesh_ways(x.device_mesh, rules.get("batch")) == 0 \
        else None
    return local_call(prod, (x, w),
                      ((g, "experts", None, None), ("experts", None, None)),
                      (g, "experts", None, None),
                      tuple(x.shape[:3]) + (w.shape[2],))


def _rows(x, idx):
    """``take_along_axis(x, idx[:, :, None], axis=1)``: x [G, M, d], idx
    [G, L] -> [G, L, d]."""
    return torch.gather(x, 1, idx.long()[:, :, None].expand(
        -1, -1, x.shape[-1]))


def moe_apply(params, x, cfg: MoEConfig, *, capacity_factor: float = 1.25,
              groups: Optional[int] = None):
    """x: [B, S, d] -> ([B, S, d], aux_loss).

    ``groups``: routing group count; default one group per sequence (B).
    Decode callers (S == 1) pass groups=1 so the whole batch is one group.
    """
    B, S, d = x.shape
    G = groups if groups else B
    x_groups = x.reshape(G, (B * S) // G, d)
    N = x_groups.shape[1]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(N, cfg, capacity_factor)

    slot_token, slot_of, weights, aux = _route(
        x_groups, params["w_router"], cfg, capacity_factor)

    # dispatch: gather token rows into [G, E, C, d]; pad row N reads zeros
    xp = torch.cat([x_groups, x.new_zeros((G, 1, d))], dim=1)
    xd = _rows(xp, slot_token).reshape(G, E, C, d)
    # reshard: batch-sharded groups -> expert-sharded buffers
    xd = shard_act(xd, ("batch", "experts", None, None))
    # SiLU spelled as jax.nn.silu lowers it (see ffn.ffn_apply)
    g = _experts(xd, params["w_gate"])
    h = g * (1 / (1 + torch.exp(-g))) * _experts(xd, params["w_up"])
    yd = _experts(h, params["w_down"])
    # reshard back to batch-sharded groups
    yd = shard_act(yd, ("batch", None, None, None))

    yflat = torch.cat([yd.reshape(G, E * C, d), yd.new_zeros((G, 1, d))],
                      dim=1)                                  # [G, EC+1, d]
    y_tok = _rows(yflat, slot_of.reshape(G, N * K)).reshape(G, N, K, d)
    # combine in the activations' dtype, as the reference does
    y = torch.sum(y_tok * weights[..., None].to(y_tok.dtype), dim=2)
    y = y.to(x.dtype).reshape(B, S, d)

    if "shared" in params:
        y = y + ffn_apply(params["shared"], x)
    return shard_act(y, ("batch", None, None)), aux * cfg.router_aux_weight
