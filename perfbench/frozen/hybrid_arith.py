"""Parameter counts and model flops of a hybrid Mamba-2 / attention stack
with a held share of MoE experts (granite-4.0-h-small's family), from a
configuration file's published keys alone.

Counting rules (``arith``'s): 2 N a prefilled or generated token, N the
parameters a token uses on this card.  Of the routed experts a token
uses ``num_experts_per_tok`` of ``num_local_experts_published``, of which
this card holds ``num_local_experts``: on average k * held / published of
the held experts' weights (5 of 36 for granite-4.0-h-small); everything
else (the mixers, the shared expert, the router, the norms and the tied
head) every token uses."""
from __future__ import annotations

from typing import List, Tuple


def period(types: List[str]) -> int:
    """The shortest period of the layer pattern that divides the depth
    (the program stacks one such period a group)."""
    n = len(types)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and types == types[:p] * (n // p))


def _mixer(cfg: dict, kind: str, dt: str) -> List[Tuple[str, int, str]]:
    d = cfg["hidden_size"]
    if kind == "attention":
        H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        D = d // H
        return [("attn.w_q", d * H * D, dt), ("attn.w_k", d * KV * D, dt),
                ("attn.w_v", d * KV * D, dt), ("attn.w_o", H * D * d, dt)]
    di = cfg["mamba_expand"] * d
    N, K = cfg["mamba_d_state"], cfg["mamba_d_conv"]
    H = di // cfg["mamba_d_head"]
    out = [("w_z", d * di, dt), ("w_x", d * di, dt), ("w_B", d * N, dt),
           ("w_C", d * N, dt), ("w_dt", d * H, dt),
           ("conv_x", K * di, "float32"), ("conv_B", K * N, "float32"),
           ("conv_C", K * N, "float32"), ("A_log", H, "float32"),
           ("D", H, "float32"), ("dt_bias", H, "float32"),
           ("norm", di, "float32"), ("w_out", di * d, dt)]
    if cfg["mamba_conv_bias"]:
        out += [("conv_x_bias", di, "float32"), ("conv_B_bias", N, "float32"),
                ("conv_C_bias", N, "float32")]
    return [("mamba." + n, e, t) for n, e, t in out]


def _moe(cfg: dict, dt: str) -> List[Tuple[str, int, str]]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    E, fs = cfg["num_local_experts"], cfg["shared_intermediate_size"]
    return [("moe.w_router", d * cfg["num_local_experts_published"],
             "float32"),
            ("moe.w_gate", E * d * f, dt), ("moe.w_up", E * d * f, dt),
            ("moe.w_down", E * f * d, dt),
            ("moe.shared.w_gate", d * fs, dt),
            ("moe.shared.w_up", d * fs, dt),
            ("moe.shared.w_down", fs * d, dt)]


def param_leaves(cfg: dict) -> List[Tuple[str, int, str]]:
    """``(path, elements, dtype)`` of every parameter leaf as the program
    stores it: one period of layers a group (``layers.sub<j>.<leaf>``,
    stacked over the groups), norms, the SSM's per-head vectors and conv
    filters and the router in float32."""
    dt = cfg["dtype"]
    d = cfg["hidden_size"]
    types = cfg["layer_types"]
    P = period(types)
    G = len(types) // P
    out = [("embed", cfg["vocab_padded"] * d, dt),
           ("final_norm", d, "float32")]
    for j, kind in enumerate(types[:P]):
        sub = ([("norm_mixer", d, "float32"), ("norm_ffn", d, "float32")]
               + _mixer(cfg, kind, dt) + _moe(cfg, dt))
        out += [(f"layers.sub{j}.{n}", G * e, t) for n, e, t in sub]
    return out


def routed(name: str) -> bool:
    """A held expert's weights (not the router, not the shared expert)."""
    parts = name.split(".")
    return parts[-2:-1] == ["moe"] and parts[-1] != "w_router"


def active_params(cfg: dict) -> float:
    """Parameters a token uses on this card: the held experts' weights at
    k / published, everything else whole (the embedding is the tied
    head)."""
    share = cfg["num_experts_per_tok"] / cfg["num_local_experts_published"]
    return sum(e * share if routed(n) else e
               for n, e, _ in param_leaves(cfg))


def serve_flops(cfg: dict, tokens: int) -> float:
    return 2.0 * active_params(cfg) * tokens


__all__ = ["active_params", "param_leaves", "period", "routed",
           "serve_flops"]
