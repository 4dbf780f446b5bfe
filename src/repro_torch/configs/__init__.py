"""Configurations of the port: the paper's STM tunables
(``paper_stm.MultiverseParams``), the store's ``base.MVStoreConfig`` and
the model registry.

``get_config('<arch-id>')`` takes every architecture of the JAX
package's registry (``REGISTRY``: the decoder-only families and the
encoder-decoder seamless-m4t-medium) and the port's own ``PORT_ONLY``
ones (granite-4.0-h-small), which the JAX package lacks and so stay out
of ``REGISTRY`` and ``ARCH_IDS``.  ``smoke_config`` reduces a config
exactly as the reference does, for CPU tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_7b, granite_4_0_h_small,
                                 jamba_v0_1_52b,
                                 llama4_scout_17b_a16e, mamba2_780m,
                                 minitron_4b, mistral_large_123b,
                                 moonshot_v1_16b_a3b, paligemma_3b,
                                 qwen2_5_3b, seamless_m4t_medium)
from repro_torch.configs.base import (
    SHAPES,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    MVStoreConfig,
    ParallelConfig,
    PortMambaConfig,
    PortModelConfig,
    PortMoEConfig,
    RunConfig,
    ShapeConfig,
)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (jamba_v0_1_52b, paligemma_3b, qwen2_5_3b, deepseek_7b,
              mistral_large_123b, minitron_4b, mamba2_780m,
              llama4_scout_17b_a16e, moonshot_v1_16b_a3b,
              seamless_m4t_medium)}

ARCH_IDS = sorted(REGISTRY)

#: configurations of the port alone (no JAX counterpart)
PORT_ONLY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (granite_4_0_h_small,)}

#: every name ``get_config`` takes
ALL_ARCH_IDS = sorted(REGISTRY) + sorted(PORT_ONLY)

#: the JAX package's architectures that the port does not serve yet
NOT_PORTED = ()


def get_config(name: str) -> ModelConfig:
    cfg = REGISTRY.get(name) or PORT_ONLY.get(name)
    if cfg is None:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(ALL_ARCH_IDS)}")
    return cfg


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def smoke_config(name: str) -> ModelConfig:
    """A reduced config of the same family as ``name``: the reference's
    reduction field for field.  Width 64, 4 heads of 16 keeping the GQA
    ratio, d_ff 128, vocab 512; depth 8 for a hybrid (one interleave
    period of the reduced pattern), else 2; at most 8 experts, at most 2
    a token, 64 wide; the hybrid interleave cut to one attention layer in
    4 at offset 2; a frontend of at most 8 positions.  A port-only MoE
    keeps its share of the experts held (half of 8 for granite's 36 of
    72) and gets a shared expert of width 128."""
    full = get_config(name)
    n_layers = {"hybrid": 8, "moe": 2, "ssm": 2}.get(full.family, 2)
    if full.is_encdec:
        n_layers = 2
    kv_ratio = max(1, full.n_heads // max(full.n_kv_heads, 1))
    n_heads = 4 if full.n_heads else 0
    n_kv = max(1, n_heads // kv_ratio) if n_heads else 0
    moe = full.moe
    if moe.num_experts:
        e = min(8, moe.num_experts)
        share = {}
        if isinstance(moe, PortMoEConfig):
            share = dict(
                experts_held=max(1, moe.experts_held * e // moe.num_experts),
                first_expert=moe.first_expert * e // moe.num_experts,
                shared_d_ff=128 if moe.shared_d_ff else 0)
        moe = dataclasses.replace(
            moe, num_experts=e,
            experts_per_token=min(2, moe.experts_per_token), d_ff_expert=64,
            **share)
    return dataclasses.replace(
        full,
        name=full.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16 if n_heads else 0,
        d_ff=128 if full.d_ff else 0,
        vocab_size=512,
        moe=moe,
        mamba=dataclasses.replace(full.mamba, d_state=16, head_dim=8,
                                  chunk=32),
        n_encoder_layers=2 if full.is_encdec else 0,
        frontend_len=min(full.frontend_len, 8),
        attn_layer_period=full.attn_layer_period and 4,
        attn_layer_offset=full.attn_layer_offset and 2,
    )


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")
SMOKE_DECODE_SHAPE = ShapeConfig(
    "smoke_decode", seq_len=32, global_batch=2, kind="decode")

__all__ = [
    "ALL_ARCH_IDS", "ARCH_IDS", "NOT_PORTED", "PORT_ONLY", "REGISTRY",
    "SHAPES", "SMOKE_SHAPE", "SMOKE_DECODE_SHAPE", "MambaConfig",
    "ModelConfig", "MoEConfig", "MVStoreConfig", "ParallelConfig",
    "PortMambaConfig", "PortModelConfig", "PortMoEConfig", "RunConfig",
    "ShapeConfig",
    "get_config", "get_shape", "smoke_config",
]
