"""Configurations of the port: the paper's STM tunables
(``paper_stm.MultiverseParams``), the store's ``base.MVStoreConfig`` and
the model registry.

``get_config('<arch-id>')`` takes the architectures the port serves
(``REGISTRY``); the JAX package's other architectures raise "not ported
yet".  ``smoke_config`` reduces a config the way the reference does, for
CPU tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import mamba2_780m, qwen2_5_3b
from repro_torch.configs.base import (
    SHAPES,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    MVStoreConfig,
    ParallelConfig,
    RunConfig,
    ShapeConfig,
)

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (mamba2_780m, qwen2_5_3b)}

ARCH_IDS = sorted(REGISTRY)

#: the JAX package's architectures that the port does not serve yet
NOT_PORTED = ("deepseek-7b", "jamba-v0.1-52b", "llama4-scout-17b-a16e",
              "minitron-4b", "mistral-large-123b", "moonshot-v1-16b-a3b",
              "paligemma-3b", "seamless-m4t-medium")


def get_config(name: str) -> ModelConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; ported: {', '.join(ARCH_IDS)}")
    raise KeyError(f"unknown arch {name!r}; available: {', '.join(ARCH_IDS)}")


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def smoke_config(name: str) -> ModelConfig:
    """A reduced config of the same family as ``name`` (the reference's
    reduction: width 64, 4 heads of 16 keeping the GQA ratio, d_ff 128,
    vocab 512, 2 layers)."""
    full = get_config(name)
    kv_ratio = max(1, full.n_heads // max(full.n_kv_heads, 1))
    n_heads = 4 if full.n_heads else 0
    n_kv = max(1, n_heads // kv_ratio) if n_heads else 0
    return dataclasses.replace(
        full,
        name=full.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16 if n_heads else 0,
        d_ff=128 if full.d_ff else 0,
        vocab_size=512,
        mamba=dataclasses.replace(full.mamba, d_state=16, head_dim=8,
                                  chunk=32),
        frontend_len=min(full.frontend_len, 8),
    )


SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")
SMOKE_DECODE_SHAPE = ShapeConfig(
    "smoke_decode", seq_len=32, global_batch=2, kind="decode")

__all__ = [
    "ARCH_IDS", "NOT_PORTED", "REGISTRY", "SHAPES", "SMOKE_SHAPE",
    "SMOKE_DECODE_SHAPE", "MambaConfig", "ModelConfig", "MoEConfig",
    "MVStoreConfig", "ParallelConfig", "RunConfig", "ShapeConfig",
    "get_config", "get_shape", "smoke_config",
]
