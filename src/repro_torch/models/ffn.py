"""Dense feed-forward (SwiGLU)."""
from __future__ import annotations

import torch

from repro_torch.launch.sharding import ParamMeta, shard_act
from repro_torch.models.common import matmul


def ffn_meta(d_model: int, d_ff: int, dtype: str) -> dict:
    return {
        "w_gate": ParamMeta((d_model, d_ff), ("fsdp", "tp"), dtype=dtype),
        "w_up": ParamMeta((d_model, d_ff), ("fsdp", "tp"), dtype=dtype),
        "w_down": ParamMeta((d_ff, d_model), ("tp", "fsdp"), dtype=dtype),
    }


def ffn_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].  SiLU is spelled op by op as
    ``jax.nn.silu`` lowers it, ``g * (1 / (1 + exp(-g)))``: in bf16 each
    op rounds, and so the two packages agree bit for bit here.  An x of
    another dtype than the weights (a float32 encoder over bf16 weights)
    is multiplied as JAX promotes it (``common.matmul``)."""
    g = matmul(x, params["w_gate"])
    h = g * (1 / (1 + torch.exp(-g))) * matmul(x, params["w_up"])
    h = shard_act(h, ("batch", None, "tp"))
    return shard_act(matmul(h, params["w_down"]), ("batch", None, None))
