"""Unified model interface: meta / init / loss / prefill / decode / cache,
the shapes of a cell's inputs and a concrete batch of them, and
``params_from_numpy``, which carries a parameter tree across from numpy.

Dispatched on the family, as the reference: the decoder-only stack
(attention or Mamba-2 mixers, dense or MoE FFNs, a vision frontend's
prefix embeddings) and the encoder-decoder (``models/encdec.py``).  The
modality frontend is a stub, as in the reference: a vision batch hands
the model precomputed patch embeddings, an audio batch frame embeddings.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.launch.sharding import (Rules, TensorSpec,
                                         leaves_with_path, materialize,
                                         tree_map)
from repro_torch.models import encdec, transformer


def model_meta(cfg: ModelConfig) -> dict:
    if cfg.is_encdec:
        return encdec.encdec_meta(cfg)
    return transformer.lm_meta(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator`` (on ``device``, the
    generator's by default)."""
    return materialize(model_meta(cfg), generator, device)


def loss_fn(params, batch, cfg: ModelConfig, pcfg: ParallelConfig):
    if cfg.is_encdec:
        return encdec.encdec_loss(params, batch, cfg, pcfg)
    return transformer.lm_loss(params, batch, cfg, pcfg)


def prefill_fn(params, batch, cfg: ModelConfig, pcfg: ParallelConfig):
    if cfg.is_encdec:
        return encdec.encdec_prefill(params, batch, cfg, pcfg)
    return transformer.lm_prefill(params, batch["tokens"], cfg, pcfg,
                                  prefix_embeds=batch.get("patch_embeds"))


def decode_fn(params, cache, cache_len, token, cfg: ModelConfig,
              pcfg: ParallelConfig):
    if cfg.is_encdec:
        return encdec.encdec_decode_step(params, cache, cache_len, token,
                                         cfg, pcfg)
    return transformer.lm_decode_step(params, cache, cache_len, token, cfg,
                                      pcfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None):
    if cfg.is_encdec:
        return encdec.encdec_init_cache(cfg, batch, max_len,
                                        cfg.frontend_len, dtype, device)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def cache_axes(cfg: ModelConfig):
    if cfg.is_encdec:
        return encdec.encdec_cache_axes()
    return transformer.cache_logical_axes(cfg)


def _text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.frontend == "vision":
        return shape.seq_len - cfg.frontend_len
    return shape.seq_len


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """(shape, dtype, logical axes) of every model input of a cell, as the
    reference gives them: a vision cell's ``seq_len`` counts its patch
    positions, so its text is ``frontend_len`` shorter."""
    B = shape.global_batch
    st = _text_len(cfg, shape)
    tok_ax = ("batch", None)
    emb_ax = ("batch", None, None)
    if shape.kind == "decode":
        return {"token": ((B,), torch.int32, ("batch",)),
                "cache_len": ((B,), torch.int32, ("batch",))}
    out = {"tokens": ((B, st), torch.int32, tok_ax)}
    if shape.kind == "train":
        out["labels"] = ((B, st), torch.int32, tok_ax)
    if cfg.frontend == "vision":
        out["patch_embeds"] = ((B, cfg.frontend_len, cfg.d_model),
                               torch.bfloat16, emb_ax)
    if cfg.frontend == "audio":
        out["frame_embeds"] = ((B, cfg.frontend_len, cfg.d_model),
                               torch.bfloat16, emb_ax)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig, rules: Rules,
                mesh=None) -> Dict[str, TensorSpec]:
    """``TensorSpec`` stand-ins (global shape, dtype, partition spec) of
    a cell's inputs, for the dry run (``sharding.abstract`` makes them
    DTensors on a mesh)."""
    return {name: TensorSpec(shp, dt, rules.spec(ax))
            for name, (shp, dt, ax) in batch_shapes(cfg, shape).items()}


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig,
                   generator: torch.Generator, device=None):
    """A concrete batch of a cell's inputs drawn from ``generator`` (on
    ``device``, the generator's by default): token ids uniform over the
    vocab, a decode cell's ``cache_len`` at ``seq_len - 1``, embeddings
    N(0, 1) in bfloat16."""
    device = torch.device(device if device is not None
                          else generator.device)
    out = {}
    for name, (shp, dt, _) in batch_shapes(cfg, shape).items():
        if name == "cache_len":
            out[name] = torch.full(shp, max(shape.seq_len - 1, 1),
                                   dtype=dt, device=device)
        elif dt == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shp,
                                      generator=generator, dtype=dt,
                                      device=device)
        else:
            out[name] = torch.randn(shp, generator=generator,
                                    device=device).to(dt)
    return out


def param_counts(cfg: ModelConfig) -> Dict[str, int]:
    """total / active / embed-only parameter counts from the meta tree
    (the reference's accounting: embedding gathers are not active unless
    tied; routed experts count at k/E)."""
    total = active = embed = 0
    k, e = cfg.moe.experts_per_token, cfg.moe.num_experts
    for path, m in leaves_with_path(model_meta(cfg)):
        n = int(np.prod(m.shape))
        total += n
        if "embed" in path:
            embed += n
            if cfg.tie_embeddings:
                active += n
            continue
        if "moe" in path and "shared" not in path and "router" not in path:
            n = int(n * (k / max(e, 1)))
        active += n
    return {"total": total, "active": active, "embed": embed}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D for train cells, 2*N per token for prefill and 2*N per
    generated token for decode (N: ``param_counts``' active count; a
    vision cell counts its text tokens only), as the reference."""
    n_active = param_counts(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * _text_len(cfg, shape)
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * _text_len(cfg, shape)
    return 2.0 * n_active * shape.global_batch  # decode: one token each


def params_from_numpy(tree, device=None):
    """A nested dict of numpy arrays (the JAX package's parameter tree,
    e.g. through ``np.asarray`` per leaf) as the same nesting of tensors
    on ``device`` (the CPU by default).

    A bfloat16 leaf (an ``ml_dtypes`` array, which ``torch.from_numpy``
    refuses) is recognised by its dtype's name and carried bit for bit
    through a uint16 view.  Paths and nesting are kept, so
    ``core/mvstore`` keys the blocks as the reference does."""
    def one(a):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t if device is None else t.to(device)
    return tree_map(one, tree)


__all__ = ["batch_shapes", "cache_axes", "concrete_batch", "decode_fn",
           "init_cache", "init_params", "input_specs", "loss_fn", "model_flops", "model_meta",
           "param_counts", "params_from_numpy", "prefill_fn"]
