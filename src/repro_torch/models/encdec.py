"""Encoder-decoder (seamless-m4t): a bidirectional encoder over stub
frame embeddings, a causal decoder with cross-attention.

The reference scans both stacks (``lax.scan``); here a Python loop walks
the stacked layers, each leaf split once (``transformer._groups``), so a
parameter tree and a cache tree read the same in both packages: every
leaf under ``encoder``/``decoder`` and every cache leaf leads with the
layer axis.  Training recomputes each layer in its backward only when
``pcfg.remat`` is ``"block"``, as the reference checkpoints only then
(``"group:k"`` does nothing in this family, there as here).

The frame embeddings are not cast: a float32 batch against bf16 weights
runs the encoder in float32 (JAX promotes ``x @ w``), so the encoder's
output and the cross-attention's k and v are float32 while the decoder
stays bf16; the cross-attention takes bf16 queries against float32 keys
and returns bf16 (``attention.blockwise_attention``, ``decode_attention``).
Every mixed product is promoted as JAX promotes it (``common.matmul``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.sharding import ParamMeta, stack_meta, torch_dtype
from repro_torch.models import blocks
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import rmsnorm, rmsnorm_meta, softmax_xent
from repro_torch.models.transformer import (VOCAB_PAD_MULTIPLE, _group,
                                            _groups, embed_lookup,
                                            lm_logits)


def encdec_meta(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    vpad = cfg.padded_vocab(VOCAB_PAD_MULTIPLE)
    enc_layer = {
        "norm_attn": rmsnorm_meta(d),
        "attn": blocks.attn_meta(cfg),
        "norm_ffn": rmsnorm_meta(d),
        "ffn": ffn_mod.ffn_meta(d, cfg.d_ff, cfg.dtype),
    }
    dec_layer = {
        "norm_self": rmsnorm_meta(d),
        "self_attn": blocks.attn_meta(cfg),
        "norm_cross": rmsnorm_meta(d),
        "cross_attn": blocks.attn_meta(cfg, cross=True),
        "norm_ffn": rmsnorm_meta(d),
        "ffn": ffn_mod.ffn_meta(d, cfg.d_ff, cfg.dtype),
    }
    return {
        "embed": ParamMeta((vpad, d), ("fsdp", "tp"), init="embed",
                           dtype=cfg.dtype),
        "encoder": stack_meta(enc_layer, cfg.n_encoder_layers),
        "enc_norm": rmsnorm_meta(d),
        "decoder": stack_meta(dec_layer, cfg.n_layers),
        "final_norm": rmsnorm_meta(d),
        "lm_head": ParamMeta((d, vpad), ("fsdp", "vocab"), dtype=cfg.dtype),
    }


def _remat(pcfg: ParallelConfig, body):
    """``body`` checkpointed (recomputed in the backward) when the
    reference's ``jax.checkpoint`` would wrap it: ``remat == "block"``
    and autograd recording."""
    if pcfg.remat != "block" or not torch.is_grad_enabled():
        return body
    return lambda *a: checkpoint(body, *a, use_reentrant=False,
                                 preserve_rng_state=False)


def encode(params, frame_embeds, cfg: ModelConfig, pcfg: ParallelConfig):
    """frame_embeds: [B, F, d] (the stub audio frontend's output), in
    whatever dtype the batch holds -> [B, F, d].  A layer must give back
    its input's dtype, as the reference's scan carry must: frames
    narrower than the weights (bf16 frames, float32 weights) would come
    out of the first layer promoted, and raise ``TypeError`` there, as
    the reference's ``lax.scan`` raises."""
    h = frame_embeds
    F = h.shape[1]
    positions = torch.arange(F, device=h.device)[None, :]

    def body(x, lp):
        y = blocks.attn_apply(lp["attn"],
                              rmsnorm(x, lp["norm_attn"], cfg.rms_eps),
                              cfg, pcfg, positions=positions, causal=False)
        x = x + y
        return x + ffn_mod.ffn_apply(
            lp["ffn"], rmsnorm(x, lp["norm_ffn"], cfg.rms_eps))

    body = _remat(pcfg, body)
    for lp in _groups(params["encoder"], cfg.n_encoder_layers):
        out = body(h, lp)
        if out.dtype != h.dtype:
            raise TypeError(
                f"an encoder layer takes {h.dtype} frames and gives "
                f"{out.dtype}: the stacked layers keep their carry's dtype "
                f"(frames narrower than the {cfg.dtype} weights)")
        h = out
    return rmsnorm(h, params["enc_norm"], cfg.rms_eps)


def decode_seq(params, tokens, enc_out, cfg: ModelConfig,
               pcfg: ParallelConfig, *, want_cache: bool = False):
    """Full-sequence decoder pass (train / prefill).  Returns (hidden
    [B, S, d], cache or None); the cache's leaves ``k``, ``v`` [L, B, S,
    kv*dh] and ``cross_k``, ``cross_v`` [L, B, F, kv*dh], each in the
    dtype its projection gave."""
    h = embed_lookup(params["embed"], tokens, pcfg)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]

    def body(x, lp):
        y = blocks.attn_apply(
            lp["self_attn"], rmsnorm(x, lp["norm_self"], cfg.rms_eps),
            cfg, pcfg, positions=positions, causal=True,
            want_cache=want_cache)
        if want_cache:
            y, (sk, sv) = y
        x = x + y
        hc = rmsnorm(x, lp["norm_cross"], cfg.rms_eps)
        yc = blocks.attn_apply(lp["cross_attn"], hc, cfg, pcfg,
                               positions=positions, causal=False,
                               kv_source=enc_out, use_rope=False,
                               want_cache=want_cache)
        if want_cache:
            yc, (ck, cv) = yc
        x = x + yc
        x = x + ffn_mod.ffn_apply(
            lp["ffn"], rmsnorm(x, lp["norm_ffn"], cfg.rms_eps))
        if want_cache:
            return x, {"k": sk, "v": sv, "cross_k": ck, "cross_v": cv}
        return x

    caches = []
    if not want_cache:
        body = _remat(pcfg, body)
    for lp in _groups(params["decoder"], cfg.n_layers):
        if want_cache:
            h, c = body(h, lp)
            caches.append(c)
        else:
            h = body(h, lp)
    cache = ({n: torch.stack([c[n] for c in caches]) for n in caches[0]}
             if want_cache else None)
    return rmsnorm(h, params["final_norm"], cfg.rms_eps), cache


def encdec_loss(params, batch, cfg: ModelConfig, pcfg: ParallelConfig):
    """batch: frame_embeds [B, F, d], tokens and labels [B, S]."""
    enc_out = encode(params, batch["frame_embeds"], cfg, pcfg)
    h, _ = decode_seq(params, batch["tokens"], enc_out, cfg, pcfg)
    logits = lm_logits(params, h, cfg)
    return softmax_xent(logits, batch["labels"], cfg.vocab_size)


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, dtype, device=None):
    """Zeroed decode cache: ``k``, ``v`` [L, batch, max_len, kv*dh] and
    ``cross_k``, ``cross_v`` [L, batch, enc_len, kv*dh], in ``dtype``."""
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    L = cfg.n_layers
    lens = {"k": max_len, "v": max_len, "cross_k": enc_len,
            "cross_v": enc_len}
    return {n: torch.zeros((L, batch, s, kv * dh), dtype=torch_dtype(dtype),
                           device=device) for n, s in lens.items()}


def encdec_prefill(params, batch, cfg: ModelConfig, pcfg: ParallelConfig):
    """Returns (last-position logits [B, V], cache, cache_len [B]); the
    cache length counts the text alone, not the frames."""
    enc_out = encode(params, batch["frame_embeds"], cfg, pcfg)
    h, cache = decode_seq(params, batch["tokens"], enc_out, cfg, pcfg,
                          want_cache=True)
    logits = lm_logits(params, h[:, -1:], cfg)[:, 0]
    B, S = batch["tokens"].shape
    return logits, cache, torch.full((B,), S, dtype=torch.int32,
                                     device=h.device)


def encdec_decode_step(params, cache, cache_len, token, cfg: ModelConfig,
                       pcfg: ParallelConfig):
    """One decode step.  token: [B] int32; cache_len: [B] valid text
    positions.  The self-attention cache is updated IN PLACE (the
    reference threads it through the scan carry, which XLA aliases in
    place too); cross-attention reads every position of the cross
    cache.  Returns (logits [B, V], cache, cache_len + 1)."""
    h = embed_lookup(params["embed"], token[:, None], pcfg)
    B = token.shape[0]
    cross_len = torch.full((B,), cache["cross_k"].shape[2],
                           dtype=torch.int32, device=h.device)
    for li in range(cfg.n_layers):
        lp = _group(params["decoder"], li)
        lc = _group(cache, li)
        y, _, _ = blocks.attn_decode(
            lp["self_attn"], rmsnorm(h, lp["norm_self"], cfg.rms_eps),
            cfg, pcfg, cache_k=lc["k"], cache_v=lc["v"],
            cache_len=cache_len)
        h = h + y
        yc, _, _ = blocks.attn_decode(
            lp["cross_attn"], rmsnorm(h, lp["norm_cross"], cfg.rms_eps),
            cfg, pcfg, cache_k=lc["cross_k"], cache_v=lc["cross_v"],
            cache_len=cache_len, cross=True, cross_len=cross_len)
        h = h + yc
        h = h + ffn_mod.ffn_apply(
            lp["ffn"], rmsnorm(h, lp["norm_ffn"], cfg.rms_eps))
    h = rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = lm_logits(params, h, cfg)[:, 0]
    return logits, cache, cache_len + 1


__all__ = ["decode_seq", "encdec_decode_step", "encdec_init_cache",
           "encdec_loss", "encdec_meta", "encdec_prefill", "encode"]
