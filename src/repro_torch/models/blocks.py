"""Decoder sub-layers: attention / mamba mixers + dense / MoE FFN,
pre-norm.

Every kind of the reference's ``models/blocks.py`` that a decoder-only
model builds: an ``attn`` or ``mamba`` mixer, then a ``dense``, ``moe``
or no (``none``) FFN.  (The cross-attention of ``attn_meta(cross=)``
comes with the encoder-decoder family.)
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.sharding import ParamMeta
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import apply_rope, rmsnorm, rmsnorm_meta


# ---------------------------------------------------------------------------
# Attention sub-layer
# ---------------------------------------------------------------------------


def attn_meta(cfg: ModelConfig) -> dict:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    m = {
        "w_q": ParamMeta((d, h * dh), ("fsdp", "tp"), dtype=cfg.dtype),
        "w_k": ParamMeta((d, kv * dh), ("fsdp", "kv_flat"), dtype=cfg.dtype),
        "w_v": ParamMeta((d, kv * dh), ("fsdp", "kv_flat"), dtype=cfg.dtype),
        "w_o": ParamMeta((h * dh, d), ("tp", "fsdp"), dtype=cfg.dtype),
    }
    if cfg.qkv_bias:
        m["b_q"] = ParamMeta((h * dh,), ("tp",), init="zeros",
                             dtype=cfg.dtype)
        m["b_k"] = ParamMeta((kv * dh,), ("kv_flat",), init="zeros",
                             dtype=cfg.dtype)
        m["b_v"] = ParamMeta((kv * dh,), ("kv_flat",), init="zeros",
                             dtype=cfg.dtype)
    return m


def _qkv(p, x):
    q = x @ p["w_q"]
    k = x @ p["w_k"]
    v = x @ p["w_v"]
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, pcfg: ParallelConfig, *,
               positions, causal: bool = True, want_cache: bool = False):
    """Full-sequence self-attention (prefill).  x: [B, S, d].
    Returns y or (y, (k_flat, v_flat)) when ``want_cache``.  (The
    reference's cross-attention comes with the encoder-decoder family.)
    """
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, x)
    qh = apply_rope(q.reshape(B, S, h, dh), positions, cfg.rope_theta)
    kh = apply_rope(k.reshape(B, S, kv, dh), positions, cfg.rope_theta)
    vh = v.reshape(B, S, kv, dh)
    o = attn_mod.attention(qh, kh, vh, causal=causal, impl=pcfg.attn_impl,
                           block_q=pcfg.attn_block_q,
                           block_k=pcfg.attn_block_k)
    y = o.reshape(B, S, h * dh) @ p["w_o"]
    if want_cache:
        return y, (kh.reshape(B, -1, kv * dh), vh.reshape(B, -1, kv * dh))
    return y


def attn_decode(p, x, cfg: ModelConfig, pcfg: ParallelConfig, *,
                cache_k, cache_v, cache_len):
    """One-token decode.  x: [B, 1, d]; cache_*: [B, Smax, kv*dh];
    cache_len: [B] valid positions.  Writes this token's k/v into the
    cache IN PLACE (row b, position ``cache_len[b]``); a position past
    the cache is dropped, as the reference's scatter drops it.  Returns
    (y, cache_k, cache_v), the caches being the tensors passed in."""
    B = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, x)
    pos = cache_len[:, None]
    qh = apply_rope(q.reshape(B, 1, h, dh), pos, cfg.rope_theta)
    kh = apply_rope(k.reshape(B, 1, kv, dh), pos, cfg.rope_theta)
    S = cache_k.shape[1]
    bidx = torch.arange(B, device=x.device)
    keep = (cache_len < S)[:, None]
    at = torch.clamp(cache_len, max=S - 1).long()
    for cache, new in ((cache_k, kh), (cache_v, v)):
        new = new.reshape(B, kv * dh).to(cache.dtype)
        cache.index_put_((bidx, at), torch.where(keep, new, cache[bidx, at]))
    kc = cache_k.reshape(B, S, kv, dh)
    vc = cache_v.reshape(B, S, kv, dh)
    o = attn_mod.decode_attention(qh[:, 0], kc, vc, cache_len + 1,
                                  chunk=pcfg.decode_attn_chunk)
    y = o.reshape(B, 1, h * dh) @ p["w_o"]
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# Unified sub-layer (mixer + optional FFN)
# ---------------------------------------------------------------------------


def sublayer_meta(cfg: ModelConfig, kind: Tuple[str, str]) -> dict:
    mixer, ffn = kind
    d = cfg.d_model
    m = {"norm_mixer": rmsnorm_meta(d)}
    if mixer == "attn":
        m["attn"] = attn_meta(cfg)
    else:
        m["mamba"] = mamba_mod.mamba_meta(d, cfg.mamba, cfg.dtype)
    if ffn == "dense":
        m["ffn"] = ffn_mod.ffn_meta(d, cfg.d_ff, cfg.dtype)
        m["norm_ffn"] = rmsnorm_meta(d)
    elif ffn == "moe":
        m["moe"] = moe_mod.moe_meta(d, cfg.moe, cfg.dtype)
        m["norm_ffn"] = rmsnorm_meta(d)
    return m


def sublayer_apply(p, x, kind, cfg: ModelConfig, pcfg: ParallelConfig, *,
                   positions, cache=None, cache_len=None,
                   want_cache: bool = False, moe_groups=None):
    """Apply one (mixer, ffn) sub-layer.

    Sequence mode: cache is None (no cache wanted, or prefill with
    ``want_cache``).  Decode mode: cache is this sub-layer's ``{"k", "v"}``
    or Mamba state ``{"ssm", "conv_x", "conv_B", "conv_C"}`` and is
    updated in place.  ``moe_groups``: a MoE FFN's routing group count
    (``moe.moe_apply``'s ``groups``).  Returns (y, new_cache_or_None,
    aux_loss).
    """
    mixer, ffn = kind
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None
    h = rmsnorm(x, p["norm_mixer"], cfg.rms_eps)
    decode = cache is not None and x.shape[1] == 1
    if mixer == "attn":
        if decode:
            y, ck, cv = attn_decode(p["attn"], h, cfg, pcfg,
                                    cache_k=cache["k"], cache_v=cache["v"],
                                    cache_len=cache_len)
            new_cache = {"k": ck, "v": cv}
        elif want_cache:
            y, (ck, cv) = attn_apply(p["attn"], h, cfg, pcfg,
                                     positions=positions, want_cache=True)
            new_cache = {"k": ck, "v": cv}
        else:
            y = attn_apply(p["attn"], h, cfg, pcfg, positions=positions)
    elif decode or want_cache:
        mstate = (mamba_mod.MambaState(**cache) if cache is not None
                  else mamba_mod.mamba_init_state(
                      x.shape[0], cfg.d_model, cfg.mamba, x.dtype, x.device))
        y, mnew = mamba_mod.mamba_apply(p["mamba"], h, cfg.mamba,
                                        rms_eps=cfg.rms_eps, state=mstate)
        new_cache = dict(mnew._asdict())
        if cache is not None:
            for n, t in new_cache.items():
                cache[n].copy_(t)
            new_cache = cache
    else:
        y = mamba_mod.mamba_apply(p["mamba"], h, cfg.mamba,
                                  rms_eps=cfg.rms_eps)
    x = x + y
    if ffn == "dense":
        h = rmsnorm(x, p["norm_ffn"], cfg.rms_eps)
        x = x + ffn_mod.ffn_apply(p["ffn"], h)
    elif ffn == "moe":
        h = rmsnorm(x, p["norm_ffn"], cfg.rms_eps)
        y, aux = moe_mod.moe_apply(p["moe"], h, cfg.moe,
                                   capacity_factor=pcfg.moe_capacity_factor,
                                   groups=moe_groups)
        x = x + y
    return x, new_cache, aux
