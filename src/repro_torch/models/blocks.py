"""Sub-layers: attention / mamba mixers + dense / MoE FFN, pre-norm.

Every kind of the reference's ``models/blocks.py``: an ``attn`` or
``mamba`` mixer, then a ``dense``, ``moe`` or no (``none``) FFN, for the
decoder-only stacks; and the attention the encoder-decoder family builds
from (``models/encdec.py``): bidirectional self-attention, and
cross-attention (``attn_meta(cross=True)``, ``attn_apply(kv_source=)``,
``attn_decode(cross=True)``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.sharding import (ParamMeta, Rules, current_rules,
                                         is_dtensor, local_call,
                                         mesh_coordinate, mesh_ways,
                                         shard_act, split_heads)
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import apply_rope, matmul, rmsnorm, \
    rmsnorm_meta


# ---------------------------------------------------------------------------
# Attention sub-layer
# ---------------------------------------------------------------------------


def attn_meta(cfg: ModelConfig, cross: bool = False) -> dict:
    """The projections; a QKV bias where the config has one, except on a
    cross-attention."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    m = {
        "w_q": ParamMeta((d, h * dh), ("fsdp", "tp"), dtype=cfg.dtype),
        "w_k": ParamMeta((d, kv * dh), ("fsdp", "kv_flat"), dtype=cfg.dtype),
        "w_v": ParamMeta((d, kv * dh), ("fsdp", "kv_flat"), dtype=cfg.dtype),
        "w_o": ParamMeta((h * dh, d), ("tp", "fsdp"), dtype=cfg.dtype),
    }
    if cfg.qkv_bias and not cross:
        m["b_q"] = ParamMeta((h * dh,), ("tp",), init="zeros",
                             dtype=cfg.dtype)
        m["b_k"] = ParamMeta((kv * dh,), ("kv_flat",), init="zeros",
                             dtype=cfg.dtype)
        m["b_v"] = ParamMeta((kv * dh,), ("kv_flat",), init="zeros",
                             dtype=cfg.dtype)
    return m


def _qkv(p, x, src=None):
    """q from ``x``, k and v from ``src`` (``x`` itself by default), each
    product promoted as JAX promotes it (``common.matmul``)."""
    src = x if src is None else src
    q = matmul(x, p["w_q"])
    k = matmul(src, p["w_k"])
    v = matmul(src, p["w_v"])
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, pcfg: ParallelConfig, *,
               positions, causal: bool = True,
               kv_source: Optional[torch.Tensor] = None,
               use_rope: bool = True, want_cache: bool = False):
    """Full-sequence attention (train / prefill / encoder / cross).
    x: [B, S, d].  ``kv_source`` [B, Sk, d] switches to cross-attention:
    k and v come from it, and RoPE (unless ``use_rope`` is off) puts them
    at ``arange(Sk)``, q at ``positions``.  Returns y or (y, (k_flat,
    v_flat)) when ``want_cache``, k as rotated."""
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, x, kv_source)
    q = shard_act(q, ("batch", None, "tp"))
    k = shard_act(k, ("batch", None, "kv_flat"))
    v = shard_act(v, ("batch", None, "kv_flat"))
    Sk = k.shape[1]
    qh = split_heads(q, h, dh)
    kh = split_heads(k, kv, dh)
    vh = split_heads(v, kv, dh)
    if use_rope:
        qh = apply_rope(qh, positions, cfg.rope_theta)
        kh = apply_rope(kh, positions if kv_source is None else
                        torch.arange(Sk, device=x.device)[None],
                        cfg.rope_theta)
    o = attn_mod.attention(qh, kh, vh, causal=causal, impl=pcfg.attn_impl,
                           block_q=pcfg.attn_block_q,
                           block_k=pcfg.attn_block_k)
    y = shard_act(matmul(o.reshape(B, S, h * dh), p["w_o"]),
                  ("batch", None, None))
    if want_cache:
        return y, (kh.reshape(B, -1, kv * dh), vh.reshape(B, -1, kv * dh))
    return y


def attn_decode(p, x, cfg: ModelConfig, pcfg: ParallelConfig, *,
                cache_k, cache_v, cache_len, cross: bool = False,
                cross_len=None):
    """One-token decode.  x: [B, 1, d]; cache_*: [B, Smax, kv*dh];
    cache_len: [B] valid positions.  Self-attention writes this token's
    k/v into the cache IN PLACE (row b, position ``cache_len[b]``; a
    position past the cache is dropped, as the reference's scatter drops
    it) and attends ``cache_len + 1`` positions.  Cross-attention
    (``cross``) writes nothing, gives q no RoPE and attends the first
    ``cross_len`` positions.  Returns (y, cache_k, cache_v), the caches
    being the tensors passed in."""
    B = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    S = cache_k.shape[1]
    if cross:                      # k and v are the cache's: q alone
        qh = split_heads(matmul(x, p["w_q"]), h, dh)
        valid = cross_len
    else:
        q, k, v = _qkv(p, x)
        qh = split_heads(q, h, dh)
        pos = cache_len[:, None]
        qh = apply_rope(qh, pos, cfg.rope_theta)
        kh = apply_rope(split_heads(k, kv, dh), pos, cfg.rope_theta)
        _write_token(cache_k, cache_v, kh.reshape(B, kv * dh),
                     v.reshape(B, kv * dh), cache_len)
        valid = cache_len + 1
    kc = split_heads(cache_k, kv, dh)
    vc = split_heads(cache_v, kv, dh)
    o = attn_mod.decode_attention(qh[:, 0], kc, vc, valid,
                                  chunk=pcfg.decode_attn_chunk)
    y = matmul(o.reshape(B, 1, h * dh), p["w_o"])
    return shard_act(y, ("batch", None, None)), cache_k, cache_v


def _write_token(cache_k, cache_v, k_new, v_new, cache_len) -> None:
    """Write one token's k and v ([B, kv*dh]) into the caches [B, S,
    kv*dh] IN PLACE at row b, position ``cache_len[b]`` (a position past
    the cache is dropped).  Sharded caches are written shard by shard
    (``local_call``): a rank whose sequence piece (``seq_shard``) does
    not hold the position writes nothing."""
    S = cache_k.shape[1]
    off = 0
    if is_dtensor(cache_k):
        ax = (current_rules() or Rules()).get("seq_shard")
        dm = cache_k.device_mesh
        off = mesh_coordinate(dm, ax) * -(-S // mesh_ways(dm, ax))

    def write(ck, cv, kn, vn, cl):
        B, s_loc = ck.shape[0], ck.shape[1]
        if s_loc == 0:
            return
        bidx = torch.arange(B, device=ck.device)
        if s_loc == S:
            keep = (cl < S)[:, None]
            at = torch.clamp(cl, max=S - 1).long()
        else:                         # this rank's piece of the sequence
            pos = cl - off
            keep = ((pos >= 0) & (pos < s_loc))[:, None]
            at = torch.clamp(pos, min=0, max=s_loc - 1).long()
        for cache, new in ((ck, kn), (cv, vn)):
            new = new.to(cache.dtype)
            cache.index_put_((bidx, at),
                             torch.where(keep, new, cache[bidx, at]))

    cache_axes = ("batch", "seq_shard", "kv_flat")
    local_call(write, (cache_k, cache_v, k_new, v_new, cache_len),
               (cache_axes, cache_axes, ("batch", "kv_flat"),
                ("batch", "kv_flat"), ("batch",)), None, None)


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
