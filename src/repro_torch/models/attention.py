"""Attention with grouped-query heads: prefill and decode.

``attention`` dispatches on ``impl`` as the reference's does.  On a CUDA
tensor ``"blockwise"`` and ``"pallas"`` both launch the hand-written
``flash_attention`` kernel (the reference's blockwise XLA lowering is
"the same schedule" as its Pallas kernel, and the port has one kernel
for both); on a CPU tensor both run the kernel's plain version, the
online softmax over kv blocks.  ``"naive"`` is the plain full-matrix
version on any device.  ``decode_attention`` (one query token against a
KV cache) is plain torch, as it is plain XLA in the reference.

Products of bf16 inputs are taken in f32 (the reference's
``preferred_element_type=float32``); softmax weights are cast to v's
dtype before ``p . v``, which sums in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as FA

NEG_INF = -1e30


def blockwise_attention(q, k, v, *, causal: bool, block_q: int = 1024,
                        block_k: int = 1024, scale: Optional[float] = None):
    """q: [B, Sq, H, D]; k, v: [B, Sk, KV, D] -> [B, Sq, H, D].

    H must be a multiple of KV (GQA).  Block sizes are clamped to the
    sequence lengths; causal requires Sq == Sk and equal blocks, and the
    blocks must tile the sequences, as in the reference (the kernel's
    own tiles are fixed and mask the ragged edge).
    """
    Sq, Sk = q.shape[1], k.shape[1]
    bq = min(block_q, Sq)
    bk = min(block_k, Sk)
    if causal:
        assert Sq == Sk, "causal blockwise attention needs Sq == Sk"
        bq = bk = min(bq, bk)
    assert Sq % bq == 0 and Sk % bk == 0, (Sq, bq, Sk, bk)
    return FA.flash_attention(q, k, v, causal=causal, scale=scale)


def naive_attention(q, k, v, *, causal: bool, scale: Optional[float] = None):
    """Reference: full score matrix (small shapes / oracles only)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = q.float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("btkgd,bukd->bkgtu", qg, k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool,
                                     device=q.device), diagonal=Sk - Sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgtu,bukd->btkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def attention(q, k, v, *, causal: bool, impl: str = "blockwise",
              block_q: int = 1024, block_k: int = 1024,
              scale: Optional[float] = None):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, scale=scale)
    if impl not in ("blockwise", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return blockwise_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k, scale=scale)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     scale: Optional[float] = None, chunk: int = 0):
    """Single-token decode vs a KV cache.

    q: [B, H, D]; k_cache/v_cache: [B, S, KV, D]; cache_len: [B] int32
    (number of valid positions).  ``chunk`` > 0 walks the KV in chunks
    with an online softmax (the reference's long-context path); the
    reference's scanned and unrolled forms are one loop here.
    """
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = q.float().reshape(B, KV, G, D)
    valid = cache_len.reshape(B, 1, 1, 1)

    if chunk and S % chunk == 0 and S > chunk:
        m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, G, D), dtype=torch.float32,
                          device=q.device)
        for c0 in range(0, S, chunk):
            kb = k_cache[:, c0:c0 + chunk].float()
            vb = v_cache[:, c0:c0 + chunk]
            s = torch.einsum("bkgd,bukd->bkgu", qg, kb) * scale
            pos = torch.arange(c0, c0 + chunk, device=q.device)
            s = torch.where(pos < valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgu,bukd->bkgd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.reshape(B, H, D).to(q.dtype)

    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos < valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)
