"""Attention with grouped-query heads: prefill and decode.

``attention`` dispatches on ``impl`` as the reference's does.  On a CUDA
tensor ``"blockwise"`` and ``"pallas"`` both launch the hand-written
``flash_attention`` kernel (the reference's blockwise XLA lowering is
"the same schedule" as its Pallas kernel, and the port has one kernel
for both); on a CPU tensor both run the kernel's plain version, the
online softmax over kv blocks.  ``"naive"`` is the plain full-matrix
version on any device.  ``decode_attention`` (one query token against a
KV cache) is plain torch, as it is plain XLA in the reference.

Gradients.  The kernel has no backward (the reference has no attention
backward kernel either: its trainer differentiates the blockwise XLA
lowering), so wherever autograd needs one, ``attention`` goes through
``FlashAttentionFn``: its forward is the kernel wrapper as it stands
(the CUDA kernel on the card, the plain version on the CPU), its
backward the standard attention gradient in plain torch products
(``attention_backward``).  The bare CUDA wrapper refuses an input that
requires grad while grad mode is on, so no caller can get an output
that has silently lost its graph.

Products of bf16 inputs are taken in f32 (the reference's
``preferred_element_type=float32``); softmax weights are cast to v's
dtype before ``p . v``, which sums in f32.  q, k and v of mixed dtypes
(the encoder-decoder's bf16 decoder queries against a float32 encoder's
keys and values) are promoted as the reference's einsums promote them:
the kernel runs at the promoted dtype, and the output comes back in q's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.sharding import (Rules, current_rules, is_dtensor,
                                         local_call, mesh_coordinate,
                                         mesh_ways, placements)

NEG_INF = -1e30


def blockwise_attention(q, k, v, *, causal: bool, block_q: int = 1024,
                        block_k: int = 1024, scale: Optional[float] = None):
    """q: [B, Sq, H, D]; k, v: [B, Sk, KV, D] -> [B, Sq, H, D].

    H must be a multiple of KV (GQA).  Block sizes are clamped to the
    sequence lengths; causal requires Sq == Sk and equal blocks, and the
    blocks must tile the sequences, as in the reference (the kernel's
    own tiles are fixed and mask the ragged edge).  Where autograd
    needs a gradient it goes through ``FlashAttentionFn``.  Mixed dtypes
    run at ``torch.promote_types`` of the three (never a float32 k or v
    cast down), the output cast to q's dtype, as the reference's
    ``out.astype(q.dtype)``.
    """
    Sq, Sk = q.shape[1], k.shape[1]
    bq = min(block_q, Sq)
    bk = min(block_k, Sk)
    if causal:
        assert Sq == Sk, "causal blockwise attention needs Sq == Sk"
        bq = bk = min(bq, bk)
    assert Sq % bq == 0 and Sk % bk == 0, (Sq, bq, Sk, bk)
    out_dtype = q.dtype
    if not q.dtype == k.dtype == v.dtype:
        t = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                v.dtype)
        q, k, v = q.to(t), k.to(t), v.to(t)

    def run(q, k, v):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, causal, scale)
        return FA.flash_attention(q, k, v, causal=causal, scale=scale)

    return heads_call(run, q, k, v).to(out_dtype)


def heads_call(fn, q, k, v):
    """``fn(q, k, v)`` -> [B, Sq, H, D], on each rank's batch rows and
    heads when q is a DTensor (``sharding.local_call``; the heads split
    as ``_head_split`` says)."""
    if not is_dtensor(q):
        return fn(q, k, v)
    q_tp, kv_tp, cut = _head_split(q.device_mesh, q.shape[2], k.shape[2])
    qa = ("batch", None, q_tp, None)
    kva = ("batch", None, kv_tp, None)
    body = fn if cut == slice(None) else \
        (lambda q, k, v: fn(q, k[:, :, cut], v[:, :, cut]))
    return local_call(body, (q, k, v), (qa, kva, kva), qa, tuple(q.shape))


def _head_split(dm, H: int, KV: int):
    """How a sharded attention splits its heads over the rules' 'tp'
    axis: ``(q axis, kv axis, kv cut)``.  q's heads split when they
    divide evenly, k's and v's too when theirs do; when they do not
    (fewer kv heads than ways), each rank gets the kv heads its query
    heads read, cut (``kv cut``) from the replicated k and v.  Anything
    that does not split evenly stays whole on every rank."""
    tp = (current_rules() or Rules()).get("tp")
    ways = mesh_ways(dm, tp)
    if ways == 1 or H % ways:
        return None, None, slice(None)
    h_loc, group = H // ways, H // KV
    if KV % ways == 0:
        return "tp", "tp", slice(None)
    if h_loc % group and group % h_loc:
        return None, None, slice(None)
    m = mesh_coordinate(dm, tp)
    return "tp", None, slice((m * h_loc) // group,
                             ((m + 1) * h_loc - 1) // group + 1)


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


def attention_backward(q, k, v, o, do, *, causal: bool, scale: float):
    """``(dq, dk, dv)`` of ``o = attention(q, k, v)`` for the output
    gradient ``do``, in f32 products, cast to the inputs' dtypes.

    Recomputes ``S = q . k^T * scale`` under the forward's mask, then
    ``P = softmax(S)``, ``dV = P^T . dO``, ``dP = dO . V^T``,
    ``dS = P * (dP - rowsum(dO * O))``, ``dQ = dS . K * scale`` and
    ``dK = dS^T . Q * scale``; dK and dV are summed over the G query
    heads of each kv head."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV

    def heads(t):                                # [B, KV, G, Sq, D]
        return t.float().reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)

    qf, of, dof = heads(q), heads(o), heads(do)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]     # [B, KV, 1, Sk, D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(dim=2)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(dim=2) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the kernel wrapper forward
    (grad mode is off inside ``forward``), ``attention_backward``
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        scale = q.shape[3] ** -0.5 if scale is None else scale
        o = FA.flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, do, causal=ctx.causal,
                                        scale=ctx.scale)
        return dq, dk, dv, None, None


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
    reference's scanned and unrolled forms are one loop here.  A
    sharded cache is read shard by shard (``_decode_sharded``).
    """
    if is_dtensor(k_cache):
        return _decode_sharded(q, k_cache, v_cache, cache_len, scale, chunk)
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


def _decode_sharded(q, k_cache, v_cache, cache_len, scale, chunk):
    """``decode_attention`` of DTensors on each rank's batch rows and
    heads, as ``heads_call`` splits them.  A cache whose sequence is
    split (``seq_shard``, long-context decode) is read piece by piece:
    each rank's softmax statistics over its piece (max, sum, weighted
    values), the maxima reduced across the pieces, each piece's sums
    rescaled to the common max and summed — the online softmax across
    ranks."""
    from torch.distributed.tensor import Partial, Replicate

    rules = current_rules() or Rules()
    dm = k_cache.device_mesh
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    sc = scale if scale is not None else D ** -0.5
    seq_ax = rules.get("seq_shard")
    seq_ways = mesh_ways(dm, seq_ax)
    q_tp, kv_tp, cut = _head_split(dm, H, KV)
    qa, kva = ("batch", q_tp, None), ("batch", "seq_shard", kv_tp, None)

    def kv_heads(t):
        return t if cut == slice(None) else t[:, :, cut]

    ins = (qa, kva, kva, ("batch",))
    if seq_ways == 1:
        return local_call(
            lambda q, k, v, cl: decode_attention(
                q, kv_heads(k), kv_heads(v), cl, scale=scale, chunk=chunk),
            (q, k_cache, v_cache, cache_len), ins, qa, tuple(q.shape))

    off = mesh_coordinate(dm, seq_ax) * -(-S // seq_ways)

    def stats(q, k, v, cl):
        k, v = kv_heads(k), kv_heads(v)
        b, h, d = q.shape
        s_loc, kv = k.shape[1], k.shape[2]
        qg = q.float().reshape(b, kv, h // kv, d)
        s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * sc
        pos = off + torch.arange(s_loc, device=q.device)
        s = torch.where(pos < cl.reshape(b, 1, 1, 1), s, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(),
                           v.float())
        return m.reshape(b, h), p.sum(dim=-1).reshape(b, h), \
            acc.reshape(b, h, d)

    seq_dims = set()
    for ax in (seq_ax if isinstance(seq_ax, tuple) else (seq_ax,)):
        seq_dims.add(tuple(dm.mesh_dim_names).index(ax))
    base = placements(rules.spec(qa[:2]), dm)
    whole = tuple(Replicate() if i in seq_dims else p
                  for i, p in enumerate(base))

    def part(op):
        return tuple(Partial(op) if i in seq_dims else p
                     for i, p in enumerate(base))

    m, l, acc = local_call(stats, (q, k_cache, v_cache, cache_len), ins,
                           [part("max"), part("sum"), part("sum")],
                           [(B, H), (B, H), (B, H, D)])
    m_all = m.redistribute(dm, whole)

    def rescale(m, m_all, l, acc):
        corr = torch.exp(m - m_all)
        return l * corr, acc * corr[..., None]

    pm, ps = part("max"), part("sum")
    l, acc = local_call(rescale, (m, m_all, l, acc), (pm, whole, ps, ps),
                        [ps, ps], [(B, H), (B, H, D)])
    l, acc = l.redistribute(dm, whole), acc.redistribute(dm, whole)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
