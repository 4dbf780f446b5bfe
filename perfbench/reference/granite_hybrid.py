"""Granite 4.0-H (IBM's granite-4.0-h-small; ``GraniteMoeHybrid`` in
Hugging Face transformers), plain float32, one card's share of its
experts.

The stack, as published:
  - the token embedding times ``embedding_multiplier``;
  - each layer: x += r * mixer(rmsnorm(x)), then x += r * (moe(h) +
    shared(h)) with h = rmsnorm(x), r = ``residual_multiplier``;
  - the mixer is attention or Mamba-2 by ``layer_types``;
  - a final RMSNorm and the output head tied to the embedding, the
    logits divided by ``logits_scaling``.
Attention: grouped-query heads with no position embedding (``nope``),
no biases, causal, softmax scale ``attention_multiplier``.  Mamba-2: one
group of B and C, a causal depthwise convolution (width ``mamba_d_conv``,
with bias) over x, B and C followed by SiLU, dt = softplus(x W_dt +
dt_bias), A = -exp(A_log), the recurrence h_t = exp(dt_t A) h_{t-1} +
dt_t B_t x_t^T, y_t = C_t^T h_t + D x_t, gated as rmsnorm(y * silu(z))
over the whole inner width, then the out projection.  MoE: a bias-free
router over all ``num_local_experts_published`` experts, the top
``num_experts_per_tok`` logits of each token and the softmax over those,
SwiGLU experts of width ``intermediate_size``; no capacity, so no token
is dropped; a shared SwiGLU of width ``shared_intermediate_size``.

The share.  The weights hold ``num_local_experts`` experts, router
indices ``first_local_expert`` on; a token routed to an expert held
elsewhere gets nothing from it (its routing weight is not given to the
others), as on the card whose share this is.

Departures, as the benchmark's weights make them: the residual stream
is float32 here (the model's is bfloat16); the router's product is
float32.  A sequence runs the chunked form of the Mamba recurrence (the
paper's minimal SSD), padded at its end to a whole chunk (padding after
the last position changes no earlier one).  Attention is computed
exactly, a block of query rows at a time.  Layer weights are cast to
float32 as they are used.  The program's layout of the weights: layer i
is ``sub{i % P}`` of group ``i // P``, P the period of ``layer_types``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import layer, mm, rmsnorm

#: query rows a block of the attention
ROWS = 1024


def period(types) -> int:
    """The shortest period of the layer pattern that divides the depth."""
    n = len(types)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and types == types[:p] * (n // p))


def _attention(p, h, cfg, precision):
    """Causal NoPE attention of h [S, d] (float32)."""
    S = h.shape[0]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg["hidden_size"] // H
    q = mm(h, p["w_q"], precision).reshape(S, H, D)
    k = mm(h, p["w_k"], precision).reshape(S, KV, D)
    v = mm(h, p["w_v"], precision).reshape(S, KV, D)
    k = k.repeat_interleave(H // KV, dim=1).permute(1, 2, 0)  # [H, D, S]
    v = v.repeat_interleave(H // KV, dim=1).permute(1, 0, 2)  # [H, S, D]
    out = torch.empty_like(q)
    for lo in range(0, S, ROWS):
        hi = min(S, lo + ROWS)
        s = torch.einsum("qhd,hds->hqs", q[lo:hi], k[:, :, :hi]) \
            * cfg["attention_multiplier"]
        mask = torch.arange(hi, device=h.device)[None] \
            > torch.arange(lo, hi, device=h.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[lo:hi] = torch.einsum("hqs,hsd->qhd", torch.softmax(s, -1),
                                  v[:, :hi])
    return mm(out.reshape(S, H * D), p["w_o"], precision)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: entry (t, s) = a[s+1] + ... + a[t] for
    s <= t, -inf above the diagonal."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    x = x.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool,
                                             device=a.device), -1), 0.0)
    out = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int):
    """The recurrence in chunks.  x [S, H, P], dt [S, H], A [H], B and C
    [S, N]; S a multiple of the chunk.  Returns y [S, H, P]."""
    S, H, P = x.shape
    N = B.shape[-1]
    c = S // chunk
    X = (x * dt[..., None]).reshape(c, chunk, H, P)
    a = (dt * A).reshape(c, chunk, H).permute(2, 0, 1)          # [H, c, Q]
    Bc, Cc = B.reshape(c, chunk, N), C.reshape(c, chunk, N)
    acum = torch.cumsum(a, dim=-1)
    L = torch.exp(_segsum(a))                                   # [H,c,Q,Q]
    CB = torch.einsum("cln,csn->cls", Cc, Bc)
    y = torch.einsum("hcls,cshp->clhp", CB[None] * L, X)
    decay = torch.exp(acum[..., -1:] - acum)                    # [H, c, Q]
    states = torch.einsum("cln,hcl,clhp->chnp", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:1]), states])  # [c+1,...]
    edge = torch.exp(_segsum(F.pad(acum[..., -1], (1, 0))))     # [H,c+1,c+1]
    carried = torch.einsum("hzc,chnp->zhnp", edge, states)[:-1]
    y = y + torch.einsum("cln,chnp,hcl->clhp", Cc, carried, torch.exp(acum))
    return y.reshape(S, H, P)


def _conv(u, w, b):
    """Causal depthwise convolution of u [S, ch] with w [K, ch] and bias
    b [ch], then SiLU."""
    K, S = w.shape[0], u.shape[0]
    buf = F.pad(u, (0, 0, K - 1, 0))
    return F.silu(sum(buf[i:i + S] * w[i].float() for i in range(K))
                  + b.float())


def _mamba(p, h, cfg, precision):
    """One Mamba-2 mixer on h [S, d] (float32)."""
    S = h.shape[0]
    P, Q = cfg["mamba_d_head"], cfg["mamba_chunk_size"]
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    H = di // P
    z = mm(h, p["w_z"], precision)
    x = _conv(mm(h, p["w_x"], precision), p["conv_x"], p["conv_x_bias"])
    B = _conv(mm(h, p["w_B"], precision), p["conv_B"], p["conv_B_bias"])
    C = _conv(mm(h, p["w_C"], precision), p["conv_C"], p["conv_C_bias"])
    dt = F.softplus(mm(h, p["w_dt"], precision) + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    pad = -S % Q
    xh = F.pad(x, (0, 0, 0, pad)).reshape(S + pad, H, P)
    y = ssd(xh, F.pad(dt, (0, 0, 0, pad)), A, F.pad(B, (0, 0, 0, pad)),
            F.pad(C, (0, 0, 0, pad)), Q)[:S]
    y = y + xh[:S] * p["D"].float()[:, None]
    y = rmsnorm(y.reshape(S, di) * F.silu(z), p["norm"],
                cfg["rms_norm_eps"])
    return mm(y, p["w_out"], precision)


def _swiglu(h, w_gate, w_up, w_down, precision):
    return mm(F.silu(mm(h, w_gate, precision)) * mm(h, w_up, precision),
              w_down, precision)


def moe(p, h, cfg, precision):
    """The held experts' part of each token's top-k mixture over h [S, d]
    (float32), the shared expert's output beside it: (routed, shared)."""
    logits = mm(h, p["w_router"], precision)                   # [S, E]
    top, sel = torch.topk(logits, cfg["num_experts_per_tok"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(h)
    first = cfg["first_local_expert"]
    for j in range(cfg["num_local_experts"]):
        tok, k = torch.nonzero(sel == first + j, as_tuple=True)
        if tok.numel():
            out = _swiglu(h[tok], p["w_gate"][j], p["w_up"][j],
                          p["w_down"][j], precision)
            y.index_add_(0, tok, out * gates[tok, k][:, None])
    s = p["shared"]
    return y, _swiglu(h, s["w_gate"], s["w_up"], s["w_down"], precision)


@torch.no_grad()
def logits(w: dict, tokens: torch.Tensor, cfg: dict, first: int,
           precision: str = "f32") -> torch.Tensor:
    """tokens [S] -> logits [S - first, V] of positions first .. S-1."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    types = cfg["layer_types"]
    per = period(types)
    x = w["embed"][tokens.long()].float() * cfg["embedding_multiplier"]
    for i, kind in enumerate(types):
        p = layer(w["layers"], i // per)[f"sub{i % per}"]
        h = rmsnorm(x, p["norm_mixer"], eps)
        if kind == "attention":
            x = x + r * _attention(p["attn"], h, cfg, precision)
        else:
            x = x + r * _mamba(p["mamba"], h, cfg, precision)
        routed, shared = moe(p["moe"], rmsnorm(x, p["norm_ffn"], eps), cfg,
                             precision)
        x = x + r * (routed + shared)
    h = rmsnorm(x[first:], w["final_norm"], eps)
    return mm(h, w["embed"].T, precision) / cfg["logits_scaling"]
