"""Dense decoder (the LLaMA architecture of DeepSeek-LLM, arXiv:2401.02954),
plain float32: pre-RMSNorm, multi-head attention with rotary position
embeddings (the two halves of each head rotated as a pair, base
``rope_theta``), a SwiGLU feed-forward, a final RMSNorm and an untied
output head.  No biases.  Layer weights are cast to float32 as they are
used; attention is computed exactly, a block of query rows at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import layer, mm, rmsnorm

#: query rows a block of the attention
ROWS = 1024


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, D] at positions pos [S]."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = pos.float()[:, None] * inv                        # [S, D/2]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(q, k, v):
    """Causal attention of q, k, v [S, H, D] (float32)."""
    S, H, D = q.shape
    out = torch.empty_like(q)
    kt = k.permute(1, 2, 0)                                 # [H, D, S]
    vt = v.permute(1, 0, 2)                                 # [H, S, D]
    for lo in range(0, S, ROWS):
        hi = min(S, lo + ROWS)
        s = torch.einsum("qhd,hds->hqs", q[lo:hi], kt[:, :, :hi]) \
            * D ** -0.5
        mask = torch.arange(hi, device=q.device)[None] \
            > torch.arange(lo, hi, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[lo:hi] = torch.einsum("hqs,hsd->qhd", torch.softmax(s, -1),
                                  vt[:, :hi])
    return out


@torch.no_grad()
def logits(w: dict, tokens: torch.Tensor, cfg: dict, first: int,
           precision: str = "f32") -> torch.Tensor:
    """tokens [S] -> logits [S - first, V] of positions first .. S-1."""
    eps = cfg["rms_norm_eps"]
    H, dh = cfg["num_attention_heads"], cfg["head_dim"]
    KV = cfg["num_key_value_heads"]
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = w["embed"][tokens.long()].float()
    for i in range(cfg["num_hidden_layers"]):
        p = layer(w["layers"], i)["sub0"]
        h = rmsnorm(x, p["norm_mixer"], eps)
        a = p["attn"]
        q = _rope(mm(h, a["w_q"], precision).reshape(S, H, dh), pos,
                  cfg["rope_theta"])
        k = _rope(mm(h, a["w_k"], precision).reshape(S, KV, dh), pos,
                  cfg["rope_theta"])
        v = mm(h, a["w_v"], precision).reshape(S, KV, dh)
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
        x = x + mm(_attention(q, k, v).reshape(S, H * dh), a["w_o"],
                   precision)
        h = rmsnorm(x, p["norm_ffn"], eps)
        f = p["ffn"]
        g = mm(h, f["w_gate"], precision)
        x = x + mm(F.silu(g) * mm(h, f["w_up"], precision), f["w_down"],
                   precision)
    h = rmsnorm(x[first:], w["final_norm"], eps)
    head = w["embed"].T if cfg["tie_word_embeddings"] else w["lm_head"]
    return mm(h, head, precision)
