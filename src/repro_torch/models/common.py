"""Shared model components: RMSNorm, rotary position embeddings, the
loss and JAX's promotion of a mixed-dtype product.

The norm and RoPE compute in float32 and cast back to the input's dtype,
exactly as the reference's ``models/common.py`` does; the cross entropy
is taken in float32.
"""
from __future__ import annotations

import torch

from repro_torch.launch.sharding import ParamMeta


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under JAX's type promotion: where the dtypes differ (a
    float32 frame embedding against bf16 weights, or bf16 frames against
    float32 weights), the narrower operand is cast up to
    ``torch.promote_types`` of the two, as ``jnp.matmul`` does; torch's
    ``@`` refuses mixed dtypes."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


def rmsnorm_meta(d: int) -> ParamMeta:
    return ParamMeta((d,), (None,), init="ones", dtype="float32")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # [D/2]
    ang = positions[..., None].float() * freqs             # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int, z_loss: float = 1e-4) -> torch.Tensor:
    """Mean cross entropy in f32 over logits ``[..., V_padded]``.

    ``vocab_size`` masks the padded vocab rows with -1e30, and ``z_loss``
    adds ``z * mean(lse^2)``, as the reference.  The label logit is taken
    with ``gather`` where the reference contracts with a one-hot (its
    other terms are exact zeros, so the values are the same); a one-hot
    of qwen2.5-3b's 152,064-row vocab would be B*S*152064 f32."""
    lf = logits.float()
    pad = lf.shape[-1] - vocab_size
    if pad > 0:
        mask = torch.arange(lf.shape[-1], device=lf.device) < vocab_size
        lf = torch.where(mask, lf, -1e30)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    shifted = lf - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    label_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    loss = torch.mean(nll)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse * lse)
    return loss


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())


def model_flops_per_token(n_params_active: int) -> int:
    """The 6*N rule (fwd+bwd) per token; callers scale by tokens/step."""
    return 6 * n_params_active
