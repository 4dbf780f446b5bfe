"""Shared model components: RMSNorm, rotary position embeddings, the
loss and JAX's promotion of a mixed-dtype product.

The norm and RoPE compute in float32 and cast back to the input's dtype,
exactly as the reference's ``models/common.py`` does; the cross entropy
is taken in float32.
"""
from __future__ import annotations

import torch

from repro_torch.launch.sharding import (ParamMeta, is_dtensor, local_call,
                                         local_range)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under JAX's type promotion: where the dtypes differ (a
    float32 frame embedding against bf16 weights, or bf16 frames against
    float32 weights), the narrower operand is cast up to
    ``torch.promote_types`` of the two, as ``jnp.matmul`` does; torch's
    ``@`` refuses mixed dtypes.

    A DTensor ``a`` times a 2-D DTensor weight ``b`` is taken shard by
    shard (``_sharded_matmul``)."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    if is_dtensor(a) and is_dtensor(b) and b.dim() == 2 and a.dim() >= 2:
        return _sharded_matmul(a, b)
    return a @ b


def _sharded_matmul(x, w):
    """``x @ w`` for DTensors x [..., k] and w [k, n], as Megatron and
    ZeRO-3 lay it out, mesh dim by mesh dim: where x's rows are split
    (batch), w is gathered there (its FSDP gather) and the result's rows
    stay split; where w splits its input dim (row parallel), x's last dim
    is split alike and the result is a partial sum; where w splits its
    output dim (column parallel), x's last dim is whole and the result's
    last dim is split.  Each rank then multiplies its local pieces
    (``sharding.local_call``), forward and backward, so no product is
    computed twice on two ranks of the mesh — a layout DTensor's own
    choice per operation does not promise, its backward least."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    last = x.dim() - 1
    layout = []                         # (x, w, result) a mesh dim
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim < last:      # rows split
            layout.append((xp, Replicate(), xp))
        elif isinstance(wp, Shard) and wp.dim == 1:      # column parallel
            layout.append((Replicate(), wp, Shard(last)))
        elif isinstance(wp, Shard) or (isinstance(xp, Shard)
                                       and xp.dim == last):
            layout.append((Shard(last), Shard(0), Partial()))  # row par.
        else:
            layout.append((Replicate(),) * 3)
    xs, ws, outs = zip(*layout)
    return local_call(lambda a, b: a @ b, (x, w), (xs, ws), outs,
                      tuple(x.shape[:-1]) + (w.shape[1],))


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
    label_logit = _label_logit(lf, labels)
    nll = lse - label_logit
    loss = torch.mean(nll)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse * lse)
    return loss


def _label_logit(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lf[..., labels]``.  Of a DTensor whose vocab (last) dim is
    sharded, each rank picks the labels its vocab piece holds and the
    pieces sum (a ``Partial`` result: the vocab-parallel cross entropy's
    gather, where a whole-vocab gather would gather the logits)."""
    def pick(lf, labels):
        return torch.gather(lf, -1, labels.long()[..., None])[..., 0]

    if not is_dtensor(lf):
        return pick(lf, labels)
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = lf.dim() - 1
    vocab = {i for i, p in enumerate(lf.placements)
             if isinstance(p, Shard) and p.dim == last}
    if not vocab:
        return pick(lf, labels)
    off, _ = local_range(lf, last)

    def pick_local(lf, labels):
        idx = labels.long() - off
        inside = (idx >= 0) & (idx < lf.shape[-1])
        v = torch.gather(lf, -1, idx.clamp(0, max(lf.shape[-1] - 1, 0))
                         [..., None])[..., 0]
        return torch.where(inside, v, torch.zeros_like(v))

    lab_pl = tuple(Replicate() if i in vocab else p
                   for i, p in enumerate(lf.placements))
    out_pl = tuple(Partial() if i in vocab else p
                   for i, p in enumerate(lf.placements))
    return local_call(pick_local, (lf, labels),
                      (tuple(lf.placements), lab_pl), out_pl,
                      tuple(labels.shape))


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())


def model_flops_per_token(n_params_active: int) -> int:
    """The 6*N rule (fwd+bwd) per token; callers scale by tokens/step."""
    return 6 * n_params_active
