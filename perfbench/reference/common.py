"""Pieces both references share: the projections in either precision,
RMSNorm, the loss."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fake_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (float32) rounded to float8 e4m3 with one scale per slice
    along ``dim`` (the slice's largest magnitude maps to 448), back in
    float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x [..., k] @ w [k, n]`` in float32, or with both operands rounded
    to e4m3 first (``precision == "fp8"``)."""
    x = x.float()
    w = w.float()
    if precision == "fp8":
        x = fake_e4m3(x, -1)
        w = fake_e4m3(w, 0)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * w.float()


def xent(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
         z_loss: float) -> torch.Tensor:
    """Mean cross entropy over every position, the padded vocabulary rows
    left out, plus ``z_loss`` times the mean squared log-normaliser."""
    lf = logits.float()[..., :vocab]
    lse = torch.logsumexp(lf, dim=-1)
    nll = lse - torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return nll.mean() + z_loss * (lse * lse).mean()


def layer(w: dict, i: int) -> dict:
    """Layer ``i``'s slice of a nested dict of stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in w.items()}
