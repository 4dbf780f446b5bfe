"""Mamba-2 language model (Dao and Gu, arXiv:2405.21060), plain float32.

Per layer: x + out(norm(ssd(conv(x W_x)) + D x) * silu(x W_z))) on the
RMS-normalised residual, the SSD recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t,

dt_t = softplus(x W_dt + dt_bias), A = -exp(A_log), one group of B and C,
and causal depthwise convolutions (width ``d_conv``, no bias) over x, B
and C, each followed by SiLU.  Embeddings are tied to the output head.
Departures from the published model, as the benchmark's weights make
them: no convolution bias and no projection bias (the released model
has a convolution bias), and the residual stream is float32 here.

A sequence runs the chunked form of the same recurrence (the paper's
minimal SSD: a causal decay matrix inside a chunk, states carried across
chunks), a single token the recurrence itself.  Layer weights are cast
to float32 as they are used.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import layer, mm, rmsnorm, xent


class Dims(NamedTuple):
    d: int
    di: int
    H: int
    P: int
    N: int
    K: int
    chunk: int
    eps: float
    vocab: int


def dims(cfg: dict) -> Dims:
    d = cfg["d_model"]
    di = cfg["expand"] * d
    return Dims(d, di, di // cfg["headdim"], cfg["headdim"],
                cfg["d_state"], cfg["d_conv"], cfg["chunk_size"],
                cfg["rms_eps"], cfg["vocab_size"])


class State(NamedTuple):
    """One layer's decode state: h [B, H, N, P] and the last K-1 raw
    inputs of each convolution."""
    h: torch.Tensor
    conv_x: torch.Tensor
    conv_B: torch.Tensor
    conv_C: torch.Tensor


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: entry (t, s) = a[s+1] + ... + a[t] for
    s <= t, -inf above the diagonal."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                  device=a.device), -1)
    x = x.masked_fill(~below, 0.0)
    out = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int, h0: Optional[torch.Tensor] = None):
    """x [b, S, H, P], dt [b, S, H], A [H], B and C [b, S, N]; S a
    multiple of the chunk (or shorter than one).  Returns (y [b, S, H, P],
    final state [b, H, N, P])."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    c = S // Q
    X = (x * dt[..., None]).reshape(b, c, Q, H, P)
    a = (dt * A).reshape(b, c, Q, H).permute(0, 3, 1, 2)     # [b, H, c, Q]
    Bc = B.reshape(b, c, Q, N)
    Cc = C.reshape(b, c, Q, N)
    acum = torch.cumsum(a, dim=-1)
    L = torch.exp(_segsum(a))                                # [b,H,c,Q,Q]
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, X)
    decay = torch.exp(acum[..., -1:] - acum)                 # [b,H,c,Q]
    states = torch.einsum("bcln,bhcl,bclhp->bchnp", Bc, decay, X)
    if h0 is None:
        h0 = torch.zeros(b, H, N, P, dtype=x.dtype, device=x.device)
    states = torch.cat([h0[:, None], states], dim=1)         # [b,c+1,...]
    edge = torch.exp(_segsum(F.pad(acum[..., -1], (1, 0))))  # [b,H,c+1,c+1]
    states = torch.einsum("bhzc,bchnp->bzhnp", edge, states)
    carried, final = states[:, :-1], states[:, -1]
    y = y + torch.einsum("bcln,bchnp,bhcl->bclhp", Cc, carried,
                         torch.exp(acum))
    return y.reshape(b, S, H, P), final


def _conv(u, w, prev=None):
    """Causal depthwise convolution of u [b, S, ch] with w [K, ch]; ``prev``
    [b, K-1, ch] holds the inputs before u (zeros if None)."""
    K = w.shape[0]
    if prev is None:
        prev = u.new_zeros(u.shape[0], K - 1, u.shape[2])
    buf = torch.cat([prev, u], dim=1)
    S = u.shape[1]
    return sum(buf[:, i:i + S] * w[i] for i in range(K)), buf[:, -(K - 1):]


def mixer(p: dict, h: torch.Tensor, dm: Dims, precision: str,
          state: Optional[State] = None):
    """One Mamba-2 mixer on normalised input h [b, S, d] (float32).  Runs
    the chunked scan from ``state`` (zeros if None) and returns (y, the
    state after the last position)."""
    b, S, _ = h.shape
    z = mm(h, p["w_z"], precision)
    xr = mm(h, p["w_x"], precision)
    br = mm(h, p["w_B"], precision)
    cr = mm(h, p["w_C"], precision)
    dtr = mm(h, p["w_dt"], precision)
    st = state
    xc, tx = _conv(xr, p["conv_x"].float(), st and st.conv_x)
    bc, tb = _conv(br, p["conv_B"].float(), st and st.conv_B)
    cc, tc = _conv(cr, p["conv_C"].float(), st and st.conv_C)
    xc, bc, cc = F.silu(xc), F.silu(bc), F.silu(cc)
    dt = F.softplus(dtr + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xc.reshape(b, S, dm.H, dm.P)
    if S == 1 and st is not None:
        dA = torch.exp(dt[:, 0] * A)                          # [b, H]
        hN = st.h * dA[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", bc[:, 0], xh[:, 0] * dt[:, 0, :, None])
        y = torch.einsum("bhnp,bn->bhp", hN, cc[:, 0])[:, None]
    else:
        y, hN = ssd(xh, dt, A, bc, cc, dm.chunk, st and st.h)
    y = y + xh * p["D"].float()[:, None]
    y = y.reshape(b, S, dm.di) * F.silu(z)
    y = rmsnorm(y, p["norm"], dm.eps)
    return mm(y, p["w_out"], precision), State(hN, tx, tb, tc)


def _block(p, x, dm, precision):
    y, _ = mixer(p["mamba"], rmsnorm(x, p["norm_mixer"], dm.eps), dm,
                 precision)
    return x + y


def logits_of(w: dict, h: torch.Tensor, dm: Dims, precision: str):
    h = rmsnorm(h, w["final_norm"], dm.eps)
    return mm(h, w["embed"].T, precision)


def loss(w: dict, tokens: torch.Tensor, labels: torch.Tensor, cfg: dict,
         precision: str = "f32") -> torch.Tensor:
    """Training loss over tokens [b, S]: each layer checkpointed (its
    input kept, the layer recomputed in the backward), so a full-width
    batch fits in float32."""
    dm = dims(cfg)
    x = w["embed"][tokens.long()].float()
    for i in range(cfg["n_layer"]):
        x = checkpoint(_block, layer(w["layers"], i)["sub0"], x, dm,
                       precision, use_reentrant=False)
    return xent(logits_of(w, x, dm, precision), labels, dm.vocab,
                cfg["z_loss"])


@torch.no_grad()
def prefill(w: dict, tokens: torch.Tensor, cfg: dict,
            precision: str = "f32"):
    """tokens [b, S] -> (logits of the last position [b, V], the states of
    every layer)."""
    dm = dims(cfg)
    x = w["embed"][tokens.long()].float()
    states: List[State] = []
    for i in range(cfg["n_layer"]):
        p = layer(w["layers"], i)["sub0"]
        y, st = mixer(p["mamba"], rmsnorm(x, p["norm_mixer"], dm.eps), dm,
                      precision)
        x = x + y
        states.append(st)
    return logits_of(w, x[:, -1:], dm, precision)[:, 0], states


@torch.no_grad()
def decode(w: dict, token: torch.Tensor, states: List[State], cfg: dict,
           precision: str = "f32"):
    """One token [b] through every layer's recurrence -> (logits [b, V],
    the new states)."""
    dm = dims(cfg)
    x = w["embed"][token.long()][:, None].float()
    out = []
    for i, st in enumerate(states):
        p = layer(w["layers"], i)["sub0"]
        y, st = mixer(p["mamba"], rmsnorm(x, p["norm_mixer"], dm.eps), dm,
                      precision, st)
        x = x + y
        out.append(st)
    return logits_of(w, x, dm, precision)[:, 0], out
