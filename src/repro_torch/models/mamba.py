"""Mamba-2 SSD (state-space duality) mixer, chunked-scan formulation.

The counterpart of the reference's ``models/mamba.py``.  Prefill runs the
chunked SSD scan (``kernels/ssd_scan``: the hand-written CUDA kernel for
a CUDA tensor, the plain chunked einsums for a CPU tensor), which also
returns the final state a prefill carries into decode; decode is the O(1)
recurrent update in plain torch ops, as the reference runs it in XLA.
The rounding points are the reference's: the conv and silu in f32 cast
to the model dtype, ``dt`` in f32, ``y`` out of the scan in xh's dtype
with the D skip added in that dtype, then the gate and the norm.

Training goes through ``SSDScanFn``: its forward is the kernel wrapper
(the plain version on the CPU), its backward ``ssd_scan_bwd``: the
hand-written backward kernel on the card (the reference differentiates
its XLA lowering and has none), the plain chunked scan's gradient,
recomputed in torch, on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig
from repro_torch.kernels import ssd_scan as SS
from repro_torch.launch.sharding import (ParamMeta, is_dtensor, local_call,
                                         shard_act, split_heads, torch_dtype)
from repro_torch.models.common import matmul, rmsnorm, rmsnorm_meta
from repro_torch.runtime import spans

class SSMDims(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int


def ssm_dims(d_model: int, cfg: MambaConfig) -> SSMDims:
    d_inner = cfg.expand * d_model
    if d_inner % cfg.head_dim:
        raise ValueError(f"d_inner {d_inner} is not a multiple of head_dim "
                         f"{cfg.head_dim}")
    return SSMDims(d_inner, d_inner // cfg.head_dim, cfg.head_dim,
                   cfg.d_state)


def mamba_meta(d_model: int, cfg: MambaConfig, dtype: str) -> dict:
    dims = ssm_dims(d_model, cfg)
    di, h, n = dims.d_inner, dims.n_heads, dims.d_state
    return {
        "w_z": ParamMeta((d_model, di), ("fsdp", "tp"), dtype=dtype),
        "w_x": ParamMeta((d_model, di), ("fsdp", "tp"), dtype=dtype),
        "w_B": ParamMeta((d_model, n), ("fsdp", None), dtype=dtype),
        "w_C": ParamMeta((d_model, n), ("fsdp", None), dtype=dtype),
        "w_dt": ParamMeta((d_model, h), ("fsdp", "tp"), dtype=dtype),
        "conv_x": ParamMeta((cfg.d_conv, di), (None, "tp"), init="normal",
                            scale=0.5, dtype="float32"),
        "conv_B": ParamMeta((cfg.d_conv, n), (None, None), init="normal",
                            scale=0.5, dtype="float32"),
        "conv_C": ParamMeta((cfg.d_conv, n), (None, None), init="normal",
                            scale=0.5, dtype="float32"),
        "A_log": ParamMeta((h,), ("tp",), init="zeros", dtype="float32"),
        "D": ParamMeta((h,), ("tp",), init="ones", dtype="float32"),
        "dt_bias": ParamMeta((h,), ("tp",), init="zeros", dtype="float32"),
        "norm": rmsnorm_meta(di),
        "w_out": ParamMeta((di, d_model), ("tp", "fsdp"), dtype=dtype),
    }


def _causal_conv(x, w, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: [B, S, C]; w: [K, C].

    With ``state`` ([B, K-1, C], previous raw inputs) performs the decode
    step (S == 1) and returns (y, new_state); otherwise returns y — of a
    DTensor x, on each rank's batch rows and channels (the conv is
    depthwise: a channel never reads another)."""
    k = w.shape[0]
    if state is not None:
        buf = torch.cat([state, x], dim=1)                  # [B, K, C]
        y = torch.einsum("bkc,kc->bc", buf.float(), w.float())[:, None, :]
        return y.to(x.dtype), buf[:, 1:]
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        xs = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                   for p in x.placements)
        ws = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2
                   else Replicate() for p in xs)
        return local_call(_causal_conv, (x, w), (xs, ws), xs,
                          tuple(x.shape))
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = sum(pad[:, i:i + x.shape[1]].float() * w[i].float()
            for i in range(k))
    return y.to(x.dtype)


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` with a gradient: the kernel wrapper forward (grad mode
    is off inside ``forward``), which keeps the kernel's scratch (cum,
    C.B^T and the state entering each chunk) for the backward, and
    ``ssd_scan_bwd`` backward: on the card the backward kernel, which
    reads that scratch and keeps the [B, nc, H, Q, Q] squares on chip; on
    the CPU (and for f32 on the card) the plain chunked scan recomputed
    and differentiated."""

    @staticmethod
    def forward(ctx, xh, dt, A, B_, C_, init_state, chunk: int,
                want_state: bool):
        y, final, kept = SS.ssd_scan(xh, dt, A, B_, C_, chunk=chunk,
                                     init_state=init_state,
                                     want_state=want_state,
                                     keep_scratch=True)
        ctx.save_for_backward(xh, dt, A, B_, C_, init_state)
        ctx.chunk, ctx.kept = chunk, kept
        return y, final

    @staticmethod
    @spans.spanned("ssd.backward")
    def backward(ctx, dy, dfinal):
        kept, ctx.kept = ctx.kept, None      # freed with the call
        grads = SS.ssd_scan_bwd(
            *ctx.saved_tensors, dy.contiguous(),
            None if dfinal is None else dfinal.contiguous(),
            chunk=ctx.chunk, needs=ctx.needs_input_grad[:6], saved=kept)
        return (*grads, None, None)


def ssd_chunk_scan(xh, dt, A, B_, C_, *, chunk: int, init_state=None,
                   want_state: bool = True):
    """Chunked SSD scan.  xh: [B, S, H, P]; dt: [B, S, H] (post-softplus);
    A: [H] (negative); B_, C_: [B, S, N].  Returns (y [B, S, H, P],
    final_state [B, H, N, P] or None unless ``want_state``).  A CUDA
    tensor runs the ``ssd_scan`` kernel, a CPU tensor its plain version;
    when autograd records (grad mode on, an input requires grad) the
    call goes through ``SSDScanFn``.
    """
    def run(xh, dt, A, B_, C_, init_state):
        ins = (xh, dt, A, B_, C_, init_state)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in ins):
            return SSDScanFn.apply(*ins, chunk, want_state)
        return SS.ssd_scan(xh, dt, A, B_, C_, chunk=chunk,
                           init_state=init_state, want_state=want_state)

    # sharded: each rank scans its batch rows and heads ('tp')
    Bsz, _, H, P = xh.shape
    st = ("batch", "tp", None, None)
    return local_call(
        run, (xh, dt, A, B_, C_, init_state),
        (("batch", None, "tp", None), ("batch", None, "tp"), ("tp",),
         ("batch", None, None), ("batch", None, None), st),
        [("batch", None, "tp", None), st],
        [tuple(xh.shape), (Bsz, H, B_.shape[-1], P)])


def ssd_decode_step(state, x, dt, A, B_, C_):
    """O(1) recurrent step.  state: [B, H, N, P]; x: [B, H, P];
    dt: [B, H]; B_, C_: [B, N].  Returns (y [B, H, P], new_state)."""
    dA = torch.exp(dt * A[None, :])                         # [B, H]
    upd = torch.einsum("bn,bhp->bhnp", B_.float(),
                       x.float() * dt[..., None])
    state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bhnp,bn->bhp", state, C_.float())
    return y.to(x.dtype), state


class MambaState(NamedTuple):
    ssm: torch.Tensor      # [B, H, N, P] f32
    conv_x: torch.Tensor   # [B, K-1, d_inner]
    conv_B: torch.Tensor   # [B, K-1, N]
    conv_C: torch.Tensor   # [B, K-1, N]


def mamba_init_state(batch: int, d_model: int, cfg: MambaConfig, dtype,
                     device=None) -> MambaState:
    dims = ssm_dims(d_model, cfg)
    k = cfg.d_conv - 1
    dt = torch_dtype(dtype)
    return MambaState(
        ssm=torch.zeros((batch, dims.n_heads, dims.d_state, dims.head_dim),
                        dtype=torch.float32, device=device),
        conv_x=torch.zeros((batch, k, dims.d_inner), dtype=dt,
                           device=device),
        conv_B=torch.zeros((batch, k, dims.d_state), dtype=dt,
                           device=device),
        conv_C=torch.zeros((batch, k, dims.d_state), dtype=dt,
                           device=device),
    )


def mamba_apply(params, x, cfg: MambaConfig, *, rms_eps: float = 1e-5,
                state: Optional[MambaState] = None):
    """Mamba-2 block.  x: [B, S, d].

    Sequence mode (state=None): returns y [B, S, d].
    With ``state``: decode when S == 1, else a prefill that starts from
    the state; returns (y, new_state)."""
    Bsz, S, d = x.shape
    dims = ssm_dims(d, cfg)
    H, Pd = dims.n_heads, dims.head_dim

    z = matmul(x, params["w_z"])                           # [B, S, di]
    xr = matmul(x, params["w_x"])
    br = matmul(x, params["w_B"])
    cr = matmul(x, params["w_C"])
    dt_raw = matmul(x, params["w_dt"])                     # [B, S, H]
    z = shard_act(z, ("batch", None, "tp"))
    xr = shard_act(xr, ("batch", None, "tp"))

    decode = state is not None and S == 1
    if decode:
        xc, conv_x = _causal_conv(xr, params["conv_x"], state.conv_x)
        bc, conv_B = _causal_conv(br, params["conv_B"], state.conv_B)
        cc, conv_C = _causal_conv(cr, params["conv_C"], state.conv_C)
    else:
        xc = _causal_conv(xr, params["conv_x"])
        bc = _causal_conv(br, params["conv_B"])
        cc = _causal_conv(cr, params["conv_C"])
    xc = F.silu(xc.float()).to(x.dtype)
    bc = F.silu(bc.float()).to(x.dtype)
    cc = F.silu(cc.float()).to(x.dtype)

    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"].float())                # [H], negative
    xh = split_heads(xc, H, Pd)

    if decode:
        y1, ssm = ssd_decode_step(state.ssm, xh[:, 0], dt[:, 0], A,
                                  bc[:, 0], cc[:, 0])
        y = y1[:, None]                                    # [B, 1, H, P]
        new_state = MambaState(ssm, conv_x, conv_B, conv_C)
    else:
        y, final = ssd_chunk_scan(
            xh, dt, A, bc, cc, chunk=cfg.chunk,
            init_state=state.ssm if state is not None else None,
            want_state=state is not None)
        new_state = (MambaState(final, *_tail_conv(xr, br, cr, cfg))
                     if state is not None else None)

    y = y + xh.float().to(y.dtype) \
        * params["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(Bsz, S, dims.d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm(y, params["norm"], rms_eps)
    out = shard_act(matmul(y, params["w_out"]), ("batch", None, None))
    if state is not None:
        return out, new_state
    return out


def _tail_conv(xr, br, cr, cfg: MambaConfig):
    k = cfg.d_conv - 1
    return xr[:, -k:], br[:, -k:], cr[:, -k:]
