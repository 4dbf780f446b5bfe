"""Mamba-2 SSD chunked scan: the sequence mixer of every Mamba layer's
prefill.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` (the Pallas TPU
kernel behind ``ops.ssd_scan``) and computes what the model's
``ssd_chunk_scan`` computes (``repro/models/mamba.py``, its XLA route):
xh ``[B, S, H, P]`` (f32 or bf16), dt ``[B, S, H]`` f32 (post-softplus),
A ``[H]`` f32 (negative), B_, C_ ``[B, S, N]`` in xh's dtype, chunks of
``Q = min(chunk, S)`` rows (``S % Q == 0``), all arithmetic in f32:

    dA = dt * A;  cum = cumsum(dA) within a chunk (inclusive)
    y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
          + exp(cum_i) (C_i . state)                  -> xh's dtype
    state' = exp(cum_last) state + sum_j B_j^T x_j exp(cum_last - cum_j) dt_j

The state starts from ``init_state`` ``[B, H, N, P]`` f32 (zeros when
absent) and its final value is returned when ``want_state``: the TPU
kernel returns ``y`` only and its callers recompute the state, but a
serving prefill carries it into decode, so the port's kernel writes it.

On the card it is ``csrc/ssd_scan.cu``: one CTA per (batch, head) walks
the chunks in order with the head's state in shared memory (the TPU
kernel carried all heads' state in VMEM across its innermost grid axis),
tiling each chunk by 64 query rows and 64 key rows at or below the
diagonal.  What bounds it: operations (~0.6 G multiply-adds at
mamba2-780m's prefill, 18 us at the f32 peak, against ~3 us of bytes);
this first kernel runs on the FMA units (``PERF.md``).

``ssd_scan_plain`` is the plain PyTorch version the wrapper takes for
CPU tensors: the reference's chunked einsums, one chunk at a time, with
the decay exponent masked to ``-inf`` above the diagonal before ``exp``
(the reference exponentiates the whole square and masks after), so no
``inf`` is formed and autograd through it stays finite.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("ssd_scan")

MAX_STATE = 128       # the largest d_state (N) the CUDA kernel takes
MAX_HEAD_DIM = 64     # the largest head dim (P)
MAX_CHUNK = 1024      # the largest chunk (Q)
_KERNELS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def _chunk_len(S: int, chunk: int) -> int:
    """The chunk the scan uses, ``min(chunk, S)``; raises unless it
    divides S (the reference asserts it)."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_scan: the chunk {Q} (min(chunk={chunk}, "
                         f"S={S})) does not divide S")
    return Q


def _check(xh, dt, A, B_, C_, init_state) -> None:
    if xh.dim() != 4:
        raise ValueError(f"ssd_scan takes xh [B, S, H, P], got "
                         f"{tuple(xh.shape)}")
    Bsz, S, H, P = xh.shape
    N = B_.shape[-1]
    want = {"dt": (dt, (Bsz, S, H)), "A": (A, (H,)),
            "B_": (B_, (Bsz, S, N)), "C_": (C_, (Bsz, S, N))}
    if init_state is not None:
        want["init_state"] = (init_state, (Bsz, H, N, P))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != xh.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, xh on "
                             f"{xh.device}")


def ssd_scan_plain(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 256,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference's chunk body, chunk by chunk.
    Returns ``(y [B, S, H, P] in xh's dtype, final_state [B, H, N, P]
    f32)``."""
    _check(xh, dt, A, B_, C_, init_state)
    Bsz, S, H, P = xh.shape
    N = B_.shape[-1]
    Q = _chunk_len(S, chunk)
    nc = S // Q
    xc = xh.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = B_.reshape(Bsz, nc, Q, N)
    Cc = C_.reshape(Bsz, nc, Q, N)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    A = A.float()
    state = (init_state.float() if init_state is not None
             else torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                              device=xh.device))
    ys = []
    for c in range(nc):
        x_q = xc[:, c].float()
        dt_q = dtc[:, c].float()
        b_q = Bc[:, c].float()
        c_q = Cc[:, c].float()
        cum = torch.cumsum(dt_q * A[None, None, :], dim=1)  # [B, Q, H]
        cb = torch.einsum("bin,bjn->bij", c_q, b_q)          # [B, Q, Q]
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # [B, Q, Q, H]
        decay = torch.exp(torch.where(tri[None, :, :, None], diff,
                                      float("-inf")))
        m = cb[..., None] * decay * dt_q[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", m, x_q)
        y_inter = torch.einsum("bin,bhnp->bihp", c_q, state) \
            * torch.exp(cum)[..., None]
        sdecay = torch.exp(cum[:, -1:, :] - cum) * dt_q       # [B, Q, H]
        s_new = torch.einsum("bjn,bjhp->bhnp", b_q,
                             x_q * sdecay[..., None])
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + s_new
        ys.append((y_intra + y_inter).to(xh.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, state


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None,
             want_state: bool = True
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chunked scan: ``(y, final_state)``, the state None unless
    ``want_state``.

    A CUDA tensor launches the kernel (xh, B_, C_ all f32 or all bf16;
    dt, A and init_state f32; contiguous; N <= 128, P <= 64, Q <= 1024;
    anything else raises); a CPU tensor takes the plain version.

    The kernel has no backward: on the card, an input that requires grad
    while grad mode is on raises (the kernel's output would carry no
    graph)."""
    _check(xh, dt, A, B_, C_, init_state)
    Bsz, S, H, P = xh.shape
    N = B_.shape[-1]
    Q = _chunk_len(S, chunk)
    if _lib.device_kind(xh) == "cpu":
        y, state = ssd_scan_plain(xh, dt, A, B_, C_, chunk=chunk,
                                  init_state=init_state)
        return y, (state if want_state else None)
    ins = [xh, dt, A, B_, C_] + ([init_state] if init_state is not None
                                 else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError(
            "ssd_scan: an input requires grad and the CUDA kernel has no "
            "backward")
    if xh.dtype not in _KERNELS or B_.dtype != xh.dtype \
            or C_.dtype != xh.dtype:
        raise ValueError(f"ssd_scan takes xh, B_, C_ all float32 or all "
                         f"bfloat16, not {xh.dtype}, {B_.dtype}, "
                         f"{C_.dtype}")
    if any(t.dtype != torch.float32 for t in ins[1:3] + ins[5:]):
        raise ValueError("ssd_scan takes dt, A and init_state in float32")
    if N > MAX_STATE or P > MAX_HEAD_DIM or Q > MAX_CHUNK:
        raise ValueError(f"ssd_scan takes N <= {MAX_STATE}, P <= "
                         f"{MAX_HEAD_DIM}, chunk <= {MAX_CHUNK}; got N={N}, "
                         f"P={P}, Q={Q}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_scan takes contiguous tensors")
    y = torch.empty_like(xh)
    state = (torch.empty((Bsz, H, N, P), dtype=torch.float32,
                         device=xh.device) if want_state else None)
    if y.numel() == 0:          # B, H or P is 0: the state is empty too
        return y, state
    _lib.launch(_KERNELS[xh.dtype], xh.device, xh.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                init_state.data_ptr() if init_state is not None else None,
                y.data_ptr(), state.data_ptr() if state is not None else None,
                Bsz, S, H, P, N, Q)
    launches.add()
    return y, state


__all__ = ["MAX_CHUNK", "MAX_HEAD_DIM", "MAX_STATE", "launches",
           "ssd_scan", "ssd_scan_plain"]
