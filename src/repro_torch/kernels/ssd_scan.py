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

On the card it is ``csrc/ssd_scan.cu``: the SSD decomposition as four
launches on the one stream from one C call, with scratch (C.B^T, cum and
the chunk states) from one allocation (``_layout``):

  1. cb    per (batch, chunk, 64x64 tile pair at or below the diagonal):
           the chunk's C.B^T, once for all heads (``chunk_cb_plain``);
  2. state per (batch, chunk, head): cum and the chunk-local state
           B^T (x exp(cum_last - cum) dt) (``chunk_cum_plain``,
           ``chunk_state_plain``);
  3. fold  per (batch, head): the state entering each chunk, from
           ``init_state`` to the final state (``fold_plain``);
  4. out   per (batch, chunk, head, 64-row query tile): y
           (``output_plain``).

bf16 runs the products on the tensor cores (``mma.sync``, f32 sums; an
f32 operand split into bf16 hi + lo), f32 on the FMA units.  What bounds
it: bytes, once the products run on the tensor cores (~9.8 MB at
mamba2-780m's prefill against 0.6 G multiply-adds; ``PERF.md``).

``ssd_scan_plain`` is the plain PyTorch version the wrapper takes for
CPU tensors: the composition of the four plain stages, each the
reference's chunk einsums over every chunk at once, with the decay
exponent masked to ``-inf`` above the diagonal before ``exp`` (the
reference exponentiates the whole square and masks after), so no ``inf``
is formed and autograd through it stays finite.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("ssd_scan")

MAX_STATE = 128       # the largest d_state (N) the CUDA kernel takes
MAX_HEAD_DIM = 64     # the largest head dim (P)
MAX_CHUNK = 1024      # the largest chunk (Q)
_KERNELS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
#: the launches of one C call (``launch_stages``); a scan is all four
STAGE_CB, STAGE_STATE, STAGE_FOLD, STAGE_OUT = 1, 2, 4, 8
ALL_STAGES = 15


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


def _chunks(t: torch.Tensor, Q: int) -> torch.Tensor:
    """[B, S, ...] -> [B, nc, Q, ...]."""
    return t.reshape(t.shape[0], t.shape[1] // Q, Q, *t.shape[2:])


def chunk_cb_plain(B_: torch.Tensor, C_: torch.Tensor,
                   Q: int) -> torch.Tensor:
    """Stage 1: every chunk's C.B^T, ``[B, nc, Q, Q]`` f32 (the kernel
    computes the 64x64 tiles at or below the diagonal)."""
    return torch.einsum("bcin,bcjn->bcij", _chunks(C_, Q).float(),
                        _chunks(B_, Q).float())


def chunk_cum_plain(dt: torch.Tensor, A: torch.Tensor,
                    Q: int) -> torch.Tensor:
    """Stage 2's first half: the inclusive cumsum of ``dt * A`` within
    each chunk, ``[B, nc, H, Q]`` f32."""
    dA = _chunks(dt, Q).float() * A.float()[None, None, None, :]
    return torch.cumsum(dA, dim=2).transpose(2, 3).contiguous()


def chunk_state_plain(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                      cum: torch.Tensor, Q: int) -> torch.Tensor:
    """Stage 2: each chunk's local state, the state the chunk alone adds,
    ``sum_j B_j^T x_j exp(cum_last - cum_j) dt_j``, ``[B, nc, H, N, P]``
    f32."""
    sdecay = torch.exp(cum[..., -1:] - cum) \
        * _chunks(dt, Q).float().transpose(2, 3)           # [B, nc, H, Q]
    return torch.einsum("bcjn,bcjhp->bchnp", _chunks(B_, Q).float(),
                        _chunks(xh, Q).float()
                        * sdecay.transpose(2, 3)[..., None])


def fold_plain(local: torch.Tensor, cum: torch.Tensor,
               init_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 3: ``(state_in [B, nc, H, N, P], final [B, H, N, P])``, the
    state entering each chunk and after the last, from ``init_state``
    (zeros when absent): ``state' = state exp(cum_last) + local``."""
    Bsz, nc, H, N, P = local.shape
    state = (init_state.float() if init_state is not None
             else local.new_zeros((Bsz, H, N, P)))
    decay = torch.exp(cum[..., -1])                          # [B, nc, H]
    ins = []
    for c in range(nc):
        ins.append(state)
        state = state * decay[:, c, :, None, None] + local[:, c]
    return torch.stack(ins, dim=1), state


def output_plain(xh: torch.Tensor, dt: torch.Tensor, C_: torch.Tensor,
                 cb: torch.Tensor, cum: torch.Tensor, state_in: torch.Tensor,
                 Q: int) -> torch.Tensor:
    """Stage 4: ``y`` in xh's dtype, the chunk's own rows
    ``(CB o exp(cum_i - cum_j) o dt_j) x`` over j <= i (the exponent
    masked to -inf above the diagonal before ``exp``) plus the carried
    state's ``exp(cum_i) C_i . state_in``."""
    Bsz, S, H, P = xh.shape
    x = _chunks(xh, Q).float()                               # [B,nc,Q,H,P]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]             # [B,nc,H,Q,Q]
    decay = torch.exp(torch.where(tri, diff, float("-inf")))
    dtj = _chunks(dt, Q).float().transpose(2, 3)[..., None, :]
    m = cb[:, :, None] * decay * dtj                         # [B,nc,H,Q,Q]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", m, x)
    y_inter = torch.einsum("bcin,bchnp->bcihp", _chunks(C_, Q).float(),
                           state_in) \
        * torch.exp(cum).transpose(2, 3)[..., None]
    # contiguous, as the kernel writes y: with one chunk the reshape is a
    # view of the heads-major product, and a caller's later reshape would
    # copy on this route only
    return (y_intra + y_inter).to(xh.dtype).reshape(Bsz, S, H,
                                                    P).contiguous()


def ssd_scan_plain(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 256,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the four plain stages in order.  Returns
    ``(y [B, S, H, P] in xh's dtype, final_state [B, H, N, P] f32)``."""
    _check(xh, dt, A, B_, C_, init_state)
    Q = _chunk_len(xh.shape[1], chunk)
    cum = chunk_cum_plain(dt, A, Q)
    state_in, final = fold_plain(chunk_state_plain(xh, dt, B_, cum, Q), cum,
                                 init_state)
    y = output_plain(xh, dt, C_, chunk_cb_plain(B_, C_, Q), cum, state_in,
                     Q)
    return y, final


def _layout(Bsz: int, S: int, H: int, P: int, N: int, Q: int):
    """The scratch's parts, cb ``[B, nc, Qp, Qp]``, cum ``[B, nc, H, Q]``
    and the chunk states ``[B, nc, H, N, P]`` (``Qp``: Q rounded up to
    64), as ``(starts, shapes, total)`` in f32 elements, each part
    starting 16-byte aligned."""
    nc, Qp = S // Q, -(-Q // 64) * 64
    shapes = ((Bsz, nc, Qp, Qp), (Bsz, nc, H, Q), (Bsz, nc, H, N, P))
    starts, at = [], 0
    for shape in shapes:
        starts.append(at)
        at += -(-math.prod(shape) // 4) * 4
    return starts, shapes, at


def scratch(xh: torch.Tensor, N: int, Q: int) -> Tuple[torch.Tensor, ...]:
    """The kernel's scratch as views ``(cb, cum, states)`` of ONE f32
    allocation on xh's device (``_layout``)."""
    starts, shapes, total = _layout(*xh.shape, N, Q)
    buf = torch.empty(total, dtype=torch.float32, device=xh.device)
    return tuple(buf[a:a + math.prod(shape)].view(shape)
                 for a, shape in zip(starts, shapes))


def _launch(stages: int, xh, dt, A, B_, C_, init_state, y, final_state,
            work_ptrs, Q: int) -> None:
    """ONE C call that launches ``stages`` (bits of ``STAGE_*``) on
    checked CUDA tensors, with the scratch parts at ``work_ptrs``."""
    Bsz, S, H, P = xh.shape
    _lib.launch(_KERNELS[xh.dtype], xh.device, xh.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                init_state.data_ptr() if init_state is not None else None,
                y.data_ptr(),
                final_state.data_ptr() if final_state is not None else None,
                *work_ptrs, Bsz, S, H, P, B_.shape[-1], Q, stages)
    launches.add()


def launch_stages(stages: int, xh: torch.Tensor, dt: torch.Tensor,
                  A: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                  init_state: Optional[torch.Tensor], y: torch.Tensor,
                  final_state: Optional[torch.Tensor], work: Tuple, Q: int
                  ) -> None:
    """Launch the ``stages`` alone over ``work`` (``scratch(...)``): a
    single stage reads what the earlier stages, or the caller, left
    there (how each launch is held against its plain stage)."""
    _launch(stages, xh, dt, A, B_, C_, init_state, y, final_state,
            [t.data_ptr() for t in work], Q)


def work(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 256,
         init_state: Optional[torch.Tensor] = None, want_state: bool = True):
    """``(flops, bytes)`` of one call (``_lib.counted``): the flops
    ``FlopCounterMode`` counts over the plain version (its four chunk
    products over the whole Q x Q square: C.B^T, the chunk states, the
    chunk's own rows and the carried state's term), and the bytes of the
    kernel's bound: x, dt, A, B, C read, y written, and the initial and
    final states."""
    Bsz, S, H, P = xh.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    flops = 2 * Bsz * S * (Q * N + 2 * N * H * P + H * Q * P)
    nbytes = (2 * xh.numel() * xh.element_size()
              + 4 * (dt.numel() + A.numel() + 2 * Bsz * H * N * P)
              + 2 * B_.numel() * B_.element_size())
    return flops, nbytes


@_lib.counted("ssd_scan", work)
def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None,
             want_state: bool = True
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chunked scan: ``(y, final_state)``, the state None unless
    ``want_state``.

    A CUDA tensor launches the kernel (xh, B_, C_ all f32 or all bf16;
    dt, A and init_state f32; contiguous; N <= 128, P <= 64, Q <= 1024;
    anything else raises); a CPU tensor takes the plain version; a fake
    CUDA tensor (the dry run's) gets the kernel's outputs made and
    nothing computed.

    The kernel has no backward: on the card, an input that requires grad
    while grad mode is on raises (the kernel's output would carry no
    graph)."""
    _check(xh, dt, A, B_, C_, init_state)
    Bsz, S, H, P = xh.shape
    N = B_.shape[-1]
    Q = _chunk_len(S, chunk)
    kind = _lib.device_kind(xh)
    if kind == "cpu":
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
    if kind == "fake" or y.numel() == 0:   # B, H or P 0: no state either
        return y, state
    starts, _, total = _layout(Bsz, S, H, P, N, Q)
    # held until the launches are enqueued: a block freed earlier could be
    # handed to another thread's work first
    work = torch.empty(total, dtype=torch.float32, device=xh.device)
    _launch(ALL_STAGES, xh, dt, A, B_, C_, init_state, y, state,
            [work.data_ptr() + 4 * a for a in starts], Q)
    return y, state


__all__ = ["ALL_STAGES", "MAX_CHUNK", "MAX_HEAD_DIM", "MAX_STATE",
           "STAGE_CB", "STAGE_FOLD", "STAGE_OUT", "STAGE_STATE",
           "chunk_cb_plain", "chunk_cum_plain", "chunk_state_plain",
           "fold_plain", "launch_stages", "launches", "output_plain",
           "scratch", "ssd_scan", "ssd_scan_plain", "work"]
