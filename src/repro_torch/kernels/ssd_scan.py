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

The gradient is ``ssd_scan_bwd``: on the card ``csrc/ssd_scan_bwd.cu``
(bf16), five launches from one C call over the forward's scratch (cum,
C.B^T and the state entering each chunk), which ``ssd_scan(...,
keep_scratch=True)`` hands back:

  a. dstate per (batch, chunk, head): the chunk's outputs' pull on the
            state entering it (``bwd_dstate_plain``);
  b. fold   per (batch, head): the state's gradient walked back over the
            chunks (``bwd_fold_plain``);
  c. dx     per (batch, chunk, head, 64-row key tile): dx and dt's and
            cum's pulls by row (``bwd_dx_plain``);
  d. dbc    per (batch, chunk, 64-row tile): dB or dC summed over the
            heads (``bwd_dbc_plain``);
  e. dt     per head: cum's gradient, its reverse cumsum, ddt and dA
            (``bwd_dt_plain``).

``ssd_scan_bwd_staged`` composes the plain launches; ``ssd_scan_bwd_plain``
(autograd through the recomputed plain scan) is the CPU route, and the
card's for f32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("ssd_scan")
#: backward kernel launches (one C call, five launches), one a call
bwd_launches = _lib.LaunchCounter("ssd_scan_bwd")
#: backward calls on the card with f32 inputs, which take the plain
#: backward (the kernel is bf16 only)
bwd_f32_plain = _lib.LaunchCounter("ssd_scan_bwd_f32_plain")

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


def bwd_dstate_plain(dy: torch.Tensor, C_: torch.Tensor, cum: torch.Tensor,
                     Q: int) -> torch.Tensor:
    """Backward launch a: each chunk's outputs' pull on the state entering
    it, ``D[c] = sum_i exp(cum_i) C_i^T dy_i``, ``[B, nc, H, N, P]`` f32."""
    e = torch.exp(cum).transpose(2, 3)[..., None]           # [B,nc,Q,H,1]
    return torch.einsum("bcin,bcihp->bchnp", _chunks(C_, Q).float(),
                        _chunks(dy, Q).float() * e)


def bwd_fold_plain(dstate: torch.Tensor, cum: torch.Tensor,
                   state_in: torch.Tensor,
                   dfinal: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward launch b, the reverse fold: ``(g, sig, dinit)``.  ``g[:,
    c]`` is the gradient of the state leaving chunk c (``dfinal``, or
    zeros, after the last), ``G[c] = D[c] + exp(cum_last[c]) G[c + 1]``;
    ``sig [B, nc, H]`` is ``exp(cum_last) <state_in, g>``, the last row's
    pull through the state's decay; ``dinit`` is ``G[0]``."""
    Bsz, nc, H, N, P = dstate.shape
    run = (dfinal.float() if dfinal is not None
           else dstate.new_zeros((Bsz, H, N, P)))
    el = torch.exp(cum[..., -1])                             # [B, nc, H]
    gs, sig = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        gs[c] = run
        sig[c] = el[:, c] * (state_in[:, c] * run).sum((-2, -1))
        run = dstate[:, c] + el[:, c, :, None, None] * run
    return torch.stack(gs, dim=1), torch.stack(sig, dim=1), run


def _bwd_square(xh, dt, dy, cum, Q):
    """The backward's Q x Q pieces over every chunk at once (what the
    kernel forms tile by tile on chip): x, dy ``[B, nc, Q, H, P]`` f32,
    dt ``[B, nc, H, Q]``, the decay exp(cum_i - cum_j) (j <= i, the
    exponent masked first) and ``dM_ij = dy_i . x_j``, ``[B, nc, H, Q,
    Q]``."""
    x, d = _chunks(xh, Q).float(), _chunks(dy, Q).float()
    dtc = _chunks(dt, Q).float().transpose(2, 3)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                                  float("-inf")))
    return x, d, dtc, decay, torch.einsum("bcihp,bcjhp->bchij", d, x)


def bwd_dx_plain(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                 dy: torch.Tensor, cb: torch.Tensor, cum: torch.Tensor,
                 g: torch.Tensor, Q: int):
    """Backward launch c, per key row j: ``(dx, r, rd, dw, u)``.  ``dx_j =
    sum_{i >= j} M_ij dy_i + w_j (B_j g)`` in xh's dtype (``M = CB o
    decay o dt_j``, ``w_j = exp(cum_last - cum_j) dt_j``, g the state's
    gradient after the chunk); with ``t = dM o CB o decay``: ``r_j =
    sum_{i > j} t_ij`` and ``rd_j = t_jj`` (dt_j's pull through the
    chunk's rows), ``dw_j = B_j . (g x_j)`` (w_j's pull), ``u_i = sum_{j <
    i} t_ij dt_j`` (cum_i's pull as the later end), each ``[B, nc, H, Q]``
    f32.  The diagonal stays out of r and u: its pull on cum cancels
    exactly (the decay there is exp(0)), and summed in, it would leave a
    rounding of its size where a steep decay leaves it alone.  The kernel
    writes u as one partial a key tile."""
    Bsz, S, H, P = xh.shape
    x, d, dtc, decay, dm = _bwd_square(xh, dt, dy, cum, Q)
    cl = cb[:, :, None] * decay
    t = dm * cl
    rd = torch.diagonal(t, dim1=-2, dim2=-1)
    off = t - torch.diag_embed(rd)
    bg = torch.einsum("bcjn,bchnp->bcjhp", _chunks(B_, Q).float(), g)
    w = torch.exp(cum[..., -1:] - cum) * dtc
    dx = torch.einsum("bchij,bcihp->bcjhp", cl * dtc[..., None, :], d) \
        + bg * w.transpose(2, 3)[..., None]
    return (dx.to(xh.dtype).reshape(Bsz, S, H, P).contiguous(),
            off.sum(-2), rd, (bg * x).sum(-1).transpose(2, 3),
            (off * dtc[..., None, :]).sum(-1))


def bwd_dbc_plain(xh: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                  C_: torch.Tensor, dy: torch.Tensor, cum: torch.Tensor,
                  state_in: torch.Tensor, g: torch.Tensor, Q: int):
    """Backward launch d, summed over the heads (B and C have no head
    axis): ``(dB, dC, v)``.  ``dC_i = sum_{j <= i} dCB_ij B_j + sum_h
    exp(cum_i) state_in dy_i`` and ``dB_j = sum_{i >= j} dCB_ij C_i +
    sum_h w_j g x_j`` in B_'s dtype, with ``dCB = sum_h dM o decay o
    dt_j``; ``v_i = exp(cum_i) dy_i . (C_i state_in)`` (cum_i's pull
    through the carried state), ``[B, nc, H, Q]`` f32."""
    Bsz, S, N = B_.shape
    x, d, dtc, decay, dm = _bwd_square(xh, dt, dy, cum, Q)
    b, c = _chunks(B_, Q).float(), _chunks(C_, Q).float()
    dcb = (dm * decay * dtc[..., None, :]).sum(2)            # [B,nc,Q,Q]
    e = torch.exp(cum)                                       # [B,nc,H,Q]
    w = torch.exp(cum[..., -1:] - cum) * dtc
    ds = torch.einsum("bcihp,bchnp->bchin", d, state_in)     # dy s^T
    dC = torch.einsum("bcij,bcjn->bcin", dcb, b) \
        + torch.einsum("bchin,bchi->bcin", ds, e)
    dB = torch.einsum("bcij,bcin->bcjn", dcb, c) \
        + torch.einsum("bcjhp,bchnp,bchj->bcjn", x, g, w)
    v = e * torch.einsum("bchin,bcin->bchi", ds, c)
    return (dB.to(B_.dtype).reshape(Bsz, S, N), dC.to(C_.dtype).reshape(
        Bsz, S, N), v)


def bwd_dt_plain(dt: torch.Tensor, A: torch.Tensor, cum: torch.Tensor,
                 r: torch.Tensor, rd: torch.Tensor, dw: torch.Tensor,
                 u: torch.Tensor, v: torch.Tensor, sig: torch.Tensor, Q: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward launch e: ``(ddt [B, S, H], dA [H])`` f32.  cum's gradient
    ``dcum_i = u_i - dt_i r_i + v_i - dw_i w_i``, plus on the chunk's
    last row ``sig + sum_j dw_j w_j``; its reverse cumsum is ``dt A``'s,
    so ``ddt = r + rd + dw exp(cum_last - cum) + A dcum_rev`` and ``dA =
    sum dt dcum_rev``."""
    Bsz, S, H = dt.shape
    dtc = _chunks(dt, Q).float().transpose(2, 3)             # [B,nc,H,Q]
    sdecay = torch.exp(cum[..., -1:] - cum)
    dww = dw * sdecay * dtc
    dcum = u - dtc * r + v - dww
    dcum[..., -1] += sig + dww.sum(-1)
    rev = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = r + rd + dw * sdecay + A.float()[None, None, :, None] * rev
    return (ddt.transpose(2, 3).reshape(Bsz, S, H).contiguous(),
            (dtc * rev).sum((0, 1, 3)))


def ssd_scan_bwd_staged(xh, dt, A, B_, C_, init_state, dy, dfinal, *,
                        chunk: int = 256):
    """The kernel's backward as its plain launches in order, over the
    forward's plain stages (what the CUDA forward leaves in its scratch):
    ``(dxh, ddt, dA, dB, dC, dinit)``, dinit None without init_state."""
    Q = _chunk_len(xh.shape[1], chunk)
    cum = chunk_cum_plain(dt, A, Q)
    state_in, _ = fold_plain(chunk_state_plain(xh, dt, B_, cum, Q), cum,
                             init_state)
    g, sig, dinit = bwd_fold_plain(bwd_dstate_plain(dy, C_, cum, Q), cum,
                                   state_in, dfinal)
    dx, r, rd, dw, u = bwd_dx_plain(xh, dt, B_, dy,
                                    chunk_cb_plain(B_, C_, Q), cum, g, Q)
    dB, dC, v = bwd_dbc_plain(xh, dt, B_, C_, dy, cum, state_in, g, Q)
    ddt, dA = bwd_dt_plain(dt, A, cum, r, rd, dw, u, v, sig, Q)
    return (dx, ddt, dA, dB, dC,
            dinit if init_state is not None else None)


def _parts(shapes):
    """``(starts, shapes, total)``: the f32 parts of ``shapes`` cut from
    one allocation, each part starting 16-byte aligned."""
    starts, at = [], 0
    for shape in shapes:
        starts.append(at)
        at += -(-math.prod(shape) // 4) * 4
    return starts, shapes, at


def _layout(Bsz: int, S: int, H: int, P: int, N: int, Q: int):
    """The scratch's parts, cb ``[B, nc, Qp, Qp]``, cum ``[B, nc, H, Q]``
    and the chunk states ``[B, nc, H, N, P]`` (``Qp``: Q rounded up to
    64), as ``(starts, shapes, total)`` in f32 elements, each part
    starting 16-byte aligned."""
    nc, Qp = S // Q, -(-Q // 64) * 64
    return _parts(((Bsz, nc, Qp, Qp), (Bsz, nc, H, Q), (Bsz, nc, H, N, P)))


def _bwd_layout(Bsz: int, S: int, H: int, P: int, N: int, Q: int):
    """The backward's scratch parts (f32, as ``_layout``): the state
    gradient ``[B, nc, H, N, P]``, the fold's partials of exp(cum_last)
    <s, g> ``[B, nc, H, ceil(N P / 1024)]``, u's partials by key tile
    ``[B, nc, H, nt, Qp]``, and r, rd, dw, v ``[B, nc, H, Q]`` each."""
    nc, nt = S // Q, -(-Q // 64)
    row = (Bsz, nc, H, Q)
    return _parts(((Bsz, nc, H, N, P), (Bsz, nc, H, -(-N * P // 1024)),
                   (Bsz, nc, H, nt, nt * 64), row, row, row, row))


def _views(buf: torch.Tensor, layout) -> Tuple[torch.Tensor, ...]:
    starts, shapes, _ = layout
    return tuple(buf[a:a + math.prod(shape)].view(shape)
                 for a, shape in zip(starts, shapes))


def scratch(xh: torch.Tensor, N: int, Q: int) -> Tuple[torch.Tensor, ...]:
    """The kernel's scratch as views ``(cb, cum, states)`` of ONE f32
    allocation on xh's device (``_layout``)."""
    layout = _layout(*xh.shape, N, Q)
    return _views(torch.empty(layout[2], dtype=torch.float32,
                              device=xh.device), layout)


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
         init_state: Optional[torch.Tensor] = None, want_state: bool = True,
         keep_scratch: bool = False):
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


def _check_cuda(name: str, ins, N: int, P: int, Q: int) -> None:
    """The kernels' limits on CUDA inputs ``[xh, dt, A, B_, C_, *f32]``:
    xh, B_, C_ all f32 or all bf16, the rest f32, contiguous, N <= 128,
    P <= 64, Q <= 1024."""
    xh, B_, C_ = ins[0], ins[3], ins[4]
    if xh.dtype not in _KERNELS or B_.dtype != xh.dtype \
            or C_.dtype != xh.dtype:
        raise ValueError(f"{name} takes xh, B_, C_ all float32 or all "
                         f"bfloat16, not {xh.dtype}, {B_.dtype}, "
                         f"{C_.dtype}")
    if any(t.dtype != torch.float32 for t in ins[1:3] + ins[5:]):
        raise ValueError(f"{name} takes dt, A and the states in float32")
    if N > MAX_STATE or P > MAX_HEAD_DIM or Q > MAX_CHUNK:
        raise ValueError(f"{name} takes N <= {MAX_STATE}, P <= "
                         f"{MAX_HEAD_DIM}, chunk <= {MAX_CHUNK}; got N={N}, "
                         f"P={P}, Q={Q}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name} takes contiguous tensors")


@_lib.counted("ssd_scan", work)
def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None,
             want_state: bool = True, keep_scratch: bool = False):
    """The chunked scan: ``(y, final_state)``, the state None unless
    ``want_state``; with ``keep_scratch``, ``(y, final_state, scratch)``,
    the kernel's scratch ``(cb, cum, states)`` (what ``ssd_scan_bwd``
    reads; None off the card).

    A CUDA tensor launches the kernel (xh, B_, C_ all f32 or all bf16;
    dt, A and init_state f32; contiguous; N <= 128, P <= 64, Q <= 1024;
    anything else raises); a CPU tensor takes the plain version; a fake
    CUDA tensor (the dry run's) gets the kernel's outputs made and
    nothing computed.

    The forward kernel carries no graph: on the card, an input that
    requires grad while grad mode is on raises (the gradient is
    ``models.mamba.SSDScanFn``'s, which runs this under its forward and
    ``ssd_scan_bwd`` backward)."""
    _check(xh, dt, A, B_, C_, init_state)
    Bsz, S, H, P = xh.shape
    N = B_.shape[-1]
    Q = _chunk_len(S, chunk)
    kind = _lib.device_kind(xh)
    kept = ()
    if kind == "cpu":
        y, state = ssd_scan_plain(xh, dt, A, B_, C_, chunk=chunk,
                                  init_state=init_state)
        return (y, state if want_state else None) \
            + ((None,) if keep_scratch else ())
    ins = [xh, dt, A, B_, C_] + ([init_state] if init_state is not None
                                 else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError(
            "ssd_scan: an input requires grad and the CUDA forward kernel "
            "records no graph (SSDScanFn carries the gradient)")
    _check_cuda("ssd_scan", ins, N, P, Q)
    y = torch.empty_like(xh)
    state = (torch.empty((Bsz, H, N, P), dtype=torch.float32,
                         device=xh.device) if want_state else None)
    if kind == "fake" or y.numel() == 0:   # B, H or P 0: no state either
        return (y, state) + ((None,) if keep_scratch else ())
    layout = _layout(Bsz, S, H, P, N, Q)
    # held until the launches are enqueued: a block freed earlier could be
    # handed to another thread's work first
    buf = torch.empty(layout[2], dtype=torch.float32, device=xh.device)
    _launch(ALL_STAGES, xh, dt, A, B_, C_, init_state, y, state,
            [buf.data_ptr() + 4 * a for a in layout[0]], Q)
    if keep_scratch:
        kept = (_views(buf, layout),)
    return (y, state) + kept


# ---------------------------------------------------------------------------
# the backward (csrc/ssd_scan_bwd.cu)
# ---------------------------------------------------------------------------

def ssd_scan_bwd_plain(xh, dt, A, B_, C_, init_state, dy, dfinal, *,
                       chunk: int = 256, needs=(True,) * 6):
    """The gradient as autograd gives it: the plain scan recomputed on
    detached inputs under grad mode and differentiated.  ``(dxh, ddt, dA,
    dB, dC, dinit)``, None where ``needs`` is false; dy and dfinal are
    the gradients of y and of the final state (None: not used)."""
    ts = (xh, dt, A, B_, C_, init_state)
    needs = tuple(bool(n) and t is not None for t, n in zip(ts, needs))
    ins = [None if t is None else t.detach().requires_grad_(n)
           for t, n in zip(ts, needs)]
    with torch.enable_grad():
        outs = ssd_scan_plain(*ins[:5], chunk=chunk, init_state=ins[5])
    pairs = [(o, g) for o, g in zip(outs, (dy, dfinal)) if g is not None]
    wrt = [t for t, n in zip(ins, needs) if n]
    grads = iter(torch.autograd.grad(
        [o for o, _ in pairs], wrt, [g for _, g in pairs],
        allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)


def bwd_scratch(xh: torch.Tensor, N: int, Q: int) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's scratch as views ``(g, sig, u, r, rd, dw, v)`` of
    ONE f32 allocation on xh's device (``_bwd_layout``)."""
    layout = _bwd_layout(*xh.shape, N, Q)
    return _views(torch.empty(layout[2], dtype=torch.float32,
                              device=xh.device), layout)


def launch_bwd(xh, dt, A, B_, C_, dy, dfinal, saved: Tuple, outs: Tuple,
               parts: Tuple, Q: int) -> None:
    """ONE C call of the backward's five launches on checked CUDA
    tensors: ``saved`` the forward's scratch ``(cb, cum, states)``,
    ``outs`` the six gradients (dinit may be None), ``parts`` the
    backward's scratch (``bwd_scratch``), where each launch's results
    stay to be held against its plain stage."""
    Bsz, S, H, P = xh.shape
    _lib.launch("ssd_scan_bwd_bf16", xh.device, xh.data_ptr(),
                dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                dy.data_ptr(),
                dfinal.data_ptr() if dfinal is not None else None,
                *(t.data_ptr() for t in saved),
                *(None if t is None else t.data_ptr() for t in outs),
                *(t.data_ptr() for t in parts),
                Bsz, S, H, P, B_.shape[-1], Q)
    bwd_launches.add()


def bwd_work(xh, dt, A, B_, C_, init_state, dy, dfinal, *, chunk: int = 256,
             needs=(True,) * 6, saved=None):
    """``(flops, bytes)`` of one backward call (``_lib.counted``): the
    flops ``FlopCounterMode`` counts over the plain backward when every
    input requires grad (the four chunk products recomputed, and two
    gradient products of each: three times ``work``'s), and the bytes of
    the kernel's bound: x, dy and dx, B, C, dB and dC, dt and ddt, A and
    dA, cum and the state entering each chunk read, dfinal read and dinit
    written when given."""
    Bsz, S, H, P = xh.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    flops, _ = work(xh, dt, A, B_, C_, chunk=chunk)
    states = Bsz * H * N * P
    nbytes = (3 * xh.numel() * xh.element_size()
              + 4 * B_.numel() * B_.element_size()
              + 4 * (3 * dt.numel() + 2 * A.numel() + S // Q * states)
              + 4 * states * ((dfinal is not None)
                              + (init_state is not None)))
    return 3 * flops, nbytes


@_lib.counted("ssd_scan_bwd", bwd_work)
def ssd_scan_bwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B_: torch.Tensor, C_: torch.Tensor,
                 init_state: Optional[torch.Tensor], dy: torch.Tensor,
                 dfinal: Optional[torch.Tensor], *, chunk: int = 256,
                 needs=(True,) * 6, saved: Optional[Tuple] = None):
    """The chunked scan's gradient: ``(dxh, ddt, dA, dB, dC, dinit)``,
    each in its input's dtype and shape, None where ``needs`` (a flag an
    input) is false; dy is y's gradient, dfinal the final state's (None:
    zeros).

    A CUDA tensor launches the backward kernel (``csrc/ssd_scan_bwd.cu``:
    bf16 xh, B_, C_ and dy; dt, A, init_state and dfinal f32;
    contiguous; the forward's limits) over ``saved``, the forward's
    scratch (``ssd_scan(..., keep_scratch=True)``).  f32 inputs on the
    card take the plain version on this explicit branch, counted by
    ``bwd_f32_plain`` (the kernel has no f32 instantiation); anything
    else raises.  A CPU tensor
    takes the plain version (``ssd_scan_bwd_plain``); a fake CUDA tensor
    gets the outputs made and nothing computed."""
    _check(xh, dt, A, B_, C_, init_state)
    Bsz, S, H, P = xh.shape
    N = B_.shape[-1]
    Q = _chunk_len(S, chunk)
    for name, t, shape in (("dy", dy, (Bsz, S, H, P)),
                           ("dfinal", dfinal, (Bsz, H, N, P))):
        if t is not None and (tuple(t.shape) != shape
                              or t.device != xh.device):
            raise ValueError(f"ssd_scan_bwd: {name} has shape "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{shape} on {xh.device}")
    kind = _lib.device_kind(xh)
    if kind == "cpu":
        return ssd_scan_bwd_plain(xh, dt, A, B_, C_, init_state, dy, dfinal,
                                  chunk=chunk, needs=needs)
    ins = [xh, dt, A, B_, C_] + [t for t in (init_state, dfinal)
                                 if t is not None]
    _check_cuda("ssd_scan_bwd", ins, N, P, Q)
    if dy.dtype != xh.dtype or not dy.is_contiguous():
        raise ValueError(f"ssd_scan_bwd takes a contiguous dy in xh's "
                         f"dtype {xh.dtype}, not {dy.dtype}")
    make = torch.zeros_like if xh.numel() == 0 else torch.empty_like
    outs = tuple(None if t is None else make(t)
                 for t in (xh, dt, A, B_, C_, init_state))
    if kind == "fake" or xh.numel() == 0:
        return tuple(o if n else None for o, n in zip(outs, needs))
    if xh.dtype == torch.float32:
        bwd_f32_plain.add()
        return ssd_scan_bwd_plain(xh, dt, A, B_, C_, init_state, dy, dfinal,
                                  chunk=chunk, needs=needs)
    if saved is None:
        raise ValueError("ssd_scan_bwd on the card reads the forward's "
                         "scratch: pass saved (ssd_scan(..., "
                         "keep_scratch=True))")
    launch_bwd(xh, dt, A, B_, C_, dy, dfinal, saved, outs,
               bwd_scratch(xh, N, Q), Q)
    return tuple(o if n else None for o, n in zip(outs, needs))


__all__ = ["ALL_STAGES", "MAX_CHUNK", "MAX_HEAD_DIM", "MAX_STATE",
           "STAGE_CB", "STAGE_FOLD", "STAGE_OUT", "STAGE_STATE",
           "bwd_dbc_plain", "bwd_dstate_plain", "bwd_dt_plain",
           "bwd_dx_plain", "bwd_f32_plain", "bwd_fold_plain",
           "bwd_launches", "bwd_scratch", "bwd_work", "chunk_cb_plain",
           "chunk_cum_plain", "chunk_state_plain", "fold_plain",
           "launch_bwd", "launch_stages", "launches",
           "output_plain", "scratch", "ssd_scan", "ssd_scan_bwd",
           "ssd_scan_bwd_plain", "ssd_scan_bwd_staged", "ssd_scan_plain",
           "work"]
