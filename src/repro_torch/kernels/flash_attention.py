"""Flash attention forward: the prefill attention of every model layer.

Replaces ``repro/kernels/flash_attention.py::flash_attention_nhd`` (the
Pallas TPU kernel behind ``ops.flash_attention``).  Takes q
``[B, Sq, H, D]`` and k, v ``[B, Sk, KV, D]`` with H a multiple of KV
(grouped-query heads: query head h reads kv head ``h // (H // KV)``) and
returns ``[B, Sq, H, D]`` in q's dtype.  The arithmetic is the TPU
kernel's: ``q . k`` in f32 times ``D ** -0.5``; causal masking
``row >= col`` with -1e30; an online softmax with f32 ``m``, ``l`` and
accumulator; ``p`` cast to v's dtype before ``p . v``; the output
``acc / max(l, 1e-30)``.

On the card it is ``csrc/flash_attention.cu``: one CTA per (batch,
head, query tile) walks the kv tiles in order with the running
statistics in registers (the TPU kernel carried them in VMEM across its
innermost grid axis), reads the kv head of a query head in place instead
of repeating K and V, and masks ragged tiles itself.  bf16 (serving and
training) runs FlashAttention-2's shape on the tensor cores: both
products as ``mma.sync`` m16n8k16 (bf16 operands, f32 sums), Q/K/V bf16
in swizzled shared memory, K and V through a two-stage ``cp.async``
ring, the softmax on the accumulator fragments and P fed back from
registers as bf16; the head dim is padded to 64, 128 or 256.  f32 (the
model checks) keeps FMA tiles.  What bounds it on the card: at
qwen2.5-3b's prefill the bytes and the tensor-core operations are about
equal (~1.4 us at S=512); the operations from S=2048 (``PERF.md``).

``flash_attention_plain`` is the plain PyTorch version the wrapper takes
for CPU tensors: the same online softmax over 64-row kv blocks, all
query rows at once, its output contiguous as the kernel's.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("flash_attention")

NEG_INF = -1e30
BLOCK_K = 64          # the CUDA kernel's kv tile
MAX_HEAD_DIM = 256    # the largest head dim the CUDA kernel takes
_KERNELS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q [B, Sq, H, D] and k, v "
                         f"[B, Sk, KV, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1 \
            or k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (H must be a multiple of KV)")
    if not (q.device == k.device == v.device) or not \
            (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention takes q, k, v of one device and "
                         "one dtype")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: the online softmax over the kernel's
    ``BLOCK_K``-row kv blocks.  A kv block that lies wholly above the causal diagonal of a
    query row leaves that row unchanged (``p`` underflows to 0, ``corr``
    is 1), so processing every row against every reachable block equals
    the TPU kernel's per-tile skipping."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().reshape(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]       # [B, KV, 1, Sk, D]
    vt = v.permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    rows = torch.arange(Sq, device=q.device)[:, None]
    for k0 in range(0, Sk, BLOCK_K):
        if causal and k0 > Sq - 1:
            break                        # above the diagonal of every row
        k1 = min(k0 + BLOCK_K, Sk)
        s = torch.matmul(qf, kf[..., k0:k1, :].transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            s = torch.where(rows >= cols, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).float(), vt[..., k0:k1, :].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # contiguous, as the kernel's output: a caller's later reshape is then
    # a view on both routes
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(
        q.dtype).contiguous()


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, scale: Optional[float] = None):
    """``(flops, bytes)`` of one call (``_lib.counted``): the flops
    ``FlopCounterMode`` counts over the plain version, both products
    over every ``BLOCK_K`` block it visits (a causal call visits every
    block that starts at or below its last query row: the whole square,
    not half), and the bytes of the kernel's bound, q, k and v read and
    the output written once."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    cols = min(Sk, -(-Sq // BLOCK_K) * BLOCK_K) if causal else Sk
    return (4 * B * H * Sq * D * cols,
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size())


@_lib.counted("flash_attention", work)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Attention of q ``[B, Sq, H, D]`` over k, v ``[B, Sk, KV, D]``.

    A CUDA tensor launches the kernel (f32 or bf16, D <= 256, unit-stride
    head dim; anything else raises); a CPU tensor takes the plain
    version; a fake CUDA tensor (the dry run's) gets the kernel's output
    made and nothing computed.  Nothing is read back to the host.

    The kernel has no backward: on the card, an input that requires grad
    while grad mode is on raises (the kernel's output would carry no
    graph); ``models.attention.FlashAttentionFn`` is the differentiable
    route."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[3] ** -0.5
    kind = _lib.device_kind(q)
    if kind == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: an input requires grad and the CUDA kernel "
            "has no backward; go through models.attention.FlashAttentionFn")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q.dtype not in _KERNELS:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes D <= {MAX_HEAD_DIM}, not "
                         f"{D}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention takes a unit-stride head dim")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if kind == "fake" or o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    _lib.launch(_KERNELS[q.dtype], q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), B, H, KV, Sq, Sk, D,
                ctypes.addressof(strides), float(scale), int(bool(causal)))
    launches.add()
    return o


__all__ = ["BLOCK_K", "MAX_HEAD_DIM", "NEG_INF", "flash_attention",
           "flash_attention_plain", "launches", "work"]
