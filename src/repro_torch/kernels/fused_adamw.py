"""Fused AdamW step with the versioned ring write: the trainer's commit.

Replaces ``repro/kernels/fused_adamw.py::fused_adamw_flat`` (the Pallas
TPU kernel behind ``ops.fused_adamw``), which the JAX package's
``launch/steps._fused_commit`` launches for every parameter leaf of a
Mode-U fused step.  For one leaf it takes the parameters ``p``, the
gradient ``g``, the f32 moments ``m`` and ``v``, the leaf's version ring
``[R, *p.shape]`` (or None), the ring ``slot`` to write and the f32
``scalars = (lr, scale, b1c, b2c)``, and computes, in the TPU kernel's
order:

    g  = g * scale
    m' = b1 * m + (1 - b1) * g
    v' = b2 * v + (1 - b2) * g * g
    step = (m' / b1c) / (sqrt(v' / b2c) + eps) + wd * p
    p' = p - lr * step        (cast to p's dtype)

Where the state goes (the port has no buffer donation, ``core/mvstore``):
``p'`` is a NEW tensor, so a reader still holding the old live block keeps
it whole; ``m'`` and ``v'`` overwrite ``m`` and ``v`` in place (nothing
else reads them); ``p'`` is written into ``ring[slot]`` in place, as the
reference aliases the ring in to out.

On the card it is ``csrc/fused_adamw.cu``: one grid-stride pass with
64-bit offsets and a masked tail (no tile that must divide n, no
padding), ``slot`` and the four scalars read from device memory, every
operation rounded on its own, so that it equals the plain version bit
for bit.  What bounds it on the card: bytes, 24 per bf16 parameter
(read p, g, m, v; write p', m', v' and the ring row).  ``g`` may be bf16:
the kernel widens it in registers, so no f32 copy of the gradients is
made.  ``fused_adamw_plain`` is the plain PyTorch version the wrapper
takes for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _lib

launches = _lib.LaunchCounter("fused_adamw")

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(p, g, m, v, ring, slot, scalars) -> None:
    if p.dtype not in _NAMES or g.dtype not in _NAMES:
        raise ValueError(f"fused_adamw takes float32 or bfloat16 p and g, "
                         f"not {p.dtype} and {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError("fused_adamw takes float32 moments")
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"fused_adamw: shapes differ: p {tuple(p.shape)}, "
                         f"g {tuple(g.shape)}, m {tuple(m.shape)}, "
                         f"v {tuple(v.shape)}")
    if scalars.dtype != torch.float32 or scalars.shape != (4,):
        raise ValueError("fused_adamw takes scalars float32 [4] = "
                         "(lr, scale, b1c, b2c)")
    tensors = [p, g, m, v, scalars]
    if ring is not None:
        if ring.dtype != p.dtype or tuple(ring.shape[1:]) != tuple(p.shape) \
                or ring.dim() != p.dim() + 1:
            raise ValueError(f"fused_adamw: ring {tuple(ring.shape)} "
                             f"{ring.dtype} is not [R, *{tuple(p.shape)}] "
                             f"{p.dtype}")
        if not 0 <= int(slot) < ring.shape[0]:
            raise IndexError(f"ring slot {slot} outside [0, "
                             f"{ring.shape[0]})")
        tensors.append(ring)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fused_adamw takes tensors of one device")


def fused_adamw_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, ring: Optional[torch.Tensor],
                      slot: int, scalars: torch.Tensor, *, b1: float,
                      b2: float, eps: float, wd: float) -> torch.Tensor:
    """Plain PyTorch version: the same operations in the same order.
    Returns ``p'``; ``m``, ``v`` and ``ring[slot]`` are updated in
    place."""
    lr, scale, b1c, b2c = scalars[0], scalars[1], scalars[2], scalars[3]
    g = g.float() * scale
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * g * g
    p32 = p.float()
    step = m2 / b1c / (torch.sqrt(v2 / b2c) + eps) + wd * p32
    p2 = (p32 - lr * step).to(p.dtype)
    m.copy_(m2)
    v.copy_(v2)
    if ring is not None:
        ring[int(slot)].copy_(p2)
    return p2


def work(p: torch.Tensor, g: torch.Tensor, m, v, ring, slot, scalars,
         **_):
    """``(flops, bytes)`` of one call (``_lib.counted``): no products
    (``FlopCounterMode`` counts none in the plain version) and the bytes
    of the kernel's bound: p, g, m and v read, p', m', v' and the ring
    row written (24 per bf16 parameter with a ring)."""
    per = 2 * p.element_size() + g.element_size() + 16
    if ring is not None:
        per += p.element_size()
    return 0, p.numel() * per


@_lib.counted("fused_adamw", work)
def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, ring: Optional[torch.Tensor], slot: int,
                scalars: torch.Tensor, *, b1: float, b2: float, eps: float,
                wd: float) -> torch.Tensor:
    """One AdamW step on one leaf (module docstring).  ``slot`` is a host
    int (checked against the ring's depth; out of range raises
    ``IndexError``), ``scalars`` a float32 [4] tensor on the leaf's
    device.  A CUDA leaf launches the kernel (contiguous tensors only;
    anything else raises); a CPU leaf takes the plain version.  Nothing
    is read back to the host."""
    _check(p, g, m, v, ring, slot, scalars)
    if _lib.device_kind(p) == "cpu":
        return fused_adamw_plain(p, g, m, v, ring, slot, scalars, b1=b1,
                                 b2=b2, eps=eps, wd=wd)
    tensors = (p, g, m, v, scalars) + ((ring,) if ring is not None else ())
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_adamw takes contiguous tensors on the card")
    p2 = torch.empty_like(p)
    n = p.numel()
    if n == 0:
        return p2
    slot_t = None
    if ring is not None:
        slot_t = _lib.to_device(np.array([int(slot)], np.int64), p.device)
    name = f"fused_adamw_{_NAMES[p.dtype]}_{_NAMES[g.dtype]}"
    _lib.launch(name, p.device, p.data_ptr(), g.data_ptr(), m.data_ptr(),
                v.data_ptr(), p2.data_ptr(),
                None if ring is None else ring.data_ptr(),
                None if slot_t is None else slot_t.data_ptr(),
                scalars.data_ptr(), n, float(b1), float(b2), float(eps),
                float(wd))
    launches.add()
    return p2


__all__ = ["fused_adamw", "fused_adamw_plain", "launches", "work"]
