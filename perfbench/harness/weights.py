"""Weights made from the seed, on the device, in the dtype they are served
in: one normal draw per leaf (in slices of at most 2**28 elements), scaled
by the benchmark's rule, and each leaf's layout (path, shape, dtype and
kind) from the program's parameter table.

Rule: a leaf of kind ``ones`` or ``zeros`` is constant; ``embed`` is
N(0, embed_std^2); any other is N(0, (scale / sqrt(fan_in))^2), fan_in the
second-last dim (the last for a vector).  The same seed gives the same
weights on the same device, so the reference gets them by calling this
again after the program's state is freed."""
from __future__ import annotations

import re
from typing import Iterable, NamedTuple, Tuple

import torch

SLICE = 1 << 28


class Leaf(NamedTuple):
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: str
    kind: str
    scale: float


def parse_path(keystr: str) -> Tuple[str, ...]:
    """``"['layers']['sub0']['w_q']"`` -> ``("layers", "sub0", "w_q")``."""
    return tuple(re.findall(r"\['([^']*)'\]", keystr))


def make(leaves: Iterable[Leaf], seed: int, device, embed_std: float
         ) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: dict = {}
    for leaf in leaves:
        dt = getattr(torch, leaf.dtype)
        if leaf.kind == "ones":
            t = torch.ones(leaf.shape, dtype=dt, device=device)
        elif leaf.kind == "zeros":
            t = torch.zeros(leaf.shape, dtype=dt, device=device)
        else:
            if leaf.kind == "embed":
                std = embed_std
            else:
                fan = leaf.shape[-2] if len(leaf.shape) >= 2 \
                    else leaf.shape[-1]
                std = leaf.scale / max(fan, 1) ** 0.5
            t = torch.empty(leaf.shape, dtype=dt, device=device)
            flat = t.view(-1)
            for lo in range(0, flat.numel(), SLICE):
                n = min(SLICE, flat.numel() - lo)
                flat[lo:lo + n] = torch.randn(
                    n, generator=gen, dtype=torch.float32,
                    device=device).mul_(std)
        node = out
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = t
    return out
