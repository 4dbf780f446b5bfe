"""AdamW (Loshchilov and Hutter) with clipping by the global gradient norm
and a linear warm-up into a cosine decay to a tenth of the peak rate;
moments in float32, each parameter stored back in its own dtype after
the update.  Weight decay applies to matrices (two or more dims) only."""
from __future__ import annotations

import math

import torch


def lr_at(count: int, o: dict) -> float:
    warm = min(count / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((count - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    return o["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """``step(params, grads)`` updates a dict of leaves in place."""

    def __init__(self, params: dict, o: dict):
        self.o = o
        self.count = 0
        self.m = {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in params.items()}
        self.v = {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        o = self.o
        self.count += 1
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                              for g in grads.values()))
        scale = min(o["clip_norm"] / max(gnorm, 1e-9), 1.0)
        lr = lr_at(self.count, o)
        b1c = 1 - o["b1"] ** self.count
        b2c = 1 - o["b2"] ** self.count
        for k, p in params.items():
            g = grads[k].float() * scale
            m, v = self.m[k], self.v[k]
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"])
            decay = o["weight_decay"] if p.dim() >= 2 else 0.0
            p32 = p.float()
            p.copy_((p32 - lr * (upd + decay * p32)).to(p.dtype))
