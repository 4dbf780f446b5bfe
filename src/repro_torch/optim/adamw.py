"""AdamW with global-norm clipping and a linear-warmup cosine schedule.

Port of the JAX package's ``optim/adamw.py``, plain torch as the
reference is plain jnp.  Parameter, gradient and moment trees are nested
dicts of tensors of one structure; ``count`` is a 0-d int32 tensor on
the parameters' device, so a step computes its learning rate and bias
corrections there and never waits for the host.  Everything scalar is
taken in float32 as the reference takes it: ``count`` is cast to f32
before ``b1 ** count``, and the cosine is an f32 cosine.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.launch.sharding import torch_dtype, tree_leaves, tree_map
from repro_torch.models.model_zoo import params_from_numpy

#: elements squared at a time by ``global_norm`` (a 256 MB f32 temporary;
#: one f32 copy of qwen2.5-3b's FFN gradient would be 3.2 GB)
NORM_CHUNK = 1 << 26


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"


def init(params, cfg: AdamWConfig) -> AdamWState:
    dt = torch_dtype(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=tree_leaves(params)[0].device))


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Learning rate at ``step`` (a float32 tensor)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """sum(x²) in f32, squared ``NORM_CHUNK`` elements at a time."""
    parts = [torch.sum(torch.square(c.float()))
             for c in x.reshape(-1).split(NORM_CHUNK)]
    if not parts:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return parts[0] if len(parts) == 1 else torch.stack(parts).sum()


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_sum_sq(x) for x in tree_leaves(tree)))


def step_scalars(grads, count: torch.Tensor, cfg: AdamWConfig):
    """``(lr, scale, b1c, b2c)`` of the step that takes ``count`` (the
    incremented counter) to the gradients ``grads``: 0-d f32 tensors on
    the gradients' device."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    cnt = count.float()
    lr = schedule(cnt, cfg)
    b1c = 1 - cfg.b1 ** cnt
    b2c = 1 - cfg.b2 ** cnt
    return lr, scale, b1c, b2c


def apply(grads, state: AdamWState, params, cfg: AdamWConfig):
    """Returns ``(new_params, new_state)``; functional, like the
    reference (every output is a new tensor)."""
    count = state.count + 1
    lr, scale, b1c, b2c = step_scalars(grads, count, cfg)

    def upd(g, m, v, p):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0
        p32 = p.float()
        newp = p32 - lr * (step + decay * p32)
        return newp.to(p.dtype), m, v

    outs = tree_map(upd, grads, state.mu, state.nu, params)
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], outs)
                           for i in range(3))
    return new_p, AdamWState(new_m, new_v, count)


def state_from_numpy(opt_tree, device=None) -> AdamWState:
    """The JAX package's ``AdamWState`` (any object with ``mu``, ``nu``
    and ``count``, its leaves numpy arrays, e.g. through ``np.asarray``
    per leaf) as this package's, on ``device`` (the CPU by default)."""
    count = torch.tensor(int(np.asarray(opt_tree.count)), dtype=torch.int32)
    return AdamWState(mu=params_from_numpy(opt_tree.mu, device),
                      nu=params_from_numpy(opt_tree.nu, device),
                      count=count if device is None else count.to(device))
