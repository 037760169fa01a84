"""AdamW with a cosine schedule and global-norm clipping — port of
``repro/optim/adamw.py`` (without the ZeRO sharding hooks).

The same math as the reference: f32 moments, bias correction, decoupled
weight decay on every leaf of two or more dimensions (none on vectors,
``adamw.py:60``; a stacked norm scale [n_layers, D] has two and is decayed,
as there), and clipping by the global norm of all gradients.  ``update`` is
functional like the reference's: it returns new parameter and moment trees.
The step count and the learning rate stay tensors on the parameters'
device, so a training step does not wait on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: dict
    v: dict


def init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                      v=tree_map(torch.clone, zeros))


def cosine_lr(step, *, peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak``, then a cosine down to ``floor * peak``;
    ``step`` is an int tensor (or an int), the result an f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * (step + 1) / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, peak * cos)


def clip_by_global_norm(grads, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr, b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """One AdamW step -> (new params, new state, global grad norm)."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        decay = weight_decay if p.ndim >= 2 else 0.0  # no decay on vectors
        new_p = p.to(torch.float32) - lr * (u + decay * p.to(torch.float32))
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2)), gnorm
